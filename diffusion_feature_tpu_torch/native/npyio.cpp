// Native async .npy batch reader.
//
// The scarce-pixel task consumes pre-dumped aggregated feature files that
// run to hundreds of MB per image set (reference scarce_segmentation/
// task-pixel.py:32-71 loads them serially with np.load, stalling between
// files).  This pool reads and header-parses .npy files on worker threads
// so disk IO overlaps with the JAX compute that consumes the previous
// file.  Results are handed back as raw payload buffers + parsed metadata;
// Python copies each payload once into a writable np array on get().
//
// C API (ctypes-friendly):
//   nr_create(n_threads)                          -> opaque pool*
//   nr_submit(pool, path)                         -> job id >= 0 / -1
//   nr_wait(pool, id, &data, &nbytes, shape[8], &ndim, descr[16], &fortran)
//        -> 0 ok / -1 error (blocks until the job finishes; buffer stays
//           owned by the pool until nr_free)
//   nr_free(pool, id)                             -> release the buffer
//   nr_destroy(pool)
//
// Build: g++ -O3 -shared -fPIC -pthread npyio.cpp -o libnpyio.so

#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Result {
    bool done = false;
    bool ok = false;
    std::vector<char> payload;
    int64_t shape[8] = {0};
    int ndim = 0;
    char descr[16] = {0};
    int fortran = 0;
};

// parse the ASCII header dict: {'descr': '<f4', 'fortran_order': False,
// 'shape': (2, 3, 4), }
bool parse_header(const std::string& hdr, Result* r) {
    size_t d = hdr.find("'descr'");
    if (d == std::string::npos) return false;
    size_t q1 = hdr.find('\'', hdr.find(':', d));
    size_t q2 = hdr.find('\'', q1 + 1);
    if (q1 == std::string::npos || q2 == std::string::npos) return false;
    std::string descr = hdr.substr(q1 + 1, q2 - q1 - 1);
    if (descr.size() >= sizeof(r->descr)) return false;
    // Only simple scalar descrs are supported ('<f4' style).  A structured
    // dtype writes 'descr' as a list of field tuples; the first quoted token
    // would be a field name, so reject anything that doesn't look like
    // byte-order prefix + type char + digits and let Python fall back to
    // np.load (npy_reader.get() re-reads the remembered path on failure).
    if (descr.size() < 2) return false;
    char order = descr[0];
    if (order != '<' && order != '>' && order != '|' && order != '=')
        return false;
    if (!std::strchr("bifucSUV?", descr[1])) return false;
    for (size_t i = 2; i < descr.size(); ++i)
        if (descr[i] < '0' || descr[i] > '9') return false;
    std::strncpy(r->descr, descr.c_str(), sizeof(r->descr) - 1);

    size_t f = hdr.find("'fortran_order'");
    if (f == std::string::npos) return false;
    r->fortran = hdr.find("True", f) < hdr.find("False", f) ? 1 : 0;

    size_t s = hdr.find("'shape'");
    if (s == std::string::npos) return false;
    size_t p1 = hdr.find('(', s);
    size_t p2 = hdr.find(')', p1);
    if (p1 == std::string::npos || p2 == std::string::npos) return false;
    std::string tup = hdr.substr(p1 + 1, p2 - p1 - 1);
    r->ndim = 0;
    const char* c = tup.c_str();
    while (*c) {
        while (*c == ' ' || *c == ',') ++c;
        if (!*c) break;
        if (*c < '0' || *c > '9') return false;
        if (r->ndim >= 8) return false;
        r->shape[r->ndim++] = std::strtoll(c, const_cast<char**>(&c), 10);
    }
    return true;
}

bool read_one(const std::string& path, Result* r) {
    FILE* f = std::fopen(path.c_str(), "rb");
    if (!f) return false;
    unsigned char pre[10];
    if (std::fread(pre, 1, 10, f) != 10 ||
        std::memcmp(pre, "\x93NUMPY", 6) != 0) {
        std::fclose(f);
        return false;
    }
    int major = pre[6];
    uint32_t hlen;
    long payload_off;
    if (major == 1) {
        hlen = pre[8] | (pre[9] << 8);
        payload_off = 10 + hlen;
    } else {
        unsigned char ext[2];
        if (std::fread(ext, 1, 2, f) != 2) { std::fclose(f); return false; }
        hlen = pre[8] | (pre[9] << 8) | (ext[0] << 16)
             | (static_cast<uint32_t>(ext[1]) << 24);
        payload_off = 12 + hlen;
    }
    std::string hdr(hlen, '\0');
    if (std::fread(&hdr[0], 1, hlen, f) != hlen || !parse_header(hdr, r)) {
        std::fclose(f);
        return false;
    }
    if (std::fseek(f, 0, SEEK_END) != 0) { std::fclose(f); return false; }
    long end = std::ftell(f);
    if (end < payload_off || std::fseek(f, payload_off, SEEK_SET) != 0) {
        std::fclose(f);
        return false;
    }
    size_t n = static_cast<size_t>(end - payload_off);
    r->payload.resize(n);
    bool ok = n == 0 || std::fread(r->payload.data(), 1, n, f) == n;
    std::fclose(f);
    return ok;
}

struct Pool {
    std::deque<std::pair<int64_t, std::string>> queue;
    std::map<int64_t, Result> results;
    std::mutex mu;
    std::condition_variable cv;        // workers wait for work
    std::condition_variable done_cv;   // nr_wait waits for completion
    std::vector<std::thread> workers;
    int64_t next_id = 0;
    bool stop = false;

    explicit Pool(int n) {
        for (int i = 0; i < n; ++i) workers.emplace_back([this] { run(); });
    }

    ~Pool() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv.notify_all();
        for (auto& t : workers) t.join();
    }

    void run() {
        for (;;) {
            std::pair<int64_t, std::string> job;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [this] { return stop || !queue.empty(); });
                if (queue.empty()) {
                    if (stop) return;
                    continue;
                }
                job = std::move(queue.front());
                queue.pop_front();
            }
            Result r;
            r.ok = read_one(job.second, &r);
            r.done = true;
            {
                std::lock_guard<std::mutex> lk(mu);
                results[job.first] = std::move(r);
            }
            done_cv.notify_all();
        }
    }

    int64_t submit(const char* path) {
        std::lock_guard<std::mutex> lk(mu);
        int64_t id = next_id++;
        results.emplace(id, Result{});
        queue.emplace_back(id, path);
        cv.notify_one();
        return id;
    }
};

}  // namespace

extern "C" {

void* nr_create(int n_threads) {
    if (n_threads < 1) n_threads = 1;
    return new Pool(n_threads);
}

int64_t nr_submit(void* pool, const char* path) {
    if (!pool || !path) return -1;
    return static_cast<Pool*>(pool)->submit(path);
}

int nr_wait(void* pool, int64_t id, void** data, int64_t* nbytes,
            int64_t* shape, int* ndim, char* descr, int* fortran) {
    if (!pool) return -1;
    Pool* p = static_cast<Pool*>(pool);
    std::unique_lock<std::mutex> lk(p->mu);
    auto it = p->results.find(id);
    if (it == p->results.end()) return -1;
    p->done_cv.wait(lk, [&] { return it->second.done; });
    Result& r = it->second;
    if (!r.ok) return -1;
    *data = r.payload.data();
    *nbytes = static_cast<int64_t>(r.payload.size());
    for (int i = 0; i < r.ndim; ++i) shape[i] = r.shape[i];
    *ndim = r.ndim;
    std::strncpy(descr, r.descr, 16);
    *fortran = r.fortran;
    return 0;
}

void nr_free(void* pool, int64_t id) {
    if (!pool) return;
    Pool* p = static_cast<Pool*>(pool);
    std::lock_guard<std::mutex> lk(p->mu);
    p->results.erase(id);
}

void nr_destroy(void* pool) {
    delete static_cast<Pool*>(pool);
}

}  // extern "C"
