// Native async feature-dump writer.
//
// The extraction pipeline's host side (device->host copy, dtype narrow,
// .npy serialization) runs concurrently with TPU compute; the reference
// serializes these on the Python thread via np.save per tensor
// (reference extract_feature.py:128-148), which stalls the accelerator
// between batches.  This pool owns the file IO: Python hands over
// (path, header, payload) buffers and returns to dispatching the next
// batch immediately.
//
// C API (ctypes-friendly, no C++ symbols exported):
//   dw_create(n_threads)                    -> opaque pool*
//   dw_submit(pool, path, hdr, hlen, data, dlen) -> 0 ok / -1 (copies buffers)
//   dw_pending(pool)                        -> queued+in-flight count
//   dw_flush(pool)                          -> block until drained; #errors
//   dw_destroy(pool)
//
// Build: g++ -O3 -shared -fPIC -pthread dumpio.cpp -o libdumpio.so

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <sys/stat.h>
#include <errno.h>

namespace {

struct Job {
    std::string path;
    std::vector<char> bytes;   // header + payload, ready to write
};

struct Pool {
    std::deque<Job> queue;
    std::mutex mu;
    std::condition_variable cv;       // workers wait for work
    std::condition_variable drained;  // flush waits for empty
    std::vector<std::thread> workers;
    std::atomic<int> in_flight{0};
    std::atomic<int> errors{0};
    bool stop = false;

    explicit Pool(int n) {
        for (int i = 0; i < n; ++i) {
            workers.emplace_back([this] { run(); });
        }
    }

    ~Pool() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv.notify_all();
        for (auto& t : workers) t.join();
    }

    static int make_dirs(const std::string& path) {
        // create every parent directory of `path`
        for (size_t i = 1; i < path.size(); ++i) {
            if (path[i] == '/') {
                std::string dir = path.substr(0, i);
                if (mkdir(dir.c_str(), 0755) != 0 && errno != EEXIST) {
                    return -1;
                }
            }
        }
        return 0;
    }

    void run() {
        for (;;) {
            Job job;
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
            if (write_one(job) != 0) errors.fetch_add(1);
            // decrement under the mutex: otherwise flush() can test the
            // predicate, lose this notify before blocking, and wait forever
            {
                std::lock_guard<std::mutex> lk(mu);
                if (in_flight.fetch_sub(1) == 1) drained.notify_all();
            }
        }
    }

    static int write_one(const Job& job) {
        if (make_dirs(job.path) != 0) return -1;
        // write to a temp name then rename: readers never see partial dumps
        std::string tmp = job.path + ".tmp";
        FILE* f = std::fopen(tmp.c_str(), "wb");
        if (!f) return -1;
        size_t n = std::fwrite(job.bytes.data(), 1, job.bytes.size(), f);
        int rc = (n == job.bytes.size()) ? 0 : -1;
        if (std::fclose(f) != 0) rc = -1;
        if (rc == 0 && std::rename(tmp.c_str(), job.path.c_str()) != 0) rc = -1;
        if (rc != 0) std::remove(tmp.c_str());
        return rc;
    }

    void submit(Job&& job) {
        in_flight.fetch_add(1);
        {
            std::lock_guard<std::mutex> lk(mu);
            queue.push_back(std::move(job));
        }
        cv.notify_one();
    }

    int flush() {
        std::unique_lock<std::mutex> lk(mu);
        drained.wait(lk, [this] { return in_flight.load() == 0; });
        return errors.exchange(0);
    }
};

}  // namespace

extern "C" {

void* dw_create(int n_threads) {
    if (n_threads < 1) n_threads = 1;
    return new Pool(n_threads);
}

int dw_submit(void* pool, const char* path,
              const char* header, int64_t header_len,
              const char* data, int64_t data_len) {
    if (!pool || !path || header_len < 0 || data_len < 0) return -1;
    Job job;
    job.path = path;
    job.bytes.resize(static_cast<size_t>(header_len + data_len));
    if (header_len) std::memcpy(job.bytes.data(), header, header_len);
    if (data_len) std::memcpy(job.bytes.data() + header_len, data, data_len);
    static_cast<Pool*>(pool)->submit(std::move(job));
    return 0;
}

int dw_pending(void* pool) {
    return static_cast<Pool*>(pool)->in_flight.load();
}

int dw_flush(void* pool) {
    return static_cast<Pool*>(pool)->flush();
}

void dw_destroy(void* pool) {
    delete static_cast<Pool*>(pool);
}

}  // extern "C"
