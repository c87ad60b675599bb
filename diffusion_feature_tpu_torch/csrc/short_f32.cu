// B4 for float32 inputs: direct-softmax attention for short key sequences,
//   o = softmax(q k^T * scale) v   over (B, H, S, D) tensors, Sk <= 512,
// with exact fp32 products, keys past Sk masked, and the softmax taken
// exactly (one max and one sum per row over the whole row), not online,
// with the division after the P V product, as the TPU kernel does.  bf16
// and fp16 take the Hopper kernel of short_hopper.cuh; wgmma has no exact
// fp32 product (TF32 would round the inputs to 10 mantissa bits).
//
// Replaces diffusion_feature_tpu/ops/flash_attention.py::_short_attn_kernel
// (B4) for float32.  What bounds it: two products per score (q k^T and
// p v), 4 B H Sq Sk D flops on the FMA pipes (67 TFLOP/s on an H100); at
// the short lengths it takes, a block's chain of loads and products and the
// launch itself weigh as much.  The products are simt_f32.cuh's
// register-tiled ones (no shuffle in a product), the tiles staged with
// cp.async.
//
// A block of 16 x 8 threads (ty = tid / 8, tx = tid % 8) owns 64 query rows
// of one (b, h) and the whole key sequence; its 64 x Sk score tile lives in
// shared memory.  Thread (ty, tx) owns rows ty + 16 i throughout:
//   1. for each 64-key tile of K, the 4 x 8 scores of keys tx + 8 j
//      (simt::nt), written to the score tile scaled by scale * log2 e, with
//      keys past Sk as -inf; the thread keeps its rows' running maxima;
//   2. the rows' maxima reduced over the 8 lanes that share ty (xor
//      shuffles, outside any product); each thread turns the scores it
//      wrote into exp2(s - max) in place (simt::exp2_sfu) and sums them,
//      the sums reduced the same way and kept in registers;
//   3. O = P V over 64-key tiles of V (simt::nnc, the output columns
//      tx + 8 e), then O / sum, stored for rows below Sq.
// Shared memory is what bounds the design: at Sk = 512 the score tile is
// 64 x 520 floats (133 KB) of the 227 KB a block may have, and a 64-row
// tile at ld = d + 4 is 42 KB at d=160.  Q and a K tile are live together
// in step 1, and so are two V tiles in step 3: the V ring is the K slots,
// or, with one K slot, that slot and Q's space (dead after step 1).  Two
// K slots let the next K tile load during a product; one K slot loads each
// after the last is consumed.  The launch takes two slots where they fit
// (not at d=128 and 160 with 512 keys: Q + 2 slots would be 234 and 259 KB)
// and cost no wave: where they leave as many blocks an SM as one slot, or
// the grid fits the card at once all the same.  Else one: d=64 at 256 keys
// and batch 2 is 160 blocks, two an SM with one slot (102 KB), one with
// two (120 KB).  V is double-buffered at every width, its first two tiles
// loading during step 2.  Rows past Sq and keys past Sk are zero-filled on
// load (zero V rows under P = 0).  q, k, v and o may be strided views (unit
// stride on D, 16-byte aligned strides); rows past Sq are never written.

#include "simt_f32.cuh"
#include "tile_ops.cuh"

namespace {

using namespace dft;
using namespace dft::simt;

constexpr int kMaxKeys = 512;   // the score tile's width limit

template <int D>
struct Cfg {
  static constexpr int kTX = 8, kThreads = 16 * kTX;   // ty = tid / 8, tx = tid % 8
  static constexpr int kBQ = 64, kBK = 64;             // rows ty + 16 i; keys per K/V tile
  static constexpr int kTM = kBQ / 16, kTN = kBK / kTX, kC = D / kTX;
  static constexpr int kLd = D + 4;                    // Q, K, V rows (ld / 4 odd)
  static constexpr size_t kTile = size_t(kBK) * kLd * sizeof(float);   // = a Q tile
  static constexpr __host__ __device__ int sk_pad(int sk) { return (sk + kBK - 1) / kBK * kBK; }
  // score rows: ld = 8 mod 32 puts a warp's four rows of eight keys on
  // distinct banks
  static constexpr __host__ __device__ int ld_s(int sk) { return sk_pad(sk) + 8; }
  // the score tile, Q and `slots` K slots
  static constexpr size_t smem(int sk, int slots) {
    return size_t(kBQ) * ld_s(sk) * sizeof(float) + (1 + slots) * kTile;
  }
  static_assert(D % 8 == 0, "the depth is whole float4s, and ld / 4 odd needs d % 8 == 0");
};

// Element strides (sb, sh, ss) of q, k, v and o; d has unit stride.
struct Strides {
  long long v[12];
};

template <int D, int kKSlots>
__global__ void __launch_bounds__(Cfg<D>::kThreads)
short_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          float* __restrict__ o, int heads, int sq, int sk, float scale_log2, Strides st) {
  using C = Cfg<D>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kTM = C::kTM, kTN = C::kTN, kC = C::kC;
  constexpr int kLd = C::kLd, kTX = C::kTX, kThreads = C::kThreads;
  constexpr int kTileF = kBK * kLd;

  const int ld_s = C::ld_s(sk);
  extern __shared__ __align__(16) float smem[];
  float* ss = smem;                  // kBQ x ld_s: S, then P
  float* qs = ss + kBQ * ld_s;       // Q; in step 3 V's second slot where kKSlots == 1
  float* kv0 = qs + kTileF;          // a K, later a V tile
  float* kv1 = kKSlots == 2 ? kv0 + kTileF : qs;   // V_j sits in (j odd ? kv1 : kv0)

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const float* kg = k + b * st.v[3] + h * st.v[4];
  const float* vg = v + b * st.v[6] + h * st.v[7];
  const long long kss = st.v[5], vss = st.v[8];
  const int n_tiles = (sk + kBK - 1) / kBK;

  auto load_k = [&](int j) {
    float* slot = kKSlots == 2 && (j & 1) ? kv1 : kv0;
    load_tile_async<kThreads, D>(slot, kLd, kg + size_t(j) * kBK * kss, kss,
                                 min(kBK, sk - j * kBK), kBK);
  };
  auto load_v = [&](int j) {
    load_tile_async<kThreads, D>((j & 1) ? kv1 : kv0, kLd, vg + size_t(j) * kBK * vss, vss,
                                 min(kBK, sk - j * kBK), kBK);
  };

  // prologue: Q and the first K tile
  load_tile_async<kThreads, D>(qs, kLd, q + b * st.v[0] + h * st.v[1] + q0 * st.v[2], st.v[2],
                               min(kBQ, sq - q0), kBQ);
  load_k(0);
  cp_async_commit();

  // 1. scores, tile by tile, and this thread's share of each row's maximum
  float m[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) m[i] = -INFINITY;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    if constexpr (kKSlots == 2) {
      if (j + 1 < n_tiles) load_k(j + 1);
      cp_async_commit();
      cp_async_wait<1>();   // K_j (and Q) landed; K_{j+1} may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int n = 0; n < kTN; ++n) s[i][n] = 0.f;
    nt<kTM, kTN, 16, kTX, D, 1>(s, qs + ty * kLd, kLd,
                                (kKSlots == 2 && (j & 1) ? kv1 : kv0) + tx * kLd, kLd);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int n = 0; n < kTN; ++n) {
        const float x = k0 + tx + kTX * n < sk ? s[i][n] * scale_log2 : -INFINITY;
        m[i] = fmaxf(m[i], x);
        ss[(ty + 16 * i) * ld_s + k0 + tx + kTX * n] = x;
      }
    __syncthreads();   // every warp is done with K_j's slot (and, after the last, with Q)
    if constexpr (kKSlots == 1) {
      if (j + 1 < n_tiles) {
        load_k(j + 1);
        cp_async_commit();
      }
    }
  }
  // the V ring's first two tiles load during step 2
  load_v(0);
  cp_async_commit();
  if (n_tiles > 1) load_v(1);
  cp_async_commit();

  // 2. exact softmax numerators of the thread's own scores, in place; the
  // row sums stay in registers (every row has a key, so the maxima are finite)
  float inv[kTM];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int off = 1; off < kTX; off <<= 1)
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
    float* srow = ss + (ty + 16 * i) * ld_s + tx;
    float sum = 0.f;
    for (int c = 0; c < n_tiles * kBK; c += kTX) {
      const float p = exp2_sfu(srow[c] - m[i]);
      srow[c] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 1; off < kTX; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    inv[i] = 1.f / sum;
  }

  // 3. O = P V, one 64-key tile of V at a time
  float acc[kTM][kC];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int e = 0; e < kC; ++e) acc[i][e] = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<1>();   // V_j landed; V_{j+1} may be in flight
    __syncthreads();      // and every thread's P is written
    nnc<kTM, kC, kTX, kBK>(acc, ss + ty * ld_s + j * kBK, ld_s, ((j & 1) ? kv1 : kv0) + tx,
                           kLd);
    __syncthreads();      // every warp is done with V_j's slot
    if (j + 2 < n_tiles) load_v(j + 2);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float* obase = o + b * st.v[9] + h * st.v[10] + tx;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    float* orow = obase + row * st.v[11];
#pragma unroll
    for (int e = 0; e < kC; ++e) orow[kTX * e] = acc[i][e] * inv[i];
  }
}

// Blocks an SM holds with `bytes` of dynamic shared memory each (228 KB an
// SM, 1 KB of it reserved per block)
constexpr int blocks_per_sm(size_t bytes) { return int(228 * 1024 / (bytes + 1024)); }
constexpr size_t kBlockSmemMax = 227 * 1024;

template <int D, int kKSlots>
int launch_slots(const float* q, const float* k, const float* v, float* o, int b, int h, int sq,
                 int sk, float scale, const Strides& st, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr auto kernel = short_f32<D, kKSlots>;
  // the limit is raised once, to what the most keys need (or the most a
  // block may have: two slots take the most keys at d <= 88 only)
  constexpr size_t kAllow = C::smem(kMaxKeys, kKSlots) < kBlockSmemMax
                                ? C::smem(kMaxKeys, kKSlots) : kBlockSmemMax;
  if (int err = allow_smem<kernel>(kAllow)) return err;
  const dim3 grid((sq + C::kBQ - 1) / C::kBQ, b * h);
  kernel<<<grid, C::kThreads, C::smem(sk, kKSlots), stream>>>(q, k, v, o, h, sq, sk,
                                                              scale * 1.4426950408889634f, st);
  return int(cudaGetLastError());
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int h, int sq, int sk,
           float scale, const long long* strides, cudaStream_t stream) {
  using C = Cfg<D>;
  if (sk < 1 || sk > kMaxKeys || sq < 1) return int(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 12; ++i) st.v[i] = strides[i];
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  // two slots where they fit and cost no wave: as many blocks an SM as one
  // slot allows, or room for the whole grid at once
  const size_t one = C::smem(sk, 1), two = C::smem(sk, 2);
  const long long blocks = (sq + C::kBQ - 1) / C::kBQ * (long long)(b * h);
  if (two <= kBlockSmemMax && (blocks_per_sm(two) >= blocks_per_sm(one) ||
                               blocks <= (long long)sm_count() * blocks_per_sm(two)))
    return launch_slots<D, 2>(qf, kf, vf, of, b, h, sq, sk, scale, st, stream);
  return launch_slots<D, 1>(qf, kf, vf, of, b, h, sq, sk, scale, st, stream);
}

}  // namespace

// The entry point; its contract is at dft::hopper::short_attn::forward in
// short_hopper.cuh.  This library takes dtype 0 (float32) only.
extern "C" int dft_short_attention_forward(const void* q, const void* k, const void* v, void* o,
                                           int b, int h, int sq, int sk, int d, int dtype,
                                           float scale, const long long* strides, void* stream) {
  if (dtype != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40: return launch<40>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 64: return launch<64>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 72: return launch<72>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 80: return launch<80>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 88: return launch<88>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 128: return launch<128>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 160: return launch<160>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    default: return int(cudaErrorInvalidValue);
  }
}
