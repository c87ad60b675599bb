// B1 and B2 for float32 inputs: flash-attention forward with exact fp32
// products, softmax(q k^T * scale) v over (b, h, s, d) tensors with an fp32
// running max, denominator and accumulator; with kLse each row's
// logsumexp, which the backward reads.
//
// Replaces diffusion_feature_tpu/ops/flash_attention.py::_flash_kernel (B1)
// and ::_flash_lse_kernel (B2) for float32.  float32 runs on training
// paths: the shipped ade_vpd config and train_unet run SD-1.5 in fp32 (the
// JAX reference trains in fp32), whose self-attentions are B2 forwards
// under the backward, and SD-2.1's upcast attention store runs B2 in fp32.
//
// What bounds it: every score costs 2 d FMAs (q k^T and p v) on the FMA
// pipes, 67 TFLOP/s on an H100 (wgmma has no exact fp32 product: TF32
// would round the inputs to 10 mantissa bits), so at the paths' lengths
// the FMA issue rate is the limit, not memory; what stands between a
// product and that rate is the shared-memory bandwidth its operands take
// (see simt_f32.cuh).  The design: simt_f32.cuh's register-tiled products
// with no shuffle in a product loop, each thread owning a 4 x 8 block of
// scores (12 float4 loads for 128 FMAs) and a 4 x d/8 block of the output
// (4 float4 and d/2 scalar loads for 2 d FMAs per 4 keys), and cp.async
// staging that overlaps each tile's load with the other product (the next
// K tile loads during P V, the next V tile during Q K^T).  A block is 128
// threads, small enough that three fit an SM at d=64 and a 1024-token call
// fills the card in one wave.
//
// A block of 16 x 8 threads owns kBQ query rows of one (b, h) and walks
// every key tile itself.  Thread (ty, tx) owns rows ty + 16 i and keys
// tx + 8 j of each score tile: the softmax's row maxima reduce over the 8
// lanes that share ty (three xor shuffles per row and tile, outside the
// products); P goes through shared memory to the P V product, in which the
// thread owns the same rows (so the running max and its rescale stay in
// registers) and the output columns tx + 8 e.  Keys past Sk get -inf, rows
// past Sq are zero-filled on load and never stored.  Head widths 40, 64,
// 72, 80, 88, 128 and 160 take one pass (kDC = d).  d=512 (the VAE's single
// head) does not fit a block's registers or shared memory in one pass:
// blockIdx.z splits its output columns into 128-wide slices, each of which
// recomputes the scores (64-row x 32-key tiles, 4 x 4 a thread).

#include "simt_f32.cuh"
#include "tile_ops.cuh"

namespace {

using namespace dft;
using namespace dft::simt;

template <int D>
struct Cfg {
  static constexpr bool kWide = D > 160;
  static constexpr int kTX = 8, kThreads = 16 * kTX;   // ty = tid / 8, tx = tid % 8
  static constexpr int kDC = kWide ? 128 : D;          // output columns per block
  static constexpr int kBQ = 64;                       // query rows per block: ty + 16 i
  static constexpr int kBK = kWide ? 32 : 64;          // keys per tile: tx + 8 j
  static constexpr int kTM = kBQ / 16, kTN = kBK / kTX;
  // three blocks an SM up to d=64 (168 registers a thread), so that a
  // 1024-token call at d=64 (320 blocks) runs in one wave
  static constexpr int kMinBlocks = D <= 64 ? 3 : 1;
  static constexpr int kC = kDC / kTX;                 // output columns tx + 8 e a thread owns
  // K's rows are picked by tx (ld / 4 odd); P's stores hit rows ty.. of 8
  // consecutive keys (ld = 8 mod 32 puts a warp's four rows on distinct banks)
  static constexpr int kLdQK = D + 4, kLdV = kDC + 4, kLdP = kBK + 8;
  static_assert(D % 8 == 0 && D % kDC == 0, "output slices must tile the head width");
  static constexpr size_t kSmem =
      (size_t(kBQ) * kLdQK + size_t(kBK) * kLdQK + size_t(kBK) * kLdV + size_t(kBQ) * kLdP) *
      sizeof(float);
};

// Element strides (sb, sh, ss) of q, k, v and o; d has unit stride.
struct Strides {
  long long v[12];
};

template <int D, bool kLse>
__global__ void __launch_bounds__(Cfg<D>::kThreads, Cfg<D>::kMinBlocks)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int heads, int sq, int sk, float scale_log2, Strides st) {
  using C = Cfg<D>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kTM = C::kTM, kTN = C::kTN, kC = C::kC;
  constexpr int kDC = C::kDC, kLdQK = C::kLdQK, kLdV = C::kLdV, kLdP = C::kLdP;
  constexpr int kTX = C::kTX, kThreads = C::kThreads;

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * kLdQK;
  float* vs = ks + kBK * kLdQK;
  float* ps = vs + kBK * kLdV;

  const int q0 = blockIdx.x * kBQ;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int dc0 = blockIdx.z * kDC;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;

  const float* kg = k + b * st.v[3] + h * st.v[4];
  const float* vg = v + b * st.v[6] + h * st.v[7] + dc0;
  const long long kss = st.v[5], vss = st.v[8];
  const int n_tiles = (sk + kBK - 1) / kBK;

  // prologue: Q and the first K tile (group 0), the first V tile (group 1)
  load_tile_async<kThreads, D>(qs, kLdQK, q + b * st.v[0] + h * st.v[1] + q0 * st.v[2], st.v[2],
                               min(kBQ, sq - q0), kBQ);
  load_tile_async<kThreads, D>(ks, kLdQK, kg, kss, min(kBK, sk), kBK);
  cp_async_commit();
  load_tile_async<kThreads, kDC>(vs, kLdV, vg, vss, min(kBK, sk), kBK);
  cp_async_commit();

  float acc[kTM][kC];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int e = 0; e < kC; ++e) acc[i][e] = 0.f;
  float m[kTM], l[kTM];   // running max (scaled, log2 units) and this lane's share of the sum
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBK;
    cp_async_wait<1>();   // K_j (and Q) landed; V_j may be in flight
    __syncthreads();

    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int n = 0; n < kTN; ++n) s[i][n] = 0.f;
    nt<kTM, kTN, 16, kTX, D, C::kMinBlocks == 3 ? 1 : 2>(s, qs + ty * kLdQK, kLdQK,
                                                         ks + tx * kLdQK, kLdQK);

    // online softmax of rows ty + 16 i; keys past the end get -inf
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kTN; ++n) {
        s[i][n] = k0 + tx + kTX * n < sk ? s[i][n] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][n]);
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      // every tile holds at least one valid key, so m_new is finite
      const float m_new = fmaxf(m[i], mx);
      const float alpha = exp2_sfu(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kTN; ++n) {
        const float p = exp2_sfu(s[i][n] - m_new);
        sum += p;
        ps[(ty + 16 * i) * kLdP + tx + kTX * n] = p;
      }
      l[i] = l[i] * alpha + sum;
#pragma unroll
      for (int e = 0; e < kC; ++e) acc[i][e] *= alpha;
    }
    __syncthreads();   // P written; every warp is done with K_j
    if (j + 1 < n_tiles)
      load_tile_async<kThreads, D>(ks, kLdQK, kg + size_t(k0 + kBK) * kss, kss,
                                   min(kBK, sk - k0 - kBK), kBK);
    cp_async_commit();
    cp_async_wait<1>();   // V_j landed; K_{j+1} may be in flight
    __syncthreads();

    nnc<kTM, kC, kTX, kBK>(acc, ps + ty * kLdP, kLdP, vs + tx, kLdV);
    __syncthreads();   // every warp is done with V_j and P
    if (j + 1 < n_tiles)
      load_tile_async<kThreads, kDC>(vs, kLdV, vg + size_t(k0 + kBK) * vss, vss,
                                     min(kBK, sk - k0 - kBK), kBK);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float tot = l[i];
#pragma unroll
    for (int off = 1; off < kTX; off <<= 1) tot += __shfl_xor_sync(0xffffffffu, tot, off);
    const float inv = 1.f / tot;
    const int row = q0 + ty + 16 * i;
    if (row < sq) {
      float* orow = o + b * st.v[9] + h * st.v[10] + row * st.v[11] + dc0 + tx;
#pragma unroll
      for (int e = 0; e < kC; ++e) orow[kTX * e] = acc[i][e] * inv;
      // natural-log logsumexp of the scaled scores: ln 2 * (m + log2 l)
      if constexpr (kLse) {
        if (tx == 0 && blockIdx.z == 0)
          lse[size_t(bh) * sq + row] = (m[i] + log2f(tot)) * 0.6931471805599453f;
      }
    }
  }
}

template <int D, bool kLse>
int launch(const float* q, const float* k, const float* v, float* o, float* lse, int b, int h,
           int sq, int sk, float scale, const Strides& st, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr auto kernel = flash_fwd_f32<D, kLse>;
  if (int err = allow_smem<kernel>(C::kSmem)) return err;
  const dim3 grid((sq + C::kBQ - 1) / C::kBQ, b * h, D / C::kDC);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(q, k, v, o, lse, h, sq, sk,
                                                scale * 1.4426950408889634f, st);
  return int(cudaGetLastError());
}

// B1 at every width, B2 at the U-Nets' widths only: the VAE's d=512 head
// never feeds the attention store.
template <bool kLse>
int dispatch_d(const float* q, const float* k, const float* v, float* o, float* lse, int b, int h,
               int sq, int sk, int d, float scale, const Strides& st, cudaStream_t s) {
  switch (d) {
    case 40: return launch<40, kLse>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
    case 64: return launch<64, kLse>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
    case 72: return launch<72, kLse>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
    case 80: return launch<80, kLse>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
    case 88: return launch<88, kLse>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
    case 128: return launch<128, kLse>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
    case 160: return launch<160, kLse>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
    case 512:
      if constexpr (!kLse) return launch<512, false>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
      return int(cudaErrorInvalidValue);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// The entry point; its contract is at dft::hopper::forward in
// flash_hopper.cuh.  This library takes dtype 0 (float32) only.
extern "C" int dft_flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                           float* lse, int b, int h, int sq, int sk, int d,
                                           int dtype, float scale, const long long* strides,
                                           void* stream) {
  if (dtype != 0) return int(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 12; ++i) st.v[i] = strides[i];
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lse ? dispatch_d<true>(qf, kf, vf, of, lse, b, h, sq, sk, d, scale, st, s)
             : dispatch_d<false>(qf, kf, vf, of, lse, b, h, sq, sk, d, scale, st, s);
}
