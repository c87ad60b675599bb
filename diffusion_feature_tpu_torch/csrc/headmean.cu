// Head-mean attention probabilities for Hopper (sm_90a):
//   out[b, i, j] = (1/H) * sum_h exp(q[b,h,i] . k[b,h,j] * scale - lse[b,h,i])
// for (B, H, S, D) q and k and the per-row logsumexp that the flash kernel's
// B2 variant wrote, so the (Sq, Sk) map of each head is normalised without a
// second softmax pass and the per-head (B, H, Sq, Sk) tensor never exists.
//
// Replaces diffusion_feature_tpu/ops/flash_attention.py::_headmean_kernel
// (B3).  The TPU kernel took 256x256 VMEM blocks and looped over the heads
// in order.  Here one block owns one (b, 64 query rows, 128 keys) output
// tile and loops over the H heads inside: for each head it loads the Q and
// K tiles into shared memory (zero-filled past the ragged edge and past
// d=40's mma depth of 48), computes the 64x128 scores on the tensor cores
// (mma.sync m16n8k16, fp32 accumulation; each warp owns 16 rows), and adds
// exp2(s * scale * log2(e) - lse * log2(e)) into an fp32 register tile.  At
// the end it divides by H, casts to the input dtype and writes the tile
// once, masking rows and columns past Sq and Sk.
//
// What bounds it: at (2,10,4096,64) it does 2*B*H*Sq*Sk*D = 42.9 GFLOP, a
// 43.4 us bound at 989 TFLOP/s, and writes a 67 MB bf16 map, 20 us at
// 3.35 TB/s; but its B*H*Sq*Sk = 3.4e8 exponentials take about 80 us at 16
// per clock per SM, so the special-function unit is the practical limit,
// as in the flash kernel at d=64.  The design spends nothing else per
// score: no max, no sum, no second pass.  Q/K tiles are re-read once per
// (query tile, key tile) pair; at these sizes they stay in the 50 MB L2.
// fp32 inputs take the exact fp32 FMA emulation of tile_ops.cuh.

#include "tile_ops.cuh"

namespace {

using namespace dft;

constexpr int kBlockN = 128;  // keys per block

template <typename T, int D>
struct Cfg {
  static constexpr int kDP = padded_depth(D);
  static constexpr int kLd = kDP + kPad;
  static constexpr size_t kSmem = size_t(kBlockM + kBlockN) * kLd * sizeof(T);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
headmean_kernel(const T* __restrict__ q, const T* __restrict__ k, const float* __restrict__ lse,
                T* __restrict__ out, int heads, int sq, int sk, float scale_log2) {
  using C = Cfg<T, D>;
  using Op = Ops<T>;
  using Reg = typename Op::Reg;
  constexpr int kDP = C::kDP, kLd = C::kLd, kNT = kBlockN / 8;
  constexpr float kLog2e = 1.4426950408889634f;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kBlockM * kLd;

  const int k0 = blockIdx.x * kBlockN;
  const int q0 = blockIdx.y * kBlockM;
  const size_t b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const int q_valid = min(kBlockM, sq - q0), k_valid = min(kBlockN, sk - k0);

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int h = 0; h < heads; ++h) {
    const size_t bh = b * heads + h;
    __syncthreads();  // every warp is done with the previous head's tiles
    load_tile<T, D, kDP>(qs, kLd, q + (bh * sq + q0) * D, D, q_valid, kBlockM);
    load_tile<T, D, kDP>(ks, kLd, k + (bh * sk + k0) * D, D, k_valid, kBlockN);
    // this lane's two rows' logsumexp in log2 units (rows past Sq: unused)
    float l2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + row0 + g + 8 * r;
      l2[r] = row < sq ? lse[bh * sq + row] * kLog2e : 0.f;
    }
    __syncthreads();

    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kDP / 16; ++kk) {
      Reg a[4];
      load_a<T>(a, qs, kLd, row0, kk);
      mma_qk<T, kNT>(s, a, ks, kLd, kk);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += exp2f(s[j][e] * scale_log2 - l2[e >> 1]);
    }
  }

  const float inv = 1.f / heads;
  const bool pairs = (sk & 1) == 0;  // an even row length keeps column pairs aligned
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + g + 8 * r;
    if (row >= sq) continue;
    T* orow = out + (b * sq + row) * size_t(sk);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = k0 + j * 8 + 2 * t;
      const float lo = acc[j][2 * r] * inv, hi = acc[j][2 * r + 1] * inv;
      if (pairs) {
        if (col < sk) *reinterpret_cast<Reg*>(orow + col) = Op::pack(lo, hi);
      } else {
        if (col < sk) orow[col] = Op::from_float(lo);
        if (col + 1 < sk) orow[col + 1] = Op::from_float(hi);
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const float* lse, void* out, int b, int h, int sq,
           int sk, float scale, cudaStream_t stream) {
  using C = Cfg<T, D>;
  constexpr auto kernel = headmean_kernel<T, D>;
  if (int err = allow_smem<kernel>(C::kSmem)) return err;
  const dim3 grid((sk + kBlockN - 1) / kBlockN, (sq + kBlockM - 1) / kBlockM, b);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), lse, static_cast<T*>(out), h, sq, sk,
      scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const float* lse, void* out, int b, int h, int sq,
               int sk, int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 40: return launch<T, 40>(q, k, lse, out, b, h, sq, sk, scale, stream);
    case 64: return launch<T, 64>(q, k, lse, out, b, h, sq, sk, scale, stream);
    case 80: return launch<T, 80>(q, k, lse, out, b, h, sq, sk, scale, stream);
    case 128: return launch<T, 128>(q, k, lse, out, b, h, sq, sk, scale, stream);
    case 160: return launch<T, 160>(q, k, lse, out, b, h, sq, sk, scale, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (b, h, sq, d), k (b, h, sk, d): contiguous device buffers of one dtype,
// 16-byte aligned; lse: contiguous fp32 (b, h, sq); out: contiguous
// (b, sq, sk) of q's dtype.  dtype: 0 float32, 1 float16, 2 bfloat16.
// Launches on `stream` without synchronising and returns the cudaError_t of
// the launch.
extern "C" int dft_headmean_probs(const void* q, const void* k, const float* lse, void* out,
                                  int b, int h, int sq, int sk, int d, int dtype, float scale,
                                  void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, lse, out, b, h, sq, sk, d, scale, s);
    case 1: return dispatch_d<__half>(q, k, lse, out, b, h, sq, sk, d, scale, s);
    case 2: return dispatch_d<__nv_bfloat16>(q, k, lse, out, b, h, sq, sk, d, scale, s);
    default: return int(cudaErrorInvalidValue);
  }
}
