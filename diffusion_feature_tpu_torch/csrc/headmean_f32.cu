// B3 for float32 inputs: head-mean attention probabilities with exact fp32
// products,
//   out[b, i, j] = (1/H) * sum_h exp(q[b,h,i] . k[b,h,j] * scale - lse[b,h,i])
// for (B, H, S, D) q and k and B2's per-row logsumexp.  float32 is a test
// dtype, on no path: bf16 and fp16 take the Hopper kernel of
// headmean_hopper.cuh, and wgmma has no exact fp32 product (TF32 would
// round the inputs to 10 mantissa bits).
//
// Replaces diffusion_feature_tpu/ops/flash_attention.py::_headmean_kernel
// (B3) for float32.  One block owns one (b, 64 query rows, 128 keys) output
// tile and loops over the H heads inside: for each head it loads the Q and
// K tiles into shared memory (synchronous 16-byte vectors, zero-filled past
// the ragged edge and past d=40's depth of 48), computes the 64x128 scores
// as an exact fp32 FMA emulation of mma.sync m16n8k16's fragment layout
// (tile_ops.cuh; each warp owns 16 rows), and adds exp2(s * scale *
// log2(e) - lse * log2(e)) into an fp32 register tile.  At the end it
// divides by H and writes the tile once, masking rows and columns past Sq
// and Sk.  q and k may be strided views (unit stride on D).

#include "tile_ops.cuh"

namespace {

using namespace dft;

constexpr int kBlockN = 128;  // keys per block

template <int D>
struct Cfg {
  static constexpr int kDP = padded_depth(D);
  static constexpr int kLd = kDP + kPad;
  static constexpr size_t kSmem = size_t(kBlockM + kBlockN) * kLd * sizeof(float);
};

// Element strides (sb, sh, ss) of q and k; d has unit stride.
struct Strides {
  long long v[6];
};

template <int D>
__global__ void __launch_bounds__(kThreads)
headmean_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ lse, float* __restrict__ out, int heads, int sq, int sk,
                float scale_log2, Strides st) {
  using C = Cfg<D>;
  using Reg = typename Ops<float>::Reg;
  constexpr int kDP = C::kDP, kLd = C::kLd, kNT = kBlockN / 8;
  constexpr float kLog2e = 1.4426950408889634f;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + kBlockM * kLd;

  const int k0 = blockIdx.x * kBlockN;
  const int q0 = blockIdx.y * kBlockM;
  const size_t b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const int q_valid = min(kBlockM, sq - q0), k_valid = min(kBlockN, sk - k0);
  const int qss = int(st.v[2]), kss = int(st.v[5]);

  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int h = 0; h < heads; ++h) {
    const size_t bh = b * heads + h;
    __syncthreads();  // every warp is done with the previous head's tiles
    load_tile<float, D, kDP>(qs, kLd, q + b * st.v[0] + h * st.v[1] + size_t(q0) * qss, qss,
                             q_valid, kBlockM);
    load_tile<float, D, kDP>(ks, kLd, k + b * st.v[3] + h * st.v[4] + size_t(k0) * kss, kss,
                             k_valid, kBlockN);
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
      load_a<float>(a, qs, kLd, row0, kk);
      mma_qk<float, kNT>(s, a, ks, kLd, kk);
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
    float* orow = out + (b * sq + row) * size_t(sk);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = k0 + j * 8 + 2 * t;
      const float lo = acc[j][2 * r] * inv, hi = acc[j][2 * r + 1] * inv;
      if (pairs) {
        if (col < sk) *reinterpret_cast<float2*>(orow + col) = make_float2(lo, hi);
      } else {
        if (col < sk) orow[col] = lo;
        if (col + 1 < sk) orow[col + 1] = hi;
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const float* lse, void* out, int b, int h, int sq,
           int sk, float scale, const long long* strides, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr auto kernel = headmean_kernel<D>;
  if (int err = allow_smem<kernel>(C::kSmem)) return err;
  Strides st;
  for (int i = 0; i < 6; ++i) st.v[i] = strides[i];
  const dim3 grid((sk + kBlockN - 1) / kBlockN, (sq + kBlockM - 1) / kBlockM, b);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), lse, static_cast<float*>(out),
      h, sq, sk, scale * 1.4426950408889634f, st);
  return int(cudaGetLastError());
}

}  // namespace

// The entry point; its contract is at dft::hopper::headmean::forward in
// headmean_hopper.cuh.  This library takes dtype 0 (float32) only.
extern "C" int dft_headmean_probs(const void* q, const void* k, const float* lse, void* out,
                                  int b, int h, int sq, int sk, int d, int dtype, float scale,
                                  const long long* strides, void* stream) {
  if (dtype != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40: return launch<40>(q, k, lse, out, b, h, sq, sk, scale, strides, s);
    case 64: return launch<64>(q, k, lse, out, b, h, sq, sk, scale, strides, s);
    case 72: return launch<72>(q, k, lse, out, b, h, sq, sk, scale, strides, s);
    case 80: return launch<80>(q, k, lse, out, b, h, sq, sk, scale, strides, s);
    case 88: return launch<88>(q, k, lse, out, b, h, sq, sk, scale, strides, s);
    case 128: return launch<128>(q, k, lse, out, b, h, sq, sk, scale, strides, s);
    case 160: return launch<160>(q, k, lse, out, b, h, sq, sk, scale, strides, s);
    default: return int(cudaErrorInvalidValue);
  }
}
