// Flash-attention forward for Hopper (sm_90a): non-causal, unmasked
// softmax(q k^T * scale) v over (B*H, S, D) tensors, with an fp32 running
// max, denominator and accumulator, so the (Sq, Sk) score matrix never
// reaches device memory.  With kLse it also writes each row's logsumexp.
//
// Replaces diffusion_feature_tpu/ops/flash_attention.py::_flash_kernel (B1)
// and ::_flash_lse_kernel (B2, the same kernel plus the logsumexp; the
// head-mean kernel in headmean.cu consumes it).  On the TPU the key axis
// was a sequential grid dimension carrying its state in VMEM scratch; here
// one thread block owns 64 query rows of one (b, h) and walks every key
// tile itself, so nothing is carried between blocks.
//
// What bounds it: at the main path's d=64 and 4096 tokens one call does
// 4*B*H*S^2*D flops on 4*B*H*S*D*2 bytes, about 4000 flops per byte, far
// above the card's ~295 bf16 flops per byte, so the tensor cores (and the
// S^2 exponentials beside them) are the limit, not memory.  B2 adds
// B*H*Sq*4 bytes, nothing to that balance.  This first version spends its
// time on that side: QK^T and PV run on the tensor cores through mma.sync
// m16n8k16 (bf16/fp16 in, fp32 accumulate), the scores stay in registers,
// the softmax uses exp2 with the scale folded in, and each K/V tile is read
// from device memory once per 64 query rows.  It does not yet overlap loads
// with compute (no cp.async/TMA) nor use wgmma; both are the next steps
// toward the card's peak.
//
// Layout: each of the 4 warps owns 16 query rows.  A fragment element
// (row, col) of an m16n8k16 operand lives in lane 4*(row%8) + (col%8)/2, so
// the score accumulator of two adjacent 8-key tiles is already the A operand
// of the PV product.  Head widths: 40, 64, 80, 128, 160 (the U-Nets' heads)
// and 512 (the VAE's single head).  d=40 is zero-padded to the mma depth 48
// in shared memory for QK^T; the PV product needs only 8-column output
// tiles, which every width fills.  Widths up to 160 keep the whole 16 x d
// fp32 accumulator of a warp in registers; d=512 does not fit, so
// blockIdx.z splits its output columns into 128-wide slices and each slice
// recomputes the scores.
//
// fp32 inputs take the same code with the tensor-core product replaced by
// an exact fp32 FMA emulation of the same fragment layout (TF32 would round
// the inputs to 10 mantissa bits).

#include "tile_ops.cuh"

namespace {

using namespace dft;

template <typename T, int D>
struct Cfg {
  static constexpr int kDP = padded_depth(D);          // QK^T depth
  static constexpr int kDC = D <= 160 ? D : 128;        // output columns per block
  static constexpr int kBlockN = D <= 128 ? 64 : 32;    // keys per tile
  static constexpr int kLdQK = kDP + kPad;
  static constexpr int kLdV = kDC + kPad;
  static_assert(D % kDC == 0 && kDC % 8 == 0, "output slices must tile the head width");
  static constexpr size_t kSmem =
      (size_t(kBlockM) * kLdQK + size_t(kBlockN) * kLdQK + size_t(kBlockN) * kLdV) * sizeof(T);
};

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int sq, int sk, float scale_log2) {
  using C = Cfg<T, D>;
  using Op = Ops<T>;
  using Reg = typename Op::Reg;
  constexpr int kDP = C::kDP, kDC = C::kDC, kBN = C::kBlockN;
  constexpr int kLdQK = C::kLdQK, kLdV = C::kLdV;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kBlockM * kLdQK;
  T* vs = ks + kBN * kLdQK;

  const int q0 = blockIdx.x * kBlockM;
  const size_t bh = blockIdx.y;
  const int dc0 = blockIdx.z * kDC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;

  const T* kg = k + bh * sk * D;
  const T* vg = v + bh * sk * D + dc0;
  load_tile<T, D, kDP>(qs, kLdQK, q + (bh * sq + q0) * D, D, min(kBlockM, sq - q0), kBlockM);

  float acc[kDC / 8][4];
#pragma unroll
  for (int n = 0; n < kDC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g+8 (log2 units)
  float l[2] = {0.f, 0.f};              // this lane's share of the running denominator

  for (int k0 = 0; k0 < sk; k0 += kBN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    const int kv_valid = min(kBN, sk - k0);
    load_tile<T, D, kDP>(ks, kLdQK, kg + size_t(k0) * D, D, kv_valid, kBN);
    load_tile<T, kDC>(vs, kLdV, vg + size_t(k0) * D, D, kv_valid, kBN);
    __syncthreads();

    // scores of this warp's 16 rows against the kBN keys of the tile
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kDP / 16; ++kk) {
      Reg a[4];
      load_a<T>(a, qs, kLdQK, row0, kk);
      mma_qk<T, kBN / 8>(s, a, ks, kLdQK, kk);
    }

    // online softmax; keys past the end get -inf and so weight 0
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = key < sk ? s[j][e] * scale_log2 : -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // every tile holds at least one valid key, so m_new is finite
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_new);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < kDC / 8; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // acc += P V: two adjacent 8-key score tiles form one A operand
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      Reg a[4];
      a[0] = Op::pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = Op::pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = Op::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = Op::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < kDC / 8; ++n) {
        const T* vb = vs + (kk * 16 + 2 * t) * kLdV + n * 8 + g;
        Reg b[2];
        b[0] = Op::pair(vb[0], vb[kLdV]);
        b[1] = Op::pair(vb[8 * kLdV], vb[9 * kLdV]);
        Op::mma(acc[n], a, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tot = l[r];
    tot += __shfl_xor_sync(0xffffffffu, tot, 1);
    tot += __shfl_xor_sync(0xffffffffu, tot, 2);
    const float inv = 1.f / tot;
    const int row = q0 + row0 + g + 8 * r;
    if (row < sq) {
      T* orow = o + (bh * sq + row) * D + dc0;
#pragma unroll
      for (int n = 0; n < kDC / 8; ++n)
        *reinterpret_cast<Reg*>(orow + n * 8 + 2 * t) =
            Op::pack(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      // natural-log logsumexp of the scaled scores: ln 2 * (m + log2 l)
      if constexpr (kLse) {
        if (t == 0 && blockIdx.z == 0) lse[bh * sq + row] = (m[r] + log2f(tot)) * 0.6931471805599453f;
      }
    }
  }
}

template <typename T, int D, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
           int sk, float scale, cudaStream_t stream) {
  using C = Cfg<T, D>;
  auto kernel = flash_fwd_kernel<T, D, kLse>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::kSmem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh, D / C::kDC);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, sq, sk, scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

// The logsumexp variant (B2) is built for the head-mean path's widths only;
// the VAE's d=512 head never feeds the attention store.
template <typename T, bool kLse>
int dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse, int bh, int sq,
               int sk, int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 40: return launch<T, 40, kLse>(q, k, v, o, lse, bh, sq, sk, scale, stream);
    case 64: return launch<T, 64, kLse>(q, k, v, o, lse, bh, sq, sk, scale, stream);
    case 80: return launch<T, 80, kLse>(q, k, v, o, lse, bh, sq, sk, scale, stream);
    case 128: return launch<T, 128, kLse>(q, k, v, o, lse, bh, sq, sk, scale, stream);
    case 160: return launch<T, 160, kLse>(q, k, v, o, lse, bh, sq, sk, scale, stream);
    case 512:
      if constexpr (!kLse) return launch<T, 512, false>(q, k, v, o, lse, bh, sq, sk, scale, stream);
      return int(cudaErrorInvalidValue);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_lse(const void* q, const void* k, const void* v, void* o, float* lse, int bh,
                 int sq, int sk, int d, float scale, cudaStream_t stream) {
  return lse ? dispatch_d<T, true>(q, k, v, o, lse, bh, sq, sk, d, scale, stream)
             : dispatch_d<T, false>(q, k, v, o, lse, bh, sq, sk, d, scale, stream);
}

}  // namespace

// q, k, v, o: contiguous (bh, s, d) device buffers of one dtype, 16-byte
// aligned.  lse: null (B1), or a contiguous fp32 (bh, sq) buffer that
// receives each row's logsumexp (B2).  dtype: 0 float32, 1 float16,
// 2 bfloat16.  Launches on `stream` without synchronising and returns the
// cudaError_t of the launch.
extern "C" int dft_flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                           float* lse, int bh, int sq, int sk, int d, int dtype,
                                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_lse<float>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
    case 1: return dispatch_lse<__half>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
    case 2: return dispatch_lse<__nv_bfloat16>(q, k, v, o, lse, bh, sq, sk, d, scale, s);
    default: return int(cudaErrorInvalidValue);
  }
}
