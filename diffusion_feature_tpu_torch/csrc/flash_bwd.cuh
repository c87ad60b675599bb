// The flash-attention backward: dq, dk and dv of softmax(q k^T * scale) v
// from q, k, v, the forward's output o, the output's gradient do and the
// forward's fp32 logsumexp (B2's), FA2-style, with no (Sq, Sk) tensor in
// device memory.
//
// Replaces the JAX package's flash backward, which is no Pallas kernel: the
// custom VJP ``_flash_diff_bwd`` (diffusion_feature_tpu/ops/flash_attention.py
// :212), XLA's einsum-softmax VJP below sq*sk = 8192^2 and the q-chunked
// ``_chunked_attention_bwd`` (:170) at or above it.  Both recompute the
// probabilities from q and k; so does this kernel, from the saved logsumexp
// instead of a second softmax.
//
// Three launches on one stream, deterministic (no atomics):
//   1. delta = rowsum(do * o) in fp32, one warp per query row, (B, H, Sq);
//   2. dk, dv: one block per 64 keys of one (b, h), each warp owning 16 keys,
//      walks every query tile: s^T = k q^T, p^T = exp(s^T * scale - lse),
//      dp^T = v do^T, ds^T = p^T (dp^T - delta) * scale, then dv += p^T do
//      and dk += ds^T q;
//   3. dq: one block per 64 query rows walks every key tile: s = q k^T,
//      p = exp(s * scale - lse), dp = do v^T, ds = p (dp - delta) * scale,
//      dq += ds k.
// So the scores are computed twice (passes 2 and 3) and the products are
// seven against the forward's two; the least work is five products
// (10 B H Sq Sk D flops), which bounds it by operations on an H100 at every
// width of the U-Nets.  The tiles are mma.sync m16n8k16 fragments through
// shared memory (tile_ops.cuh's layout): bf16 and fp16 run the tensor cores
// with fp32 accumulators, p and ds rounded to the input type as operands;
// float32 runs tile_ops.cuh's exact fp32 emulation of the same fragments.
// Every accumulator stays in registers; loads are synchronous 16-byte
// vectors, two block-wide barriers per tile.  A simple kernel: no TMA, no
// wgmma, no pipelining.
//
// Head widths 40, 64, 72, 80, 88, 128 and 160 (B2's): a width that is no
// multiple of 16 is zero-padded in shared memory for the products over d.
// Inputs are (B, H, S, D) with element strides (sb, sh, ss) and unit
// stride along d, as the forward takes them; so are the outputs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "tile_ops.cuh"

namespace dft {

// m16n8k16 on the tensor cores for the 16-bit types, in the fragment layout
// tile_ops.cuh documents; two elements of T per 32-bit register.
template <typename T, typename T2>
struct Ops16 {
  using Reg = uint32_t;
  static __device__ __forceinline__ Reg load2(const T* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ Reg pair(T lo, T hi) {
    T2 v;
    v.x = lo;
    v.y = hi;
    return *reinterpret_cast<const uint32_t*>(&v);
  }
};

template <>
struct Ops<__nv_bfloat16> : Ops16<__nv_bfloat16, __nv_bfloat162> {
  static __device__ __forceinline__ Reg pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float c[4], const Reg a[4], const Reg b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Ops<__half> : Ops16<__half, __half2> {
  static __device__ __forceinline__ Reg pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float c[4], const Reg a[4], const Reg b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

namespace bwd {

constexpr float kLog2e = 1.4426950408889634f;

template <typename T, int D>
struct Cfg {
  static constexpr int kDP = padded_depth(D);          // depth of the products over d
  static constexpr int kLd = kDP + kPad;               // every shared tile's row
  static constexpr int kBQ = D <= 64 ? 64 : 32;        // pass 2: query rows per tile
  static constexpr int kBK = D <= 128 ? 64 : 32;       // pass 3: keys per tile
  static_assert(D % 8 == 0, "output columns come in 8-wide fragments");
  // pass 2: k, v (64 rows each), q, do (kBQ rows each), lse and delta
  static constexpr size_t kSmemKV =
      size_t(2 * kBlockM + 2 * kBQ) * kLd * sizeof(T) + 2 * kBQ * sizeof(float);
  // pass 3: q, do (64 rows each), k, v (kBK rows each)
  static constexpr size_t kSmemQ = size_t(2 * kBlockM + 2 * kBK) * kLd * sizeof(T);
};

// Element strides (sb, sh, ss) of q, k, v, o, do, dq, dk and dv, in order.
struct Strides {
  long long v[24];
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
delta_kernel(const T* __restrict__ o, const T* __restrict__ dout, float* __restrict__ delta,
             int heads, int sq, Strides st) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  if (row >= sq) return;
  const T* orow = o + b * st.v[9] + h * st.v[10] + row * st.v[11];
  const T* drow = dout + b * st.v[12] + h * st.v[13] + row * st.v[14];
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f32(orow[c]), to_f32(drow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[size_t(bh) * sq + row] = acc;
}

// B(k, n) fragments of a shared tile whose rows are k and columns n (the
// PV-style operand): rows kk*16 + 2t (+1, +8, +9), column n*8 + g.
template <typename T>
__device__ __forceinline__ void load_b_rows(typename Ops<T>::Reg b[2], const T* tile, int ld,
                                            int kk, int n) {
  const int lane = threadIdx.x & 31;
  const T* p = tile + (kk * 16 + 2 * (lane & 3)) * ld + n * 8 + (lane >> 2);
  b[0] = Ops<T>::pair(p[0], p[ld]);
  b[1] = Ops<T>::pair(p[8 * ld], p[9 * ld]);
}

// The A operand of 16 rows x 16 columns from two adjacent 8-column
// accumulator tiles (an accumulator's fragment is already A's layout).
template <typename T>
__device__ __forceinline__ void acc_to_a(typename Ops<T>::Reg a[4], const float lo[4],
                                         const float hi[4]) {
  a[0] = Ops<T>::pack(lo[0], lo[1]);
  a[1] = Ops<T>::pack(lo[2], lo[3]);
  a[2] = Ops<T>::pack(hi[0], hi[1]);
  a[3] = Ops<T>::pack(hi[2], hi[3]);
}

// Store a warp's 16 x D accumulator rows (rows g and g+8 of the lane) into
// rows base_row.. of a (b, h) slice with row stride ss, the rows at or past
// `valid` skipped.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long ss, int row, int valid,
                                           const float acc[][4]) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r < valid) {
      T* dst = base + (row + 8 * r) * ss;
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        *reinterpret_cast<typename Ops<T>::Reg*>(dst + n * 8 + 2 * t) =
            Ops<T>::pack(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, int heads,
            int sq, int sk, float scale, float scale_log2, Strides st) {
  using C = Cfg<T, D>;
  using Op = Ops<T>;
  using Reg = typename Op::Reg;
  constexpr int kDP = C::kDP, kLd = C::kLd, kBQ = C::kBQ;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kBlockM * kLd;
  T* qs = vs + kBlockM * kLd;
  T* dos = qs + kBQ * kLd;
  float* lse_s = reinterpret_cast<float*>(dos + kBQ * kLd);  // log2 units; +inf past sq
  float* dl_s = lse_s + kBQ;

  const int k0 = blockIdx.x * kBlockM;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;

  const int kv_valid = min(kBlockM, sk - k0);
  load_tile<T, D, kDP>(ks, kLd, k + b * st.v[3] + h * st.v[4] + k0 * st.v[5], int(st.v[5]),
                       kv_valid, kBlockM);
  load_tile<T, D, kDP>(vs, kLd, v + b * st.v[6] + h * st.v[7] + k0 * st.v[8], int(st.v[8]),
                       kv_valid, kBlockM);
  const T* qg = q + b * st.v[0] + h * st.v[1];
  const T* dog = dout + b * st.v[12] + h * st.v[13];
  const int qss = int(st.v[2]), doss = int(st.v[14]);
  const float* lseg = lse + size_t(bh) * sq;
  const float* dlg = delta + size_t(bh) * sq;

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int q0 = 0; q0 < sq; q0 += kBQ) {
    __syncthreads();  // every warp is done with the previous q/do tile
    const int q_valid = min(kBQ, sq - q0);
    load_tile<T, D, kDP>(qs, kLd, qg + size_t(q0) * qss, qss, q_valid, kBQ);
    load_tile<T, D, kDP>(dos, kLd, dog + size_t(q0) * doss, doss, q_valid, kBQ);
    for (int i = threadIdx.x; i < kBQ; i += kThreads) {
      // a row past the end gets p = exp2(-inf) = 0, so ds = 0 too
      lse_s[i] = i < q_valid ? lseg[q0 + i] * kLog2e : INFINITY;
      dl_s[i] = i < q_valid ? dlg[q0 + i] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dp^T = v do^T: this warp's 16 keys x kBQ queries
    float s[kBQ / 8][4], dp[kBQ / 8][4];
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < kDP / 16; ++kk) {
      Reg a[4];
      load_a<T>(a, ks, kLd, row0, kk);
      mma_qk<T, kBQ / 8>(s, a, qs, kLd, kk);
      load_a<T>(a, vs, kLd, row0, kk);
      mma_qk<T, kBQ / 8>(dp, a, dos, kLd, kk);
    }
    // p^T = exp(s^T * scale - lse), ds^T = p^T (dp^T - delta) * scale; a
    // lane holds queries j*8 + 2t (+1) of each 8-wide tile
#pragma unroll
    for (int j = 0; j < kBQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + 2 * t + (e & 1);
        const float p = exp2f(s[j][e] * scale_log2 - lse_s[col]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - dl_s[col]) * scale;
      }
    }
    // dv += p^T do and dk += ds^T q, 16 queries at a time
#pragma unroll
    for (int kk = 0; kk < kBQ / 16; ++kk) {
      Reg ap[4], ads[4];
      acc_to_a<T>(ap, s[2 * kk], s[2 * kk + 1]);
      acc_to_a<T>(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        Reg bb[2];
        load_b_rows<T>(bb, dos, kLd, kk, n);
        Op::mma(dv_acc[n], ap, bb);
        load_b_rows<T>(bb, qs, kLd, kk, n);
        Op::mma(dk_acc[n], ads, bb);
      }
    }
  }

  const int key = k0 + row0 + g;
  store_rows<T, D>(dk + b * st.v[18] + h * st.v[19], st.v[20], key, sk, dk_acc);
  store_rows<T, D>(dv + b * st.v[21] + h * st.v[22], st.v[23], key, sk, dv_acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, int heads, int sq, int sk,
          float scale, float scale_log2, Strides st) {
  using C = Cfg<T, D>;
  using Op = Ops<T>;
  using Reg = typename Op::Reg;
  constexpr int kDP = C::kDP, kLd = C::kLd, kBK = C::kBK;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* dos = qs + kBlockM * kLd;
  T* ks = dos + kBlockM * kLd;
  T* vs = ks + kBK * kLd;

  const int q0 = blockIdx.x * kBlockM;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;

  const int q_valid = min(kBlockM, sq - q0);
  load_tile<T, D, kDP>(qs, kLd, q + b * st.v[0] + h * st.v[1] + q0 * st.v[2], int(st.v[2]),
                       q_valid, kBlockM);
  load_tile<T, D, kDP>(dos, kLd, dout + b * st.v[12] + h * st.v[13] + q0 * st.v[14],
                       int(st.v[14]), q_valid, kBlockM);
  const T* kg = k + b * st.v[3] + h * st.v[4];
  const T* vg = v + b * st.v[6] + h * st.v[7];
  const int kss = int(st.v[5]), vss = int(st.v[8]);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + g + 8 * r;
    lse2[r] = row < sq ? lse[size_t(bh) * sq + row] * kLog2e : INFINITY;
    dl[r] = row < sq ? delta[size_t(bh) * sq + row] : 0.f;
  }

  float dq_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) dq_acc[n][0] = dq_acc[n][1] = dq_acc[n][2] = dq_acc[n][3] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kBK) {
    __syncthreads();  // every warp is done with the previous k/v tile
    const int kv_valid = min(kBK, sk - k0);
    load_tile<T, D, kDP>(ks, kLd, kg + size_t(k0) * kss, kss, kv_valid, kBK);
    load_tile<T, D, kDP>(vs, kLd, vg + size_t(k0) * vss, vss, kv_valid, kBK);
    __syncthreads();

    // s = q k^T and dp = do v^T: this warp's 16 rows x kBK keys
    float s[kBK / 8][4], dp[kBK / 8][4];
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
    for (int kk = 0; kk < kDP / 16; ++kk) {
      Reg a[4];
      load_a<T>(a, qs, kLd, row0, kk);
      mma_qk<T, kBK / 8>(s, a, ks, kLd, kk);
      load_a<T>(a, dos, kLd, row0, kk);
      mma_qk<T, kBK / 8>(dp, a, vs, kLd, kk);
    }
    // ds = p (dp - delta) * scale; keys past the end (zero rows of k) get p = 0
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const float p = key < sk ? exp2f(s[j][e] * scale_log2 - lse2[e >> 1]) : 0.f;
        dp[j][e] = p * (dp[j][e] - dl[e >> 1]) * scale;
      }
    }
    // dq += ds k, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      Reg a[4];
      acc_to_a<T>(a, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        Reg bb[2];
        load_b_rows<T>(bb, ks, kLd, kk, n);
        Op::mma(dq_acc[n], a, bb);
      }
    }
  }

  store_rows<T, D>(dq + b * st.v[15] + h * st.v[16], st.v[17], q0 + row0 + g, sq, dq_acc);
}

template <typename T, int D>
int launch(const T* q, const T* k, const T* v, const T* o, const T* dout, const float* lse,
           float* delta, T* dq, T* dk, T* dv, int b, int h, int sq, int sk, float scale,
           const Strides& st, cudaStream_t stream) {
  using C = Cfg<T, D>;
  constexpr auto kv_kernel = dkdv_kernel<T, D>;
  constexpr auto q_kernel = dq_kernel<T, D>;
  if (int err = allow_smem<kv_kernel>(C::kSmemKV)) return err;
  if (int err = allow_smem<q_kernel>(C::kSmemQ)) return err;
  const float scale_log2 = scale * kLog2e;
  delta_kernel<T, D><<<dim3((sq + kWarps - 1) / kWarps, b * h), kThreads, 0, stream>>>(
      o, dout, delta, h, sq, st);
  if (cudaError_t err = cudaGetLastError()) return int(err);
  kv_kernel<<<dim3((sk + kBlockM - 1) / kBlockM, b * h), kThreads, C::kSmemKV, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, h, sq, sk, scale, scale_log2, st);
  if (cudaError_t err = cudaGetLastError()) return int(err);
  q_kernel<<<dim3((sq + kBlockM - 1) / kBlockM, b * h), kThreads, C::kSmemQ, stream>>>(
      q, k, v, dout, lse, delta, dq, h, sq, sk, scale, scale_log2, st);
  return int(cudaGetLastError());
}

// The entry's body for one type: every pointer is (B, H, S, D) of T with
// the strides in `strides` (sb, sh, ss of q, k, v, o, do, dq, dk, dv), but
// lse (B2's) and delta (scratch), contiguous (B, H, Sq) fp32.  Returns a
// cudaError_t; an unbuilt width is cudaErrorInvalidValue.
template <typename T>
int backward(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int h, int sq,
             int sk, int d, float scale, const long long* strides, cudaStream_t s) {
  Strides st;
  for (int i = 0; i < 24; ++i) st.v[i] = strides[i];
  const T *qt = static_cast<const T*>(q), *kt = static_cast<const T*>(k),
          *vt = static_cast<const T*>(v), *ot = static_cast<const T*>(o),
          *dot = static_cast<const T*>(dout);
  T *dqt = static_cast<T*>(dq), *dkt = static_cast<T*>(dk), *dvt = static_cast<T*>(dv);
#define DFT_BWD_CASE(W)                                                                       \
  case W:                                                                                     \
    return launch<T, W>(qt, kt, vt, ot, dot, lse, delta, dqt, dkt, dvt, b, h, sq, sk, scale, \
                        st, s);
  switch (d) {
    DFT_BWD_CASE(40)
    DFT_BWD_CASE(64)
    DFT_BWD_CASE(72)
    DFT_BWD_CASE(80)
    DFT_BWD_CASE(88)
    DFT_BWD_CASE(128)
    DFT_BWD_CASE(160)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef DFT_BWD_CASE
}

}  // namespace bwd
}  // namespace dft

#define DFT_FLASH_BACKWARD_ENTRY(T, CODE)                                                      \
  extern "C" int dft_flash_attention_backward(                                                 \
      const void* q, const void* k, const void* v, const void* o, const void* dout,            \
      const float* lse, float* delta, void* dq, void* dk, void* dv, int b, int h, int sq,      \
      int sk, int d, int dtype, float scale, const long long* strides, void* stream) {         \
    if (dtype != CODE) return int(cudaErrorInvalidValue);                                      \
    return dft::bwd::backward<T>(q, k, v, o, dout, lse, delta, dq, dk, dv, b, h, sq, sk, d,   \
                                 scale, strides, static_cast<cudaStream_t>(stream));           \
  }
