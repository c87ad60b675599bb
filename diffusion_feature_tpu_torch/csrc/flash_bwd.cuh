// The flash-attention backward: dq, dk and dv of softmax(q k^T * scale) v
// from q, k, v, the forward's output o, the output's gradient do and the
// forward's fp32 logsumexp (B2's), with no (Sq, Sk) tensor in device
// memory.  This header holds what the types share: the contract, the
// delta pre-pass and the C entry point; each type's source holds the main
// pass (flash_bwd_hopper.cuh for bf16 and fp16, flash_bwd_f32.cu for fp32).
//
// Replaces the JAX package's flash backward, which is no Pallas kernel: the
// custom VJP ``_flash_diff_bwd`` (diffusion_feature_tpu/ops/flash_attention.py
// :212), XLA's einsum-softmax VJP below sq*sk = 8192^2 and the q-chunked
// ``_chunked_attention_bwd`` (:170) at or above it.  Both recompute the
// probabilities from q and k; so does this kernel, from the saved logsumexp
// instead of a second softmax.
//
// One score pass.  delta = rowsum(do * o) comes first (a pre-pass, one
// warp per query row); then one block per key tile of one (b, h) keeps
// that tile's dk and dv in registers and walks every query tile:
//   s^T = k q^T and dp^T = v do^T,
//   p^T = exp(s^T * scale - lse), ds^T = p^T (dp^T - delta) * scale,
//   dv += p^T do, dk += ds^T q, and dq += ds k,
// the last added into an fp32 accumulator across the key blocks.  Five
// products (10 B H Sq Sk D flops), the least this function needs; they
// bound it by operations on an H100 at every width of the U-Nets.
//
// dq is summed by the key blocks in whatever order they reach it (bulk
// reduce-adds of fp32 tiles for bf16/fp16, fp32 atomics for float32), so
// dq is not bitwise repeatable from run to run, as SDPA's backward is not;
// dk and dv are (each is one block's registers).  Two calls agree within
// fp32 rounding of the sum's order.
//
// Head widths 40, 64, 72, 80, 88, 128 and 160 (B2's).  Inputs are
// (B, H, S, D) with element strides (sb, sh, ss) and unit stride along d,
// as the forward takes them; so are the outputs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "tile_ops.cuh"

namespace dft {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

namespace bwd {

constexpr float kLog2e = 1.4426950408889634f;

// Element strides (sb, sh, ss) of q, k, v, o, do, dq, dk and dv, in order.
struct Strides {
  long long v[24];
};

// One call's operands.  dq_acc: a zeroed fp32 accumulator the 16-bit
// kernels add dq into before converting it (null for float32, which adds
// into dq itself, zeroed by the caller).
template <typename T>
struct Args {
  const T *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  float* dq_acc;
  T *dq, *dk, *dv;
  int b, h, sq, sk;
  float scale;
  Strides st;
};

// The main pass for one type and width; each type's source defines it.
template <typename T, int D>
int launch(const Args<T>& a, cudaStream_t stream);

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

template <typename T, int D>
int launch_delta(const Args<T>& a, cudaStream_t stream) {
  delta_kernel<T, D><<<dim3((a.sq + kWarps - 1) / kWarps, a.b * a.h), kThreads, 0, stream>>>(
      a.o, a.dout, a.delta, a.h, a.sq, a.st);
  return int(cudaGetLastError());
}

// The entry's body for one type: every pointer is (B, H, S, D) of T with
// the strides in `strides` (sb, sh, ss of q, k, v, o, do, dq, dk, dv), but
// lse (B2's) and delta (scratch), contiguous (B, H, Sq) fp32, and dq_acc,
// a zeroed contiguous (B, H, Sq, D) fp32 scratch for bf16 and fp16 (null
// for float32, whose dq the caller zeroes).  Returns a cudaError_t; an
// unbuilt width is cudaErrorInvalidValue.
template <typename T>
int backward(const void* q, const void* k, const void* v, const void* o, const void* dout,
             const float* lse, float* delta, float* dq_acc, void* dq, void* dk, void* dv, int b,
             int h, int sq, int sk, int d, float scale, const long long* strides,
             cudaStream_t s) {
  Args<T> a{static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
            static_cast<const T*>(o), static_cast<const T*>(dout), lse, delta, dq_acc,
            static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv), b, h, sq, sk, scale,
            {}};
  for (int i = 0; i < 24; ++i) a.st.v[i] = strides[i];
#define DFT_BWD_CASE(W) \
  case W:               \
    return launch<T, W>(a, s);
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
      const float* lse, float* delta, float* dq_acc, void* dq, void* dk, void* dv, int b,      \
      int h, int sq, int sk, int d, int dtype, float scale, const long long* strides,          \
      void* stream) {                                                                          \
    if (dtype != CODE) return int(cudaErrorInvalidValue);                                      \
    return dft::bwd::backward<T>(q, k, v, o, dout, lse, delta, dq_acc, dq, dk, dv, b, h, sq,   \
                                 sk, d, scale, strides, static_cast<cudaStream_t>(stream));    \
  }
