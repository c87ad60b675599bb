// W8A16: the int8 weight-only dense product for Hopper (sm_90a),
//
//   y[m, n] = sum_k x[m, k] * deq(q[n, k], s[n]) + b[n]
//
// with x (M, K) contiguous in the compute type T, q (N, K) int8 (K-major:
// PyTorch's (out, in) weight), s (N,) fp32, b (N,) in T or absent, y (M, N)
// contiguous in T, the sum in fp32.  w8a16_bf16.cu, w8a16_fp16.cu and
// w8a16_f32.cu instantiate it, one type each.
//
// It replaces no Pallas kernel: the JAX package's Int8Dense
// (diffusion_feature_tpu/ops/quant.py:38) is an XLA product, and XLA fuses
// its dequantize (convert, times the per-channel scale) into the dot's
// operand pipeline (quant.py:7-9), so no full-precision weight reaches
// memory.  This kernel is that fused product: each int8 tile is
// dequantized in shared memory, never in device memory.
//
// The dequantize is quant.py:59's: q converted exactly (|q| <= 127), times
// the scale rounded to T, the product rounded to T, and, as there, y is
// rounded to T before the bias (in T) is added.  So the kernel and its twin
// (ops/quant.py::int8_linear_reference) differ only in the order of the
// fp32 summation.
//
// What bounds it on an H100: at Flux's M = 8192 to 9216 token rows a call
// does ~2 M K N flops on ~2 M K + N K + 2 M N bytes, hundreds of flops per
// byte, so the tensor cores bound it; at the adaLN projections' M = 2 rows
// it does ~4 flops per weight byte, so the weight bytes bound it (int8
// halves them against bf16).  The design, simple and right before fast:
//
// * bf16/fp16: a block owns 128 rows x 128 columns of y, two warpgroups of
//   64 rows each.  Per 64-deep k step, every thread issues cp.async copies
//   of the next x tile (into the 128-byte swizzle wgmma's descriptors
//   expect) and of the next int8 tile (row-major staging), so the loads of
//   step k+1 run under step k.  The int8 tile of step k is converted in
//   shared memory to T, scaled, into a swizzled B tile; both operands are
//   K-major, so wgmma_ss (m64n128k16, four per step) reads them as B1 reads
//   Q and K.  The M = 2 calls leave most of a 128-row tile empty, but every
//   weight byte is read once (the grid walks N).
// * float32: wgmma has no exact fp32 product, so the fp32 library runs
//   simt_f32.cuh's register-tiled FMA product (16 x 16 threads own a
//   128 x 64 tile in 8 x 4 micro-tiles, float4 operands from shared
//   memory) on the same cp.async staging and conversion.
// * Ragged M, N and K are masked: rows and columns past the edge load as
//   zeros and are never stored; an x whose rows are not 16-byte aligned
//   (K not a multiple of 8, or 4 in fp32) or an int8 tile whose rows are
//   not (K not a multiple of 16) is staged element by element.

#pragma once

#include <type_traits>

#include "hopper_common.cuh"
#include "simt_f32.cuh"

namespace dft {
namespace w8a16 {

using hopper::fence_proxy_async;
using hopper::fence_regs;
using hopper::kAtomBytes;
using hopper::smem_u32;
using hopper::sw128_desc;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;
using simt::cp_async16;
using simt::cp_async_commit;
using simt::cp_async_wait;

template <typename T>
__device__ __forceinline__ T to_t(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 to_t<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half to_t<__half>(float v) {
  return __float2half_rn(v);
}
template <>
__device__ __forceinline__ float to_t<float>(float v) {
  return v;
}
template <typename T>
__device__ __forceinline__ float from_t(T v);
template <>
__device__ __forceinline__ float from_t<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <>
__device__ __forceinline__ float from_t<__half>(__half v) {
  return __half2float(v);
}
template <>
__device__ __forceinline__ float from_t<float>(float v) {
  return v;
}

// y[row, col] from the fp32 sum: rounded to T, then the bias added in T
template <typename T>
__device__ __forceinline__ void store(T* y, const T* bias, int n, int row, int col, float acc) {
  T v = to_t<T>(acc);
  if (bias != nullptr) v = to_t<T>(from_t<T>(v) + from_t<T>(bias[col]));
  y[size_t(row) * n + col] = v;
}

// Stage rows [r0, r0 + rows) of the int8 weight, columns [k0, k0 + kCols),
// into a row-major tile of kCols bytes a row; zeros past N and K.
template <int kThreads, int kCols>
__device__ __forceinline__ void load_q_tile(int8_t* dst, const int8_t* q, int r0, int rows, int k0,
                                            int n, int k, bool vec) {
  constexpr int kChunks = kCols / 16;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks;
    const int row = r0 + r, col = k0 + c * 16;
    int8_t* d = dst + r * kCols + c * 16;
    if (row < n && vec && col + 16 <= k) {
      cp_async16(d, q + size_t(row) * k + col, true);
    } else {
      alignas(16) int8_t v[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) v[e] = row < n && col + e < k ? q[size_t(row) * k + col + e] : 0;
      *reinterpret_cast<int4*>(d) = *reinterpret_cast<const int4*>(v);
    }
  }
}

// ------------------------------------------------------- bf16 / fp16: wgmma
namespace tc {

constexpr int kBM = 128, kBN = 128;
constexpr int kBK = 64;                       // one 128-byte swizzle atom of 16-bit values
constexpr int kThreads = 256;                 // two warpgroups, 64 rows of y each
constexpr int kTileBytes = 128 * kAtomBytes;  // a 128-row x 64-column 16-bit tile: 16 KB
constexpr int kQBytes = kBN * kBK;            // an int8 tile: 8 KB
// x ring (2 stages), the dequantized B tile, the int8 ring, the scales
constexpr size_t kSmem = 1024 + 2 * kTileBytes + kTileBytes + 2 * kQBytes + kBN * 4;

// 16-byte chunk c (0..7) of row r of a swizzled tile
__device__ __forceinline__ int swz(int r, int c) { return r * kAtomBytes + ((c ^ (r & 7)) << 4); }

template <typename T>
__device__ __forceinline__ void load_x_tile(uint8_t* dst, const T* x, int m0, int k0, int m, int k,
                                            bool vec) {
  const uint16_t* xs = reinterpret_cast<const uint16_t*>(x);
  for (int i = threadIdx.x; i < kBM * 8; i += kThreads) {
    const int r = i / 8, c = i % 8;
    const int row = m0 + r, col = k0 + c * 8;
    uint8_t* d = dst + swz(r, c);
    if (row < m && vec && col + 8 <= k) {
      cp_async16(d, xs + size_t(row) * k + col, true);
    } else {
      alignas(16) uint16_t v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = row < m && col + e < k ? xs[size_t(row) * k + col + e] : 0;
      *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// The staged int8 tile of step k -> T, times the rounded scales, into the
// swizzled B tile (row = output column n, 64 k values = 128 bytes)
template <typename T>
__device__ __forceinline__ void convert(uint8_t* bs, const int8_t* qs, const float* sv) {
  for (int i = threadIdx.x; i < kBN * 4; i += kThreads) {
    const int r = i / 4, j = i % 4;
    const int4 raw = *reinterpret_cast<const int4*>(qs + r * kBK + j * 16);
    const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
    const float s = sv[r];
    uint32_t p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      p[e] = hopper::pack2<T>(float(b[2 * e]) * s, float(b[2 * e + 1]) * s);
    *reinterpret_cast<uint4*>(bs + swz(r, 2 * j)) = make_uint4(p[0], p[1], p[2], p[3]);
    *reinterpret_cast<uint4*>(bs + swz(r, 2 * j + 1)) = make_uint4(p[4], p[5], p[6], p[7]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
w8a16_tc(const T* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
         const T* __restrict__ bias, T* __restrict__ y, int m, int n, int k, bool vec_x,
         bool vec_q) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  uint8_t* xs = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  uint8_t* bs = xs + 2 * kTileBytes;
  int8_t* qs = reinterpret_cast<int8_t*>(bs + kTileBytes);
  float* sv = reinterpret_cast<float*>(qs + 2 * kQBytes);

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int n_steps = (k + kBK - 1) / kBK;
  // the scales rounded to T, as the dequantize takes them
  for (int i = threadIdx.x; i < kBN; i += kThreads)
    sv[i] = n0 + i < n ? from_t<T>(to_t<T>(scale[n0 + i])) : 0.f;

  auto load = [&](int step) {
    const int s = step % 2;
    load_x_tile<T>(xs + s * kTileBytes, x, m0, step * kBK, m, k, vec_x);
    load_q_tile<kThreads, kBK>(qs + s * kQBytes, q, n0, kBN, step * kBK, n, k, vec_q);
    cp_async_commit();
  };

  const int wg = threadIdx.x / 128;
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  const uint32_t b_addr = smem_u32(bs);

  load(0);
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      load(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // step's tiles (and the scales) are in for every thread
    convert<T>(bs, qs + (step % 2) * kQBytes, sv);
    fence_proxy_async();   // generic-proxy writes -> wgmma's async-proxy reads
    __syncthreads();
    const uint32_t a_addr = smem_u32(xs + (step % 2) * kTileBytes) + wg * 64 * kAtomBytes;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_ss<T, kBN>(acc, sw128_desc(a_addr + kk * 32, 16, 1024),
                       sw128_desc(b_addr + kk * 32, 16, 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();   // both warpgroups are done with this x stage and B
  }

  // epilogue: thread t of warp w holds rows 16w + t/4 (+8) of its
  // warpgroup's 64, columns 8j + 2(t%4) (+1)
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int row0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = n0 + j * 8 + 2 * (lane % 4);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= m) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e)
        if (col + e < n) store<T>(y, bias, n, row, col + e, acc[j * 4 + 2 * r + e]);
    }
  }
}

}  // namespace tc

// ------------------------------------------------------- float32: FMA tiles
namespace f32 {

constexpr int kTX = 16, kTY = 16, kThreads = kTX * kTY;
constexpr int kTM = 8, kTN = 4;                 // a thread's micro-tile
constexpr int kBM = kTY * kTM, kBN = kTX * kTN;  // 128 x 64
constexpr int kBK = 32;
constexpr int kLd = kBK + 4;                     // ld / 4 odd: conflict-free rows by tx
constexpr size_t kSmem = (2 * kBM + kBN) * kLd * 4 + 2 * kBN * kBK + kBN * 4;

__device__ __forceinline__ void load_x_tile(float* dst, const float* x, int m0, int k0, int m,
                                            int k, bool vec) {
  for (int i = threadIdx.x; i < kBM * (kBK / 4); i += kThreads) {
    const int r = i / (kBK / 4), c = (i % (kBK / 4)) * 4;
    const int row = m0 + r, col = k0 + c;
    float* d = dst + r * kLd + c;
    if (row < m && vec && col + 4 <= k) {
      cp_async16(d, x + size_t(row) * k + col, true);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = row < m && col + e < k ? x[size_t(row) * k + col + e] : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
w8a16_f32(const float* __restrict__ x, const int8_t* __restrict__ q,
          const float* __restrict__ scale, const float* __restrict__ bias, float* __restrict__ y,
          int m, int n, int k, bool vec_x, bool vec_q) {
  extern __shared__ float4 smem_f4[];
  float* xs = reinterpret_cast<float*>(smem_f4);   // 2 stages of kBM x kLd
  float* ws = xs + 2 * kBM * kLd;                    // the dequantized kBN x kLd tile
  float* sv = ws + kBN * kLd;
  int8_t* qs = reinterpret_cast<int8_t*>(sv + kBN);  // 2 stages of kBN x kBK int8

  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int n_steps = (k + kBK - 1) / kBK;
  for (int i = threadIdx.x; i < kBN; i += kThreads) sv[i] = n0 + i < n ? scale[n0 + i] : 0.f;

  auto load = [&](int step) {
    const int s = step % 2;
    load_x_tile(xs + s * kBM * kLd, x, m0, step * kBK, m, k, vec_x);
    load_q_tile<kThreads, kBK>(qs + s * kBN * kBK, q, n0, kBN, step * kBK, n, k, vec_q);
    cp_async_commit();
  };

  float acc[kTM][kTN] = {};
  load(0);
  for (int step = 0; step < n_steps; ++step) {
    if (step + 1 < n_steps) {
      load(step + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    // the int8 tile -> q * s in fp32 (one rounding), 8 values a thread
    const int8_t* qt = qs + (step % 2) * kBN * kBK;
    for (int i = threadIdx.x; i < kBN * kBK / 8; i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const int2 raw = *reinterpret_cast<const int2*>(qt + r * kBK + c);
      const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
      const float s = sv[r];
      float4* d = reinterpret_cast<float4*>(ws + r * kLd + c);
      d[0] = make_float4(float(b[0]) * s, float(b[1]) * s, float(b[2]) * s, float(b[3]) * s);
      d[1] = make_float4(float(b[4]) * s, float(b[5]) * s, float(b[6]) * s, float(b[7]) * s);
    }
    __syncthreads();
    simt::nt<kTM, kTN, kTY, kTX, kBK>(acc, xs + (step % 2) * kBM * kLd + ty * kLd, kLd,
                                      ws + tx * kLd, kLd);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + ty + kTY * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx + kTX * j;
      if (col < n) store<float>(y, bias, n, row, col, acc[i][j]);
    }
  }
}

}  // namespace f32

// The body of each type's C entry point, dft_w8a16_linear(x, q, scale,
// bias, y, m, n, k, dtype, stream), whose contract this is: x (m, k)
// contiguous in T, q (n, k) int8 contiguous, scale (n,) fp32, bias (n,) in
// T or null, y (m, n) contiguous in T, all on the current device.
// Launches on `stream` without synchronising and returns a cudaError_t
// (cudaErrorInvalidValue for an empty or oversized problem).
template <typename T>
int forward(const void* x, const int8_t* q, const float* scale, const void* bias, void* y, int m,
            int n, int k, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || k <= 0) return int(cudaErrorInvalidValue);
  const bool vec_q = k % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  int err;
  if constexpr (std::is_same_v<T, float>) {
    const bool vec_x = k % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const dim3 grid((m + f32::kBM - 1) / f32::kBM, (n + f32::kBN - 1) / f32::kBN);
    if (grid.y > 65535) return int(cudaErrorInvalidValue);
    constexpr auto kernel = f32::w8a16_f32;
    if ((err = allow_smem<kernel>(f32::kSmem))) return err;
    kernel<<<grid, f32::kThreads, f32::kSmem, stream>>>(
        static_cast<const float*>(x), q, scale, static_cast<const float*>(bias),
        static_cast<float*>(y), m, n, k, vec_x, vec_q);
  } else {
    const bool vec_x = k % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const dim3 grid((m + tc::kBM - 1) / tc::kBM, (n + tc::kBN - 1) / tc::kBN);
    if (grid.y > 65535) return int(cudaErrorInvalidValue);
    constexpr auto kernel = tc::w8a16_tc<T>;
    if ((err = allow_smem<kernel>(tc::kSmem))) return err;
    kernel<<<grid, tc::kThreads, tc::kSmem, stream>>>(
        static_cast<const T*>(x), q, scale, static_cast<const T*>(bias), static_cast<T*>(y), m,
        n, k, vec_x, vec_q);
  }
  return int(cudaGetLastError());
}

}  // namespace w8a16
}  // namespace dft
