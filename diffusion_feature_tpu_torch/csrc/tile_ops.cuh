// Pieces shared by the attention kernels (flash_f32.cu, headmean.cu,
// short_attention.cu, flash_hopper.cuh): the m16n8k16 tensor-core product
// per input type, the tile loader, and the shared-memory limit.
//
// Fragment layout of mma.sync m16n8k16: A(row, k) sits in lane
// 4*(row%8) + (k%8)/2, register 2*(k/8) + row/8; B(k, n) in lane
// 4*n + (k%8)/2, register k/8; a lane's outputs are rows g and g+8,
// columns 2t and 2t+1 (g = lane/4, t = lane%4).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dft {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;  // query rows per block, 16 per warp
constexpr int kPad = 8;               // elements of padding per shared row

// Raise a kernel's dynamic shared-memory limit once per kernel and device,
// so that the launches a CUDA graph captures make no other runtime call.
template <auto kKernel>
inline int allow_smem(size_t bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  if (dev < 64) done[dev] = true;
  return 0;
}

// The QK^T depth, zero-padded to the mma depth of 16 (d=40 -> 48).  Zero
// columns add zero to every score.
constexpr int padded_depth(int d) { return (d + 15) / 16 * 16; }

template <typename T>
struct Ops;

template <>
struct Ops<__nv_bfloat16> {
  using Reg = uint32_t;  // two bf16 values
  static __device__ __forceinline__ Reg load2(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ Reg pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    __nv_bfloat162 v = __halves2bfloat162(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ Reg pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
  static __device__ __forceinline__ void mma(float c[4], const Reg a[4], const Reg b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Ops<__half> {
  using Reg = uint32_t;  // two fp16 values
  static __device__ __forceinline__ Reg load2(const __half* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ Reg pair(__half lo, __half hi) {
    __half2 v = __halves2half2(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ Reg pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ __half from_float(float x) { return __float2half(x); }
  static __device__ __forceinline__ void mma(float c[4], const Reg a[4], const Reg b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Ops<float> {
  using Reg = float2;
  static __device__ __forceinline__ Reg load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ Reg pair(float lo, float hi) { return make_float2(lo, hi); }
  static __device__ __forceinline__ Reg pack(float lo, float hi) { return make_float2(lo, hi); }
  static __device__ __forceinline__ float from_float(float x) { return x; }
  // c += a * b for one 16x8x16 tile in mma.sync's fragment layout, in exact
  // fp32 FMAs (TF32 would round the inputs to 10 mantissa bits).
  static __device__ __forceinline__ void mma(float c[4], const Reg a[4], const Reg b[2]) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int h = k >> 3, sub = (k & 7) >> 1;
      const bool odd = k & 1;
      const float a_lo = __shfl_sync(0xffffffffu, odd ? a[2 * h].y : a[2 * h].x, (g << 2) | sub);
      const float a_hi = __shfl_sync(0xffffffffu, odd ? a[2 * h + 1].y : a[2 * h + 1].x, (g << 2) | sub);
      const float bv = odd ? b[h].y : b[h].x;
      const float b0 = __shfl_sync(0xffffffffu, bv, ((2 * t) << 2) | sub);
      const float b1 = __shfl_sync(0xffffffffu, bv, ((2 * t + 1) << 2) | sub);
      c[0] = fmaf(a_lo, b0, c[0]);
      c[1] = fmaf(a_lo, b1, c[1]);
      c[2] = fmaf(a_hi, b0, c[2]);
      c[3] = fmaf(a_hi, b1, c[3]);
    }
  }
};

// Copy `rows` rows of COLS elements into shared memory with 16-byte vectors,
// zero-filling columns COLS..PCOLS-1 and rows at or past `valid` (the ragged
// edge of the sequence).  COLS and PCOLS are multiples of 16 bytes' worth.
template <typename T, int COLS, int PCOLS = COLS>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, int src_stride,
                                          int valid, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  static_assert(COLS % kVec == 0 && PCOLS % kVec == 0, "tile width not 16-byte aligned");
  constexpr int kChunks = PCOLS / kVec;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    int4 val = make_int4(0, 0, 0, 0);
    if (r < valid && c < COLS) val = *reinterpret_cast<const int4*>(src + size_t(r) * src_stride + c);
    *reinterpret_cast<int4*>(dst + r * ld + c) = val;
  }
}

// A operand (16 rows x 16 depth) of this warp's rows from a shared tile.
template <typename T>
__device__ __forceinline__ void load_a(typename Ops<T>::Reg a[4], const T* tile, int ld,
                                       int row0, int kk) {
  const int lane = threadIdx.x & 31;
  const T* p = tile + (row0 + (lane >> 2)) * ld + kk * 16 + 2 * (lane & 3);
  a[0] = Ops<T>::load2(p);
  a[1] = Ops<T>::load2(p + 8 * ld);
  a[2] = Ops<T>::load2(p + 8);
  a[3] = Ops<T>::load2(p + 8 * ld + 8);
}

// s[j] += A * K^T for the NT 8-key tiles of a shared K tile (keys are rows).
template <typename T, int NT>
__device__ __forceinline__ void mma_qk(float s[][4], const typename Ops<T>::Reg a[4],
                                       const T* ks, int ld, int kk) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const T* kb = ks + (j * 8 + (lane >> 2)) * ld + kk * 16 + 2 * (lane & 3);
    typename Ops<T>::Reg b[2];
    b[0] = Ops<T>::load2(kb);
    b[1] = Ops<T>::load2(kb + 8);
    Ops<T>::mma(s[j], a, b);
  }
}

}  // namespace dft
