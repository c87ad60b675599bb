// Exact fp32 products for the float32 attention kernels (flash_f32.cu, B1
// and B2; headmean_f32.cu, B3; short_f32.cu, B4; flash_bwd_f32.cu, the
// backward): register-tiled SIMT products read from shared memory, and
// cp.async staging of the tiles.
//
// Why: wgmma has no exact fp32 product (TF32 rounds the inputs to 10
// mantissa bits, and the JAX reference trains in fp32), so these kernels
// run on the FMA pipes, whose H100 peak is 67 TFLOP/s.  An emulation of
// mma.sync's fragment layout in FMAs would move every operand between
// lanes with __shfl_sync, four shuffles for every four FFMA, and shuffles
// issue at a quarter of the FFMA rate.  Here each thread owns a micro-tile
// of the output and reads its operands from shared memory: no shuffle in a
// product, and the micro-tiles are large enough that the bytes read per
// FFMA stay near what shared memory delivers (128 bytes a clock an SM,
// against 128 FFMA): a 16-byte load by a quarter-warp costs a shared-memory
// cycle whether its eight lanes share the address or not, a 4-byte load by
// a whole warp one cycle when its addresses fall on distinct banks or are
// shared.
//
// The thread layout: a block is 16 x TX threads, tx = tid % TX (the fast
// index) and ty = tid / TX, so a quarter-warp (the 8 lanes one 16-byte load
// serves at a time) shares ty when TX >= 8.  The operand a thread takes by
// its ty is one broadcast address per quarter-warp; the operand it takes by
// its tx comes from 8 rows at distinct banks (a tile whose rows a thread
// picks by tx has a leading dimension ld with ld / 4 odd: ld = width + 4
// for a width that is a multiple of 8), or, for its scalar output columns
// tx + CS e (CS = TX), from consecutive banks.
//
// The micro-tiles (tiles row-major in shared memory; a thread passes its
// first row or column):
//   nt<TM, TN, RA, RB, K, U>: c[i][j] += sum_k A[RA i][k] * B[RB j][k]
//     (both operands hold the depth contiguously: q k^T);
//   nnc<TM, kC, CS, K>: c[i][e] += sum_k A[16 i][k] * B[k][CS e], e < kC
//     (A holds the depth contiguously, B the output columns: p v);
//   tnc<kC, CS, K>: c[i][e] += sum_k A[k][i] * B[k][CS e], i < 4
//     (both hold the output contiguously: ds^T read as ds).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace dft {
namespace simt {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; with `valid` false the 16
// bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage `rows` rows of COLS floats (a multiple of 4) from a global tile with
// row stride `stride` into a shared tile with row stride `ld`; rows at or
// past `valid` are zero-filled.  Each of the block's THREADS threads issues
// its share; the caller commits and waits.
template <int THREADS, int COLS>
__device__ __forceinline__ void load_tile_async(float* dst, int ld, const float* src,
                                                long long stride, int valid, int rows) {
  constexpr int kChunks = COLS / 4;
  static_assert(COLS % 4 == 0, "a tile row is whole float4s");
  for (int i = threadIdx.x; i < rows * kChunks; i += THREADS) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    const bool ok = r < valid;
    cp_async16(dst + r * ld + c, ok ? src + r * stride + c : src, ok);
  }
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 2^x on the special-function unit (ex2.approx, ~2 ulp; -inf gives 0):
// the softmax's exponentials, one per score
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float part(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// U: how far the depth loop unrolls (1 where registers are short)
template <int TM, int TN, int RA, int RB, int K, int U = 2>
__device__ __forceinline__ void nt(float (&c)[TM][TN], const float* a, int lda, const float* b,
                                   int ldb) {
  static_assert(K % 4 == 0, "depth is whole float4s");
#pragma unroll U
  for (int k = 0; k < K; k += 4) {
    float4 av[TM], bv[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = lds4(a + i * RA * lda + k);
#pragma unroll
    for (int j = 0; j < TN; ++j) bv[j] = lds4(b + j * RB * ldb + k);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        c[i][j] = fmaf(av[i].x, bv[j].x, c[i][j]);
        c[i][j] = fmaf(av[i].y, bv[j].y, c[i][j]);
        c[i][j] = fmaf(av[i].z, bv[j].z, c[i][j]);
        c[i][j] = fmaf(av[i].w, bv[j].w, c[i][j]);
      }
  }
}

template <int TM, int kC, int CS, int K>
__device__ __forceinline__ void nnc(float (&c)[TM][kC], const float* a, int lda, const float* b,
                                    int ldb) {
  static_assert(K % 4 == 0, "depth is whole float4s");
#pragma unroll 1
  for (int k = 0; k < K; k += 4) {
    float4 av[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) av[i] = lds4(a + i * 16 * lda + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float bv[kC];
#pragma unroll
      for (int e = 0; e < kC; ++e) bv[e] = b[(k + kk) * ldb + CS * e];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int e = 0; e < kC; ++e) c[i][e] = fmaf(part(av[i], kk), bv[e], c[i][e]);
    }
  }
}

template <int kC, int CS, int K>
__device__ __forceinline__ void tnc(float (&c)[4][kC], const float* a, int lda, const float* b,
                                    int ldb) {
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 av = lds4(a + k * lda);
    float bv[kC];
#pragma unroll
    for (int e = 0; e < kC; ++e) bv[e] = b[k * ldb + CS * e];
#pragma unroll
    for (int e = 0; e < kC; ++e) {
      c[0][e] = fmaf(av.x, bv[e], c[0][e]);
      c[1][e] = fmaf(av.y, bv[e], c[1][e]);
      c[2][e] = fmaf(av.z, bv[e], c[2][e]);
      c[3][e] = fmaf(av.w, bv[e], c[3][e]);
    }
  }
}

}  // namespace simt
}  // namespace dft
