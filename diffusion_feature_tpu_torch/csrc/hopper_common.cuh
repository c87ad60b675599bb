// What the Hopper (sm_90a) kernels share: B1/B2 in flash_hopper.cuh, B3 in
// headmean_hopper.cuh, B4 in short_hopper.cuh, the backward in
// flash_bwd_hopper.cuh, W8A16 in w8a16.cuh.
//
//   device: mbarrier init / expect-tx / arrive / wait (a lost arrival traps
//     instead of hanging the card), 4-d and 2-d TMA box loads counted into
//     an mbarrier (4-d also multicast to a cluster), arrivals on another
//     CTA's mbarrier, the cluster barrier, 3-d TMA box stores in bulk
//     groups, wgmma fence / commit /
//     wait, the 128-byte-swizzle matrix descriptor, bf16/fp16 packing, exp2
//     on the special-function unit and named barriers;
//   host: cuTensorMapEncodeTiled from the driver the runtime already loaded
//     (no -lcuda), and the 4-d (d, s, h, b) tensor map over a (B, H, S, D)
//     tensor with the caller's strides, read in 64-column boxes (one
//     128-byte swizzle atom) and zero-filled out of bounds; the 2-d map of
//     a row-major byte matrix (W8A16's int8 weight).
// The shared-memory limit and SM count helpers (allow_smem, sm_count) are
// tile_ops.cuh's.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tile_ops.cuh"
#include "wgmma.cuh"

namespace dft {
namespace hopper {

constexpr int kAtom = 64;          // columns of one 128-byte swizzle atom
constexpr int kAtomBytes = 128;    // bytes of one atom row
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The barrier helpers and TMA loads take a pointer into shared memory or
// its 32-bit shared-state-space address (one register instead of a 64-bit
// generic pointer: a producer thread on setmaxnreg's 24 registers keeps
// its ring's addresses so).
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  mbar_expect_tx(smem_u32(bar), bytes);
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait of more
// than ~2^34 cycles (seconds; a tile arrives in microseconds) means a lost
// arrival: trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t addr, uint32_t parity) {
  const long long start = clock64();
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && clock64() - start > (1ll << 34)) __trap();
  } while (!done);
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  mbar_wait(smem_u32(bar), parity);
}

// One box of a 4-d tensor map (coordinates d, s, h, b) into shared memory;
// the bytes are counted into `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  tma_load(smem_u32(dst), map, smem_u32(bar), c0, c1, c2, c3);
}

// The same box into the shared memory of every CTA of the cluster in
// `mask`, at this CTA's offset of `dst`; each destination's mbarrier at
// the offset of `bar` counts the bytes it receives.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst, const CUtensorMap* map,
                                                   uint32_t bar, int c0, int c1, int c2, int c3,
                                                   uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%3, %4, %5, %6}], [%2], %7;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "h"(mask)
      : "memory");
}
__device__ __forceinline__ void tma_load_multicast(void* dst, const CUtensorMap* map,
                                                   uint64_t* bar, int c0, int c1, int c2, int c3,
                                                   uint16_t mask) {
  tma_load_multicast(smem_u32(dst), map, smem_u32(bar), c0, c1, c2, c3, mask);
}

// An arrival on the mbarrier at the offset of `bar` in CTA `cta` of the
// cluster (this one included).
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t cta) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(smem_u32(bar)), "r"(cta));
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(remote) : "memory");
}

// Every thread of every CTA of the cluster meets here.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// One box of a 2-d tensor map (coordinates column, row) into shared
// memory; the bytes are counted into `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// One box of a 3-d tensor map from shared memory to global memory, in the
// thread's bulk group; elements past the tensor's bounds are not written.
// The writes to the box must be made visible to the async proxy first
// (fence_proxy_async, then a barrier).
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of the thread's committed bulk groups still read shared
// memory (kRead) or are still in flight at all
template <int N, bool kRead>
__device__ __forceinline__ void bulk_wait() {
  if constexpr (kRead)
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
  else
    asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle.  K-major (rows hold the
// depth): sbo = 1024 (8 rows of 128 bytes), lbo unused.  MN-major: lbo =
// bytes from one 64-column atom to the next, sbo = 1024 (8 rows).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (uint64_t(1) << 62);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The two halves of a pack2 back in fp32.
template <typename T>
__device__ __forceinline__ float2 unpack2(uint32_t v);
template <>
__device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}
template <>
__device__ __forceinline__ float2 unpack2<__half>(uint32_t v) {
  return __half22float2(*reinterpret_cast<__half2*>(&v));
}

// 2^x on the special-function unit (ex2.approx, ~2 ulp; -inf gives 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
// An arrival on named barrier `id` that does not wait for it to complete.
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// This CTA's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Output rows written straight from the accumulators (B1, B2, B4): a lane's
// two columns as one 4-byte store, rows past Sq skipped.
struct OutPtr {
  void* o;
  float* lse;             // (bh, sq) fp32, or null
  long long sb, sh, ss;   // the output's strides in elements
};

// ------------------------------------------------------------ host side
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links no -lcuda.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    return q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

template <typename T>
struct MapType;
template <>
struct MapType<__nv_bfloat16> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct MapType<__half> {
  static constexpr CUtensorMapDataType value = CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
};

// A (b, h, s, d) tensor with strides (sb, sh, ss, 1) in elements, as a 4-d
// map read in boxes of 64 columns x `rows` rows, 128-byte swizzle,
// zero-filled out of bounds.
template <typename T>
inline int make_map(CUtensorMap* map, const void* ptr, int b, int h, int s, int d,
                    const long long* strides, int rows) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return int(cudaErrorNotSupported);
  const CUtensorMapDataType type = MapType<T>::value;
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(s), cuuint64_t(h), cuuint64_t(b)};
  const cuuint64_t bytes[3] = {cuuint64_t(strides[2]) * sizeof(T),
                               cuuint64_t(strides[1]) * sizeof(T),
                               cuuint64_t(strides[0]) * sizeof(T)};
  const cuuint32_t box[4] = {cuuint32_t(kAtom), cuuint32_t(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult res = enc(map, type, 4, const_cast<void*>(ptr), dims, bytes, box, unit,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

// A row-major (rows, cols) byte matrix whose rows are `row_bytes` apart (a
// multiple of 16), as a 2-d map of unsigned bytes read in boxes of
// `box_cols` bytes x `box_rows` rows with `swizzle` (the box's rows must
// not be wider than the swizzle's span), zero-filled out of bounds.
inline int make_map_u8(CUtensorMap* map, const void* ptr, int rows, int cols, long long row_bytes,
                       int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return int(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t bytes[1] = {cuuint64_t(row_bytes)};
  const cuuint32_t box[2] = {cuuint32_t(box_cols), cuuint32_t(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult res = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(ptr), dims,
                           bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

}  // namespace hopper
}  // namespace dft
