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
// memory.  These kernels are that fused product: each int8 tile is
// dequantized in shared memory or in registers, never in device memory.
//
// The dequantize is quant.py:59's: q converted exactly (|q| <= 127), times
// the scale rounded to T, the product rounded to T, and, as there, y is
// rounded to T before the bias (in T) is added.  So a kernel and its twin
// (ops/quant.py::int8_linear_reference) differ only in the order of the
// fp32 summation.
//
// What bounds it on an H100: at Flux's M = 8192 to 9216 token rows a call
// does ~2 M K N flops on ~2 M K + N K + 2 M N bytes, hundreds of flops per
// byte, so the tensor cores bound it; at the adaLN projections' M = 2 rows
// it does ~4 flops per weight byte, so the weight bytes bound it (int8
// halves them against bf16).  bf16/fp16 therefore have two kernels, and
// the caller picks one per call (ops/quant.py::int8_route, the `route`
// argument of the entry point):
//
// * tma (routes 1 and 2), for more rows than the streaming kernel takes: a
//   warp-specialised block of two consumer warpgroups (setmaxnreg.inc) and
//   a producer warpgroup (setmaxnreg.dec) computes y^T = deq(q) x^T for 128
//   output columns by BM rows of x (BM = 128 or 256, the wgmma's N).  One
//   thread of the producer issues TMA loads of each 64-deep step's x tile
//   (64 columns x BM rows, 128-byte swizzle, as B1 loads K) and int8 tile
//   (64 bytes x 128 rows, 64-byte swizzle) into a ring of kStages slots
//   with full and empty mbarriers.  The two CTAs of a cluster own
//   neighbouring column tiles of the same rows and share the x tile: each
//   loads half of it and multicasts it to both, so L2 delivers 40% fewer
//   bytes a product, and a slot is free once both CTAs' consumers release
//   it.  Each consumer warpgroup owns 64 output columns: it reads its int8
//   rows from the ring straight into registers in wgmma's A-fragment
//   layout (two 4-byte words a row and 16-deep slice, at distinct banks),
//   dequantizes them there, and issues wgmma_rs_k with the x tile as B,
//   one slice at a time: slice i + 1's fragments are dequantized into a
//   second register set while slice i's product runs (wgmma_wait<1> frees
//   the set slice i - 1 read), so the warpgroups share no barrier until
//   the epilogue, which rounds y^T into a row-major staging tile over the
//   ring and writes y in 16-byte rows.  A 1-d grid walks the output tiles
//   in groups of kGroup row tiles, so that the clusters in flight share
//   their x and int8 tiles in L2.  (Why registers and not a dequantized
//   shared-memory B tile for wgmma_ss, and why multicast: PERF.md, §6.)
// * streaming (route 3), for M <= streaming::kMaxRows: a block of four
//   warps owns 16 weight rows (output columns) and splits K between its
//   warps.  Each thread streams 16 bytes of two weight rows per 64-deep
//   chunk with 16-byte loads (kUnroll chunks in flight), dequantizes them
//   in registers, and multiplies them on the tensor cores with mma.sync
//   m16n8k16 (the weight as A, x's rows as the n8 columns, read through
//   L1): the depth is permuted within each chunk the same way for both
//   operands (a thread's four k slots of the A and B fragments are its
//   four consecutive bytes), so a thread's 16 contiguous bytes feed four
//   mmas with no exchange.  The warps' partial sums meet in shared memory.
// * staged (route 0), the first design, kept for the rows TMA cannot
//   describe (K not a multiple of 16, or a base not 16-byte aligned): one
//   block of two warpgroups stages both tiles with cp.async, converts, and
//   waits for its wgmmas each step.
// * float32: wgmma has no exact fp32 product, so the fp32 library runs
//   simt_f32.cuh's register-tiled FMA product (16 x 16 threads own a
//   128 x 64 tile in 8 x 4 micro-tiles, float4 operands from shared
//   memory) on the staged kernel's cp.async staging and conversion.
//
// The conversion (Deq): bf16: 2^23 + (q + 128) built in fp32 bits, one FMA
// with the rounded scale s and -(2^23 + 128) s (exact: s has 8 significant
// bits) gives q s exactly, one cvt rounds it to bf16; fp16: 1024 + (q + 128)
// built in fp16 bits, minus 1152 (exact), times s in one rounding (hmul2).
// Either way round_T(q * round_T(s)), bit for bit the twin's weight.

#pragma once

#include <type_traits>

#include "hopper_common.cuh"
#include "simt_f32.cuh"

namespace dft {
namespace w8a16 {

using hopper::fence_proxy_async;
using hopper::fence_regs;
using hopper::kAtomBytes;
using hopper::mbar_arrive;
using hopper::mbar_expect_tx;
using hopper::mbar_init;
using hopper::mbar_wait;
using hopper::named_sync;
using hopper::smem_u32;
using hopper::sw128_desc;
using hopper::wgmma_commit;
using hopper::wgmma_fence;
using hopper::wgmma_wait;
using simt::cp_async16;
using simt::cp_async_commit;
using simt::cp_async_wait;

// the kernels of the entry point's `route` (ops/quant.py's ROUTES)
enum Route { kStaged = 0, kTma128 = 1, kTma256 = 2, kStream = 3 };

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
__device__ __forceinline__ T out_value(const T* bias, int col, float acc) {
  T v = to_t<T>(acc);
  if (bias != nullptr) v = to_t<T>(from_t<T>(v) + from_t<T>(bias[col]));
  return v;
}
// two values of T as one 4-byte word, the first in the low half
template <typename T>
__device__ __forceinline__ uint32_t bits2(T lo, T hi) {
  return uint32_t(*reinterpret_cast<const uint16_t*>(&lo)) |
         (uint32_t(*reinterpret_cast<const uint16_t*>(&hi)) << 16);
}
template <typename T>
__device__ __forceinline__ void store(T* y, const T* bias, int n, int row, int col, float acc) {
  y[size_t(row) * n + col] = out_value<T>(bias, col, acc);
}

// Four int8 weights (the bytes of w, low first) of one output column ->
// two packed pairs of T (bytes 0, 1 and 2, 3), each round_T(q * s_T).
template <typename T>
struct Deq;
template <>
struct Deq<__nv_bfloat16> {
  float s, c;   // the scale rounded to bf16, and (2^23 + 128) s, exact in fp32
  __device__ explicit Deq(float scale)
      : s(__bfloat162float(__float2bfloat16_rn(scale))), c(8388736.f * s) {}
  __device__ __forceinline__ uint2 operator()(uint32_t w) const {
    const uint32_t u = w ^ 0x80808080u;   // q + 128 as unsigned bytes
    // the fp32 2^23 + (q + 128), times s, minus c: q s, exactly
    const float f0 = fmaf(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)), s, -c);
    const float f1 = fmaf(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)), s, -c);
    const float f2 = fmaf(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)), s, -c);
    const float f3 = fmaf(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)), s, -c);
    __nv_bfloat162 lo = __floats2bfloat162_rn(f0, f1), hi = __floats2bfloat162_rn(f2, f3);
    return make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
  }
};
template <>
struct Deq<__half> {
  __half2 s;    // the scale rounded to fp16, twice
  __device__ explicit Deq(float scale) : s(__float2half2_rn(scale)) {}
  __device__ __forceinline__ uint2 operator()(uint32_t w) const {
    const uint32_t u = w ^ 0x80808080u;   // q + 128 as unsigned bytes
    // the fp16 1024 + (q + 128), minus 1152: q, exactly; then times s
    const __half2 k = __float2half2_rn(1152.f);
    uint32_t lo_bits = __byte_perm(u, 0x64646464u, 0x4140);
    uint32_t hi_bits = __byte_perm(u, 0x64646464u, 0x4342);
    __half2 lo = __hmul2(__hsub2(*reinterpret_cast<__half2*>(&lo_bits), k), s);
    __half2 hi = __hmul2(__hsub2(*reinterpret_cast<__half2*>(&hi_bits), k), s);
    return make_uint2(*reinterpret_cast<uint32_t*>(&lo), *reinterpret_cast<uint32_t*>(&hi));
  }
};

// ------------------------------------------- bf16 / fp16: the TMA kernel (tma)
namespace tma {

constexpr int kBN = 128;                      // output columns: two consumer warpgroups of 64
constexpr int kBK = 64;                       // one 128-byte swizzle atom of 16-bit x
constexpr int kThreads = 384;                 // two consumer warpgroups and the producer's
constexpr int kGroup = 8;                     // row tiles walked together (L2 reuse)
constexpr int kCluster = 2;                   // column tiles that share each x tile
constexpr int kOutLd = kBN * 2 + 16;          // the epilogue's staging row, bytes

template <int BM>
struct Cfg {
  static constexpr uint32_t kXBytes = BM * kAtomBytes;    // BM rows of 64 T
  static constexpr uint32_t kQBytes = kBN * kBK;          // 128 rows of 64 int8
  static constexpr int kStages = BM == 256 ? 5 : 8;       // what fits 227 KB
  static constexpr uint32_t kStageBytes = kXBytes + kQBytes;
  static constexpr size_t kSmem = 1024 + kStages * size_t(kStageBytes) + 2 * kStages * 8;
  static_assert(BM * kOutLd <= kStages * kXBytes, "the staged output fits the x ring");
};

// y^T = deq(q) x^T for one tile: BM rows of x (the wgmma's N) by 128
// output columns (its M: 64 a consumer warpgroup).
template <typename T, int BM>
__global__ void __launch_bounds__(kThreads, 1)
w8a16_tma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
          const float* __restrict__ scale, const T* __restrict__ bias, T* __restrict__ y, int m,
          int n, int k) {
  using C = Cfg<BM>;
  constexpr int S = C::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  uint8_t* xs = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  uint8_t* qs = xs + S * C::kXBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(qs + S * C::kQBytes);
  uint64_t* empty = full + S;

  // the output tile: a cluster of kCluster CTAs (rank = blockIdx.x %
  // kCluster) owns one row tile and kCluster neighbouring column tiles;
  // clusters walk kGroup row tiles at a time, columns within a group
  const int rank = blockIdx.x % kCluster, cluster = blockIdx.x / kCluster;
  const int tiles_m = (m + BM - 1) / BM;
  const int pairs_n = ((n + kBN - 1) / kBN + kCluster - 1) / kCluster;
  const int per_group = kGroup * pairs_n;
  const int first = (cluster / per_group) * kGroup, in_group = cluster % per_group;
  const int group_rows = tiles_m - first < kGroup ? tiles_m - first : kGroup;
  const int m0 = (first + in_group % group_rows) * BM;
  const int n0 = ((in_group / group_rows) * kCluster + rank) * kBN;
  const int n_steps = (k + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    // the producer's arrival (with the bytes) fills a slot, one arrival per
    // consumer warp of every CTA of the cluster empties it (each CTA's
    // producer writes its part of the x tile into all of them)
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8 * kCluster);
    }
    hopper::mbar_fence_init();
  }
  hopper::cluster_sync();   // the cluster's barriers are initialised

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(hopper::kProducerRegs));
    if (threadIdx.x == 256) {
      hopper::prefetch_map(&xmap);
      hopper::prefetch_map(&qmap);
      for (int j = 0; j < n_steps; ++j) {
        const int s = j % S;
        mbar_wait(&empty[s], ((j / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], C::kStageBytes);
        // this CTA's BM / kCluster rows of the x tile, to every CTA
        hopper::tma_load_multicast(xs + s * C::kXBytes + rank * (BM / kCluster) * kAtomBytes,
                                   &xmap, &full[s], j * kBK, m0 + rank * (BM / kCluster), 0, 0,
                                   (1u << kCluster) - 1);
        hopper::tma_load_2d(qs + s * C::kQBytes, &qmap, &full[s], j * kBK, n0);
      }
    }
  } else {
    // ---- consumer warpgroup c: output columns n0 + 64c .. n0 + 64c + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(hopper::kConsumerRegs));
    const int c = wg, tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    // the weight rows of this thread's A fragments, in the int8 tile
    const int r0 = c * 64 + warp * 16 + g, r1 = r0 + 8;
    const Deq<T> d0(n0 + r0 < n ? scale[n0 + r0] : 0.f), d1(n0 + r1 < n ? scale[n0 + r1] : 0.f);
    // bytes 2t, 2t + 1 of a 16-byte chunk's low half and of its high half
    const uint32_t sel = t & 1 ? 0x7632u : 0x5410u;

    // the A fragment (64 x 16 of the weight) of step j's 16-deep slice kk
    // from its int8 tile: per row, the two 4-byte words that hold the
    // thread's k slots 2t, 2t + 1, 2t + 8, 2t + 9 (a warp's loads fall on
    // distinct banks through the 64-byte swizzle), dequantized in registers
    auto load_a = [&](uint32_t (&a)[4], int j, int kk) {
      const int s = j % S;
      if (kk == 0) mbar_wait(&full[s], (j / S) & 1);
      const uint8_t* qt = qs + s * C::kQBytes + (t >> 1) * 4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = h ? r1 : r0;
        const uint8_t* chunk = qt + r * kBK + ((kk ^ ((r >> 1) & 3)) << 4);
        const uint32_t lo = *reinterpret_cast<const uint32_t*>(chunk);
        const uint32_t hi = *reinterpret_cast<const uint32_t*>(chunk + 8);
        const uint2 p = (h ? d1 : d0)(__byte_perm(lo, hi, sel));
        a[h] = p.x;       // row g (+8), k 2t, 2t + 1
        a[2 + h] = p.y;   // row g (+8), k 2t + 8, 2t + 9
      }
    };

    float acc[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) acc[i] = 0.f;
    const uint32_t x_base = smem_u32(xs);
    // one product of a slice, in a commit group of its own
    auto issue = [&](const uint32_t (&a)[4], int j, int kk) {
      fence_regs(acc);
      wgmma_fence();
      wgmma_rs_k<T, BM>(acc, a, sw128_desc(x_base + (j % S) * C::kXBytes + kk * 32, 16, 1024),
                        1);
      wgmma_commit();
    };
    auto release = [&](int j) {   // step j's products are done with its slot
      __syncwarp();
      if (lane < kCluster) hopper::mbar_arrive_cluster(&empty[j % S], lane);
    };

    // two sets of A fragments: the next slice's are dequantized while this
    // slice's product runs, into the set the previous one (waited for)
    // read.  Slice by slice, not step by step: 128 accumulators and two
    // sets of a whole step's fragments exceed the 168 registers ptxas
    // gives a thread of a 384-thread block (setmaxnreg raises the limit at
    // run time only), and it spilled and serialized the wgmmas.  (Two
    // slices in flight, wgmma_wait<2> over four sets, ran slower.)
    uint32_t a[2][4];
    load_a(a[0], 0, 0);
    for (int j = 0; j < n_steps; ++j) {
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        issue(a[kk & 1], j, kk);
        wgmma_wait<1>();
        if (kk == 0 && j > 0) release(j - 1);
        if (kk + 1 < kBK / 16)
          load_a(a[(kk + 1) & 1], j, kk + 1);
        else if (j + 1 < n_steps)
          load_a(a[0], j + 1, 0);
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // epilogue: the accumulators hold y^T (thread t of warp w: output
    // columns 16w + t/4 (+8) of its warpgroup's 64, rows 8j + 2(t%4) (+1));
    // rounded and biased into a row-major staging tile over the x ring
    // (rows kOutLd bytes apart: a warp's 2-byte stores fall on distinct
    // banks), then copied out in 16-byte rows
    named_sync(1, 256);   // both warpgroups are done with the ring
    uint8_t* st = xs;
#pragma unroll
    for (int jj = 0; jj < BM / 8; ++jj) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = e < 2 ? r0 : r1, row = jj * 8 + 2 * t + (e & 1);
        const T v = n0 + col < n ? out_value<T>(bias, n0 + col, acc[jj * 4 + e]) : to_t<T>(0.f);
        *reinterpret_cast<T*>(st + row * kOutLd + col * 2) = v;
      }
    }
    named_sync(1, 256);
    const bool vec = n % 8 == 0;
    for (int i = threadIdx.x; i < BM * (kBN / 8); i += 256) {
      const int row = i / (kBN / 8), ch = i % (kBN / 8);
      const int gm = m0 + row, gn = n0 + ch * 8;
      if (gm >= m || gn >= n) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(st + row * kOutLd + ch * 16);
      T* dst = y + size_t(gm) * n + gn;
      if (vec && gn + 8 <= n) {
        *reinterpret_cast<uint4*>(dst) = v;
      } else {
        const T* e = reinterpret_cast<const T*>(&v);
        for (int i8 = 0; i8 < 8 && gn + i8 < n; ++i8) dst[i8] = e[i8];
      }
    }
  }
  // no CTA leaves while another may still arrive on its barriers
  hopper::cluster_sync();
}

// x as a (1, 1, M, K) map in 64-column x BM / kCluster-row boxes
// (hopper::make_map), q as a 2-d (N, K) byte map in 64-byte x 128-row
// boxes, both encoded per call and passed by value (so CUDA graphs capture
// them); clusters of kCluster CTAs along the grid
template <typename T, int BM>
int launch(const void* x, const int8_t* q, const float* scale, const void* bias, void* y, int m,
           int n, int k, cudaStream_t stream) {
  const long long pairs_n = ((n + kBN - 1) / kBN + kCluster - 1) / kCluster;
  const long long blocks = (long long)((m + BM - 1) / BM) * pairs_n * kCluster;
  if (blocks > 2147483647ll) return int(cudaErrorInvalidValue);
  CUtensorMap xmap, qmap;
  const long long strides[3] = {(long long)m * k, (long long)m * k, k};
  int err = hopper::make_map<T>(&xmap, x, 1, 1, m, k, strides, BM / kCluster);
  if (err) return err;
  err = hopper::make_map_u8(&qmap, q, n, k, k, kBK, kBN, CU_TENSOR_MAP_SWIZZLE_64B);
  if (err) return err;
  constexpr auto kernel = w8a16_tma<T, BM>;
  if ((err = allow_smem<kernel>(Cfg<BM>::kSmem))) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(blocks));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<BM>::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = int(cudaLaunchKernelEx(&cfg, kernel, xmap, qmap, scale, static_cast<const T*>(bias),
                               static_cast<T*>(y), m, n, k));
  if (err) return err;
  return int(cudaGetLastError());
}

}  // namespace tma

// ------------------------------------ bf16 / fp16: few rows (streaming)
namespace streaming {

constexpr int kRows = 16;       // weight rows (output columns) a block owns: one m16 tile
constexpr int kWarps = 4;       // the block's warps split K
constexpr int kThreads = 32 * kWarps;
constexpr int kUnroll = 4;      // 64-deep chunks a warp keeps in flight
constexpr int kMaxRows = 16;    // x rows: one or two n8 tiles

// 16 bytes of the weight, read once: not kept in L1 (volatile, so that it
// is never issued where its guard is false)
__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// d += A (16 x 16) B (16 x 8), fp32 sums
template <typename T>
__device__ __forceinline__ void mma(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                    uint32_t a3, uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  else
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// NT n8 tiles of x rows (M <= 8 NT).  Lane (g, t) = (lane / 4, lane % 4)
// holds weight rows n0 + g and n0 + g + 8 and x row 8 nt + g, bytes (or
// values) 64 ch + 16 t .. + 15 of each chunk ch; mma j of the chunk takes
// its values 4j .. 4j + 3 as the k slots 2t, 2t + 1, 2t + 8, 2t + 9 of
// both fragments, so every k meets its own x value.
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
w8a16_stream(const T* __restrict__ x, const int8_t* __restrict__ q,
             const float* __restrict__ scale, const T* __restrict__ bias, T* __restrict__ y,
             int m, int n, int k) {
  __shared__ float part[kWarps][NT][4][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int n0 = blockIdx.x * kRows;
  const int r0 = n0 + g, r1 = n0 + g + 8;
  const Deq<T> d0(r0 < n ? scale[r0] : 0.f), d1(r1 < n ? scale[r1] : 0.f);
  const int chunks = (k + 63) / 64;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

  for (int base = 0; base < chunks; base += kWarps * kUnroll) {
    uint4 w0[kUnroll], w1[kUnroll], xv[kUnroll][NT][2];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int ch = base + u * kWarps + warp;
      const int kk = ch * 64 + t * 16;
      const bool in = ch < chunks && kk < k;   // K % 16 == 0: a granule is whole
      w0[u] = in && r0 < n ? ld_stream(q + size_t(r0) * k + kk) : zero;
      w1[u] = in && r1 < n ? ld_stream(q + size_t(r1) * k + kk) : zero;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int row = nt * 8 + g;
        const uint4* xp = reinterpret_cast<const uint4*>(x + size_t(row) * k + kk);
        xv[u][nt][0] = in && row < m ? __ldg(xp) : zero;
        xv[u][nt][1] = in && row < m ? __ldg(xp + 1) : zero;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint2 a_lo = d0(word(w0[u], j)), a_hi = d1(word(w1[u], j));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma<T>(acc[nt], a_lo.x, a_hi.x, a_lo.y, a_hi.y, word(xv[u][nt][j / 2], (2 * j) % 4),
                 word(xv[u][nt][j / 2], (2 * j) % 4 + 1));
      }
    }
  }

  // the warps' partial sums; d[0], d[1]: weight row g, x rows 2t, 2t + 1;
  // d[2], d[3]: weight row g + 8
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[warp][nt][e][lane] = acc[nt][e];
  __syncthreads();
  if (warp != 0) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) v += part[w][nt][e][lane];
      const int row = nt * 8 + 2 * t + (e & 1), col = e < 2 ? r0 : r1;
      if (row < m && col < n) store<T>(y, bias, n, row, col, v);
    }
  }
}

template <typename T>
int launch(const void* x, const int8_t* q, const float* scale, const void* bias, void* y, int m,
           int n, int k, cudaStream_t stream) {
  if (m > kMaxRows) return int(cudaErrorInvalidValue);
  const unsigned blocks = unsigned((n + kRows - 1) / kRows);
  const T* xt = static_cast<const T*>(x);
  const T* bt = static_cast<const T*>(bias);
  if (m <= 8)
    w8a16_stream<T, 1><<<blocks, kThreads, 0, stream>>>(xt, q, scale, bt, static_cast<T*>(y), m,
                                                        n, k);
  else
    w8a16_stream<T, 2><<<blocks, kThreads, 0, stream>>>(xt, q, scale, bt, static_cast<T*>(y), m,
                                                        n, k);
  return int(cudaGetLastError());
}

}  // namespace streaming

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

// ------------------------------------------- bf16 / fp16: any shape (staged)
namespace staged {

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
w8a16_staged(const T* __restrict__ x, const int8_t* __restrict__ q, const float* __restrict__ scale,
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

}  // namespace staged

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
// bias, y, m, n, k, dtype, route, stream), whose contract this is: x (m, k)
// contiguous in T, q (n, k) int8 contiguous, scale (n,) fp32, bias (n,) in
// T or null, y (m, n) contiguous in T, all on the current device; `route`
// (enum Route) names the kernel: float32 takes kStaged only; kTma128,
// kTma256 and kStream need k % 16 == 0 and 16-byte aligned x and q, and
// kStream m <= streaming::kMaxRows.  A route whose conditions fail, an empty
// or oversized problem, or a tensor map that does not encode returns an
// error (cudaErrorInvalidValue); nothing falls through to another kernel.
// Launches on `stream` without synchronising and returns a cudaError_t.
template <typename T>
int forward(const void* x, const int8_t* q, const float* scale, const void* bias, void* y, int m,
            int n, int k, int route, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || k <= 0) return int(cudaErrorInvalidValue);
  const bool vec_q = k % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  int err;
  if constexpr (std::is_same_v<T, float>) {
    if (route != kStaged) return int(cudaErrorInvalidValue);
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
    if (route != kStaged && !(vec_q && vec_x)) return int(cudaErrorInvalidValue);
    switch (route) {
      case kTma128:
        return tma::launch<T, 128>(x, q, scale, bias, y, m, n, k, stream);
      case kTma256:
        return tma::launch<T, 256>(x, q, scale, bias, y, m, n, k, stream);
      case kStream:
        return streaming::launch<T>(x, q, scale, bias, y, m, n, k, stream);
      case kStaged:
        break;
      default:
        return int(cudaErrorInvalidValue);
    }
    const dim3 grid((m + staged::kBM - 1) / staged::kBM, (n + staged::kBN - 1) / staged::kBN);
    if (grid.y > 65535) return int(cudaErrorInvalidValue);
    constexpr auto kernel = staged::w8a16_staged<T>;
    if ((err = allow_smem<kernel>(staged::kSmem))) return err;
    kernel<<<grid, staged::kThreads, staged::kSmem, stream>>>(
        static_cast<const T*>(x), q, scale, static_cast<const T*>(bias), static_cast<T*>(y), m,
        n, k, vec_x, vec_q);
  }
  return int(cudaGetLastError());
}

}  // namespace w8a16
}  // namespace dft
