// The flash-attention backward's main pass for Hopper (sm_90a), bf16 and
// fp16: wgmma, TMA and warp specialisation, one score pass.  flash_bwd.cuh
// holds the contract, the delta pre-pass and the entry point;
// flash_bwd_bf16.cu and flash_bwd_fp16.cu instantiate this, one type each.
//
// What bounds it: five products, 10 B H Sq Sk D flops, on the tensor cores
// (989 TFLOP/s on an H100), plus one exponential per score; at the U-Nets'
// widths and lengths the bytes it must move are far below that.  The design
// keeps the products on wgmma, the operands in shared memory or registers,
// and computes each score once:
//
// * One block per 128 keys of one (b, h): two warpgroups, each owning 64
//   of the keys and keeping their dk and dv in registers as wgmma
//   accumulators (256 threads, so a thread may hold 255 registers; a
//   producer warp would make it 9 warps, 3 on one SM sub-partition, and
//   cap every thread at 168).  The block's K and V tiles are loaded once
//   by TMA and stay; thread 0 keeps the Q and dO tiles of the query walk in
//   flight in a ring of kStages stages (TMA, one full mbarrier a stage),
//   refilling a stage as soon as the block barrier that follows its last
//   use has passed, and the first kBQ threads write each tile's logsumexp
//   (log2 units, +inf past Sq) and delta two tiles ahead.  The tensor maps
//   read the head-split (B, H, S, D) views in place, zero-filled past S and
//   past D (d=40 up to the depth 48, d=72/88 up to 80/96, every width up to
//   its last 64-column atom), as in the forward.
// * Per query tile (kBQ queries), in each consumer:
//     s^T = k q^T and dp^T = v do^T: wgmma_ss, both operands K-major, as
//       the forward's q k^T (M = the consumer's 64 keys, N = kSub queries
//       at a time);
//     p^T = exp2(s^T * scale * log2 e - lse), ds^T = p^T (dp^T - delta) *
//       scale in registers, rounded to the input type as operands;
//     dv += p^T do and dk += ds^T q: wgmma_rs, the accumulator layout of
//       s^T being the A-fragment layout, with do and q as MN-major B
//       straight from their TMA tiles (N = d), as the forward's P V;
//     ds^T written once to shared memory (128-byte swizzle), then
//     dq = ds k: wgmma_ss_tt, ds^T and k both read MN-major (transposed)
//       over the block's 128 keys.  With kBQ = 128 (d <= 64) consumer c
//       takes queries 64c..64c+63 at every column; with kBQ = 64 consumer 0
//       takes columns 0..63 and consumer 1 the rest.
// * Each consumer writes its dq piece to shared memory and one thread
//   adds it into the fp32 accumulator with one bulk reduce-add
//   (cp.reduce.async.bulk .add.f32): the accumulator's (b, h) slice keeps
//   each consumer's columns as a contiguous (Sq, width) region, so a piece
//   of rows is one contiguous range.  A last pass converts it to dq in the
//   input type at dq's strides.
// So dq is summed across key blocks in no fixed order (see flash_bwd.cuh).
//
// Registers: dk and dv take d fp32 registers a thread; s^T and dp^T are
// computed kSub queries at a time (128 at d=40, 64 up to d=128, 16 at
// d=160) so that they, p^T and ds^T fit beside them; dq is computed after
// the dv/dk products have retired, in chunks of at most 64 columns.  Shared
// memory: K and V (2 x 16 KB per 64-column atom), the Q/dO ring (two
// stages below d=160, one at d=160), two ds^T buffers (one is read by dq
// while the next tile's is written) and the two dq pieces: 183 KB to
// 218 KB.

#pragma once

#include <type_traits>

#include "flash_bwd.cuh"
#include "hopper_common.cuh"

namespace dft {
namespace bwd {

using hopper::kAtom;
using hopper::kAtomBytes;

template <int D>
struct HCfg {
  static constexpr int kAtoms = (D + kAtom - 1) / kAtom;   // 64-column atoms per row
  static constexpr int kDP = (D + 15) / 16 * 16;           // depth of s^T and dp^T
  static constexpr int kBK = 128;                          // keys per block, 64 per consumer
  static constexpr int kBQ = D <= 64 ? 128 : 64;           // queries per tile
  // queries per s^T / dp^T product: dk, dv (d registers), s^T and dp^T
  // (kSub), p^T and ds^T (kSub / 2) fit a thread's 255 registers
  static constexpr int kSub = D <= 40 ? 128 : D <= 128 ? 64 : 16;
  static constexpr int kStages = D <= 128 ? 2 : 1;         // Q/dO ring depth
  static constexpr bool kRowSplit = kBQ == 128;            // dq pieces by rows, else columns
  static constexpr int kN0 = kRowSplit ? D : 64;           // dq columns of consumer 0
  static constexpr int kN1 = kRowSplit ? D : D - 64;       // and of consumer 1
  static constexpr int kThreads = 2 * 128;                 // two consumer warpgroups
  static constexpr uint32_t kKVBytes = kAtoms * kBK * kAtomBytes;   // K or V tile
  static constexpr uint32_t kQBytes = kAtoms * kBQ * kAtomBytes;    // Q or dO tile
  static constexpr uint32_t kDSBytes = kBK * kBQ * 2;               // one ds^T buffer
  static constexpr uint32_t kDQ0Bytes = 64 * kN0 * 4, kDQ1Bytes = 64 * kN1 * 4;
  // 1024 of alignment slack, the tiles, two lse/delta slots, the barriers
  static constexpr size_t kBytes = 1024 + 2 * size_t(kKVBytes) + kStages * 2 * size_t(kQBytes) +
                                   2 * size_t(kDSBytes) + kDQ0Bytes + kDQ1Bytes + 2 * 2 * kBQ * 4 +
                                   128;
  static_assert(kBytes <= 227 * 1024, "a block's shared memory");
  static_assert(kBQ % kSub == 0 && kN1 <= 64 + 32, "dq pieces are one or two wgmma chunks");
};

__device__ __forceinline__ void bulk_reduce_add(float* dst, const void* src, uint32_t bytes) {
  asm volatile("cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(
                   dst),
               "r"(hopper::smem_u32(src)), "r"(bytes)
               : "memory");
}

// dq = ds k for columns [col, col + N) of a piece of 64 query rows over the
// block's 128 keys, into acc: issued and committed, not waited for.
// a_base: ds^T's atom of these queries; b_base: K's atom of column `col`.
template <typename T, int N>
__device__ __forceinline__ void dq_issue(float (&acc)[N / 2], uint32_t a_base, uint32_t b_base) {
  using namespace hopper;
  constexpr int kBK = 128;
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
    wgmma_ss_tt<T, N>(acc, sw128_desc(a_base + kk * 16 * kAtomBytes, kBK * kAtomBytes, 1024),
                      sw128_desc(b_base + kk * 16 * kAtomBytes, kBK * kAtomBytes, 1024), kk > 0);
  wgmma_commit();
}

// A retired dq chunk into the consumer's row-major shared buffer of `width`
// columns.  A 64-wide piece keeps each row's 8-column blocks in the order
// block ^ (row % 8), so that a warp's eight rows (256 bytes apart) write
// eight distinct 32-byte blocks: dq_convert undoes it.
template <int N>
__device__ __forceinline__ void dq_store(const float (&acc)[N / 2], float* buf, int width,
                                         int col) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < N / 8; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = warp * 16 + g + 8 * r;
      const int blk = width == 64 ? n ^ (row & 7) : n;
      *reinterpret_cast<float2*>(buf + row * width + col + blk * 8 + 2 * t) =
          make_float2(acc[n * 4 + 2 * r], acc[n * 4 + 2 * r + 1]);
    }
}

// Consumer c's piece of tile i (N columns, in its shared buffer): added
// into the accumulator with one bulk reduce-add by the consumer's thread 0.
template <int D, int N>
__device__ __forceinline__ void dq_publish(int c, int i, const float* buf, float* dq_acc, int bh,
                                           int sq) {
  using namespace hopper;
  using C = HCfg<D>;
  fence_proxy_async();
  named_sync(2 + c, 128);
  if (threadIdx.x % 128 == 0) {
    const int q_first = i * C::kBQ + (C::kRowSplit ? c * 64 : 0);
    const int rows = min(64, sq - q_first);
    if (rows > 0) {
      float* region = dq_acc + size_t(bh) * sq * D;
      if (!C::kRowSplit && c == 1) region += size_t(sq) * C::kN0;
      bulk_reduce_add(region + size_t(q_first) * N, buf, uint32_t(rows * N * 4));
      bulk_commit();
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(HCfg<D>::kThreads, 1)
flash_bwd_hopper(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap,
                 const __grid_constant__ CUtensorMap domap, const Args<T> a, float scale_log2) {
  using namespace hopper;
  using C = HCfg<D>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kStages = C::kStages, kSub = C::kSub;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  uint8_t* ks = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  uint8_t* vs = ks + C::kKVBytes;
  uint8_t* qs = vs + C::kKVBytes;                      // stage s: q, then do
  uint8_t* dss = qs + kStages * 2 * C::kQBytes;        // two ds^T buffers
  float* dq0s = reinterpret_cast<float*>(dss + 2 * C::kDSBytes);
  float* dq1s = dq0s + 64 * C::kN0;
  float* lds = dq1s + 64 * C::kN1;                     // slot i % 2: lse (log2), then delta
  uint64_t* kvbar = reinterpret_cast<uint64_t*>(lds + 2 * 2 * kBQ);
  uint64_t* full = kvbar + 1;

  const int sq = a.sq, sk = a.sk;
  const float scale = a.scale;
  const int bh = blockIdx.y, b = bh / a.h, h = bh % a.h;
  const int k0 = blockIdx.x * kBK;
  const int n_tiles = (sq + kBQ - 1) / kBQ;
  const float* lseg = a.lse + size_t(bh) * sq;
  const float* dlg = a.delta + size_t(bh) * sq;

  // tile i's Q and dO into stage i % kStages, by thread 0
  auto load_tile = [&](int i) {
    const int s = i % kStages;
    mbar_expect_tx(&full[s], 2 * C::kQBytes);
    uint8_t* stage = qs + s * 2 * C::kQBytes;
    for (int at = 0; at < C::kAtoms; ++at) {
      tma_load(stage + at * kBQ * kAtomBytes, &qmap, &full[s], at * kAtom, i * kBQ, h, b);
      tma_load(stage + C::kQBytes + at * kBQ * kAtomBytes, &domap, &full[s], at * kAtom, i * kBQ,
               h, b);
    }
  };
  // tile i's logsumexp (log2 units, +inf past Sq so that p = 0) and delta
  // into slot i % 2, by the first kBQ threads
  auto load_rows = [&](int i) {
    if (threadIdx.x < kBQ && i < n_tiles) {
      float* l2 = lds + (i % 2) * 2 * kBQ;
      const int q = i * kBQ + threadIdx.x;
      l2[threadIdx.x] = q < sq ? lseg[q] * kLog2e : INFINITY;
      l2[kBQ + threadIdx.x] = q < sq ? dlg[q] : 0.f;
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(kvbar, 1);
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  load_rows(0);
  load_rows(1);
  __syncthreads();
  if (threadIdx.x == 0) {
    prefetch_map(&qmap);
    prefetch_map(&kmap);
    prefetch_map(&vmap);
    prefetch_map(&domap);
    mbar_expect_tx(kvbar, 2 * C::kKVBytes);
    for (int at = 0; at < C::kAtoms; ++at) {
      tma_load(ks + at * kBK * kAtomBytes, &kmap, kvbar, at * kAtom, k0, h, b);
      tma_load(vs + at * kBK * kAtomBytes, &vmap, kvbar, at * kAtom, k0, h, b);
    }
    for (int i = 0; i < kStages && i < n_tiles; ++i) load_tile(i);
  }

  {
    // ---- consumer c: keys k0 + 64c .. k0 + 64c + 63
    const int c = threadIdx.x / 128;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = c * 64 + warp * 16 + g;   // this thread's keys: row0 and row0 + 8
    const bool key_ok[2] = {k0 + row0 < sk, k0 + row0 + 8 < sk};

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const uint32_t k_addr = smem_u32(ks);
    const uint32_t k_own = k_addr + c * 64 * kAtomBytes, v_own = smem_u32(vs) + c * 64 * kAtomBytes;
    float* dq_buf = c == 0 ? dq0s : dq1s;
    // ds^T's atom of this consumer's dq rows, K's atom of its first column
    const uint32_t dq_a = C::kRowSplit ? c * kBK * kAtomBytes : 0;
    const uint32_t dq_b = k_addr + (C::kRowSplit ? 0 : c * kBK * kAtomBytes);
    mbar_wait(kvbar, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      const uint32_t q_addr = smem_u32(qs + s * 2 * C::kQBytes);
      const uint32_t do_addr = q_addr + C::kQBytes;
      const float* l2 = lds + (i % 2) * 2 * kBQ;
      const float* dl = l2 + kBQ;
      uint8_t* ds_buf = dss + (i & 1) * C::kDSBytes;
      mbar_wait(&full[s], (i / kStages) & 1);

#pragma unroll
      for (int q0 = 0; q0 < kBQ; q0 += kSub) {
        // s^T = k q^T, dp^T = v do^T (this consumer's 64 keys x queries
        // q0 .. q0 + kSub of the tile)
        float sc[kSub / 2], dp[kSub / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::kDP / 16; ++kk) {
          const uint32_t off = (kk / 4) * kBQ * kAtomBytes + q0 * kAtomBytes + (kk % 4) * 32;
          const uint32_t own = (kk / 4) * kBK * kAtomBytes + (kk % 4) * 32;
          wgmma_ss<T, kSub>(sc, sw128_desc(k_own + own, 16, 1024),
                            sw128_desc(q_addr + off, 16, 1024), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < C::kDP / 16; ++kk) {
          const uint32_t off = (kk / 4) * kBQ * kAtomBytes + q0 * kAtomBytes + (kk % 4) * 32;
          const uint32_t own = (kk / 4) * kBK * kAtomBytes + (kk % 4) * 32;
          wgmma_ss<T, kSub>(dp, sw128_desc(v_own + own, 16, 1024),
                            sw128_desc(do_addr + off, 16, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sc);
        fence_regs(dp);

        // p^T and ds^T as the A fragments of the next products: 16 queries
        // (8-column blocks 2kk, 2kk+1) per k-step
        uint32_t pp[kSub / 4], dsp[kSub / 4];
#pragma unroll
        for (int n = 0; n < kSub / 8; ++n) {
          const float2 lq = *reinterpret_cast<const float2*>(l2 + q0 + n * 8 + 2 * t);
          const float2 dlq = *reinterpret_cast<const float2*>(dl + q0 + n * 8 + 2 * t);
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p0 =
                key_ok[r] ? fast_exp2(fmaf(sc[n * 4 + 2 * r], scale_log2, -lq.x)) : 0.f;
            const float p1 =
                key_ok[r] ? fast_exp2(fmaf(sc[n * 4 + 2 * r + 1], scale_log2, -lq.y)) : 0.f;
            const int idx = (n / 2) * 4 + (n % 2) * 2 + r;
            pp[idx] = pack2<T>(p0, p1);
            dsp[idx] = pack2<T>(p0 * (dp[n * 4 + 2 * r] - dlq.x) * scale,
                                p1 * (dp[n * 4 + 2 * r + 1] - dlq.y) * scale);
          }
        }

        // dv += p^T do, dk += ds^T q over these queries
        fence_regs(dv);
        fence_regs(dk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk)
          wgmma_rs<T, D>(dv, &pp[kk * 4],
                         sw128_desc(do_addr + (q0 + kk * 16) * kAtomBytes, kBQ * kAtomBytes,
                                    1024),
                         1);
#pragma unroll
        for (int kk = 0; kk < kSub / 16; ++kk)
          wgmma_rs<T, D>(dk, &dsp[kk * 4],
                         sw128_desc(q_addr + (q0 + kk * 16) * kAtomBytes, kBQ * kAtomBytes, 1024),
                         1);
        wgmma_commit();

        // ds^T into buffer i % 2: row = key in the block, 64 queries per
        // atom, 128-byte swizzle (16-byte chunk ^ row % 8)
#pragma unroll
        for (int n = 0; n < kSub / 8; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int row = row0 + 8 * r, blk = q0 / 8 + n;   // 8-query block in the tile
            const uint32_t off = (blk / 8) * kBK * kAtomBytes + row * kAtomBytes +
                                 (((blk % 8) ^ (row & 7)) << 4) + 4 * t;
            *reinterpret_cast<uint32_t*>(ds_buf + off) = dsp[(n / 2) * 4 + (n % 2) * 2 + r];
          }
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
      }
      fence_proxy_async();
      if (tid == 0) bulk_wait<0, true>();   // the last dq piece has left dq_buf
      // ds^T whole; both dq buffers free; both consumers done with stage s
      // and with lse/delta slot i % 2
      named_sync(1, 256);
      if (threadIdx.x == 0 && i + kStages < n_tiles) load_tile(i + kStages);
      load_rows(i + 2);

      const uint32_t ds_addr = smem_u32(ds_buf);
      // one chunk (K's atom of the piece's first column) for an N <= 64 piece
      auto one_chunk = [&](auto n_tag) {
        constexpr int N = decltype(n_tag)::value;
        float acc[N / 2];
        dq_issue<T, N>(acc, ds_addr + dq_a, dq_b);
        wgmma_wait<0>();
        fence_regs(acc);
        dq_store<N>(acc, dq_buf, N, 0);
        dq_publish<D, N>(c, i, dq_buf, a.dq_acc, bh, sq);
      };
      if (c == 0) {
        one_chunk(std::integral_constant<int, C::kN0>{});
      } else if constexpr (C::kN1 <= 64) {
        one_chunk(std::integral_constant<int, C::kN1>{});
      } else {
        // d=160's consumer 1: two chunks, K's atoms 1 and 2
        float lo[32], hi[(C::kN1 - 64) / 2];
        dq_issue<T, 64>(lo, ds_addr + dq_a, dq_b);
        wgmma_wait<0>();
        fence_regs(lo);
        dq_store<64>(lo, dq_buf, C::kN1, 0);
        dq_issue<T, C::kN1 - 64>(hi, ds_addr + dq_a, dq_b + kBK * kAtomBytes);
        wgmma_wait<0>();
        fence_regs(hi);
        dq_store<C::kN1 - 64>(hi, dq_buf, C::kN1, 64);
        dq_publish<D, C::kN1>(1, i, dq_buf, a.dq_acc, bh, sq);
      }
    }
    if (tid == 0) bulk_wait<0, false>();

    const long long* sv = a.st.v;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (key_ok[r]) {
        const long long key = k0 + row0 + 8 * r;
        T* dkr = a.dk + b * sv[18] + h * sv[19] + key * sv[20];
        T* dvr = a.dv + b * sv[21] + h * sv[22] + key * sv[23];
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          *reinterpret_cast<uint32_t*>(dkr + n * 8 + 2 * t) =
              pack2<T>(dk[n * 4 + 2 * r], dk[n * 4 + 2 * r + 1]);
          *reinterpret_cast<uint32_t*>(dvr + n * 8 + 2 * t) =
              pack2<T>(dv[n * 4 + 2 * r], dv[n * 4 + 2 * r + 1]);
        }
      }
    }
  }
}

// dq in T at dq's strides from the fp32 accumulator (each consumer's
// columns a contiguous (Sq, width) region of the (b, h) slice, a 64-wide
// region's rows in dq_store's block order); one thread per 8 columns of a
// row.
template <typename T, int D>
__global__ void __launch_bounds__(256)
dq_convert(const float* __restrict__ acc, T* __restrict__ dq, int heads, int sq, long long sb,
           long long sh, long long ss) {
  using C = HCfg<D>;
  constexpr int kGroups = D / 8;
  const int idx = blockIdx.x * 256 + threadIdx.x;
  if (idx >= sq * kGroups) return;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int row = idx / kGroups, col = (idx % kGroups) * 8;
  const bool first = C::kRowSplit || col < 64;   // consumer 0's region
  const int width = first ? C::kN0 : C::kN1;
  const int cr = first ? col : col - 64;           // the column in its region
  const float* src = acc + size_t(bh) * sq * D + (first ? 0 : size_t(sq) * C::kN0) +
                     size_t(row) * width + (width == 64 ? 8 * ((cr / 8) ^ (row & 7)) : cr);
  const float4 lo = *reinterpret_cast<const float4*>(src);
  const float4 hi = *reinterpret_cast<const float4*>(src + 4);
  *reinterpret_cast<uint4*>(dq + b * sb + h * sh + row * ss + col) =
      make_uint4(hopper::pack2<T>(lo.x, lo.y), hopper::pack2<T>(lo.z, lo.w),
                 hopper::pack2<T>(hi.x, hi.y), hopper::pack2<T>(hi.z, hi.w));
}

template <typename T, int D>
int launch(const Args<T>& a, cudaStream_t stream) {
  using C = HCfg<D>;
  const long long* sv = a.st.v;
  CUtensorMap qm, km, vm, dom;
  int err;
  if ((err = hopper::make_map<T>(&qm, a.q, a.b, a.h, a.sq, D, sv, C::kBQ))) return err;
  if ((err = hopper::make_map<T>(&km, a.k, a.b, a.h, a.sk, D, sv + 3, C::kBK))) return err;
  if ((err = hopper::make_map<T>(&vm, a.v, a.b, a.h, a.sk, D, sv + 6, C::kBK))) return err;
  if ((err = hopper::make_map<T>(&dom, a.dout, a.b, a.h, a.sq, D, sv + 12, C::kBQ))) return err;
  if ((err = launch_delta<T, D>(a, stream))) return err;
  constexpr auto kernel = flash_bwd_hopper<T, D>;
  if ((err = allow_smem<kernel>(C::kBytes))) return err;
  kernel<<<dim3((a.sk + C::kBK - 1) / C::kBK, a.b * a.h), C::kThreads, C::kBytes, stream>>>(
      qm, km, vm, dom, a, a.scale * kLog2e);
  if ((err = int(cudaGetLastError()))) return err;
  const int groups = a.sq * (D / 8);
  dq_convert<T, D><<<dim3((groups + 255) / 256, a.b * a.h), 256, 0, stream>>>(
      a.dq_acc, a.dq, a.h, a.sq, sv[15], sv[16], sv[17]);
  return int(cudaGetLastError());
}

}  // namespace bwd
}  // namespace dft
