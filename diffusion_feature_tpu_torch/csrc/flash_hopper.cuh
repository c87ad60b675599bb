// Flash-attention forward for Hopper (sm_90a), bf16 and fp16: non-causal,
// unmasked softmax(q k^T * scale) v with an fp32 running max, denominator
// and accumulator; with kLse each row's natural-log logsumexp as well.
// flash_bf16.cu and flash_fp16.cu instantiate it, one type each.
//
// Replaces diffusion_feature_tpu/ops/flash_attention.py::_flash_kernel (B1)
// and ::_flash_lse_kernel (B2).  On the TPU the key axis was a sequential
// grid dimension carrying the softmax state in VMEM scratch; here a thread
// block owns a tile of query rows of one (b, h) and walks every key tile
// itself, so nothing is carried between blocks.
//
// What bounds it: at d=64 and 4096 tokens a call does ~4000 flops per byte
// it must read, far above the H100's ~295 bf16 flops per byte, so the
// tensor cores and the Sq*Sk exponentials (one per score, on the
// special-function units) are the limit, not memory.  The design:
//
// * Warp specialisation.  Warpgroup 0 is the producer: it gives its
//   registers away (setmaxnreg) and one thread of it issues every TMA load.
//   The other warpgroups are consumers, each owning 64 query rows, on
//   240 registers a thread.
// * A TMA ring.  The producer loads the block's Q tile once, then keeps K/V
//   tiles in flight in a ring of kStages stages; per stage "full" mbarriers
//   for K and for V (the hardware counts the bytes in) and "empty" ones the
//   consumer warps arrive on when they are done with the K or V tile.  The
//   tensor maps (4-d: d, s, h, b with the caller's strides) are encoded on
//   the host per call and passed as __grid_constant__ parameters, so the
//   head-split view (B, H, S, D) of a (B, S, H*D) projection is read in
//   place, and CUDA graphs capture them.  Tiles are 64 columns wide (128
//   bytes) in the 128-byte swizzle wgmma's descriptors expect; a wider head
//   is several such "atoms".  Rows past S and columns past D (d=40 up to
//   the mma depth 48, d=80 and d=160 up to the next atom) are zero-filled by
//   TMA; keys past Sk are masked to -inf, rows past Sq are never stored.
// * wgmma.  S = Q K^T runs with both operands in shared memory; the online
//   softmax uses exp2 with the scale folded in; P stays in registers as the
//   A operand of P V (the accumulator layout of S is the A-fragment layout
//   of the next product), with V as the transposed (MN-major) B operand
//   straight from its TMA tile.  Inside a warpgroup, tile j's QK^T and
//   tile j-1's P V are in flight together, and tile j's softmax runs while
//   that P V does; two warpgroups per block overlap further.
// * d=512 (the VAE's single head) computes every score once.  The 64x512
//   fp32 accumulator does not fit one warpgroup, so two consumer warpgroups
//   split the output columns (256 each).  Each computes the scores of half
//   the keys of a 32-key tile over the full depth; they swap row maxima
//   and their halves of P through shared memory (two named barriers per
//   tile), and each multiplies the whole P by its half of V.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tile_ops.cuh"
#include "wgmma.cuh"

namespace dft {
namespace hopper {

constexpr int kAtom = 64;          // columns of one 128-byte swizzle atom
constexpr int kAtomBytes = 128;    // bytes of one atom row
constexpr int kStages = 2;         // K/V ring depth
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait of more
// than ~2^34 cycles (seconds; a tile arrives in microseconds) means a lost
// arrival: trap, so the launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
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

// One box of a 4-d tensor map (coordinates d, s, h, b) into shared memory;
// the bytes are counted into `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
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

// 2^x on the special-function unit (ex2.approx, ~2 ulp; -inf gives 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Output rows are written straight from the accumulators: a lane's two
// columns as one 4-byte store, rows past Sq skipped.
struct OutPtr {
  void* o;
  float* lse;             // (bh, sq) fp32, or null
  long long sb, sh, ss;   // the output's strides in elements
};

// A block's shared memory: the Q tile, the K and V rings and their
// barriers, carved from dynamic shared memory aligned to 1024 bytes (the
// 128-byte swizzle repeats every 1024 bytes).  C gives the tile shapes.
template <typename C>
struct Ring {
  static constexpr size_t kBytes = 1024 + C::kQBytes + 2 * kStages * size_t(C::kKVBytes) + 128;
  uint8_t *qs, *ks, *vs;
  uint64_t *qbar, *kfull, *vfull, *kempty, *vempty;

  __device__ explicit Ring(uint8_t* raw) {
    const uint32_t addr = smem_u32(raw);
    qs = raw + (((addr + 1023) & ~1023u) - addr);
    ks = qs + C::kQBytes;
    vs = ks + kStages * C::kKVBytes;
    qbar = reinterpret_cast<uint64_t*>(vs + kStages * C::kKVBytes);
    kfull = qbar + 1;
    vfull = kfull + kStages;
    kempty = vfull + kStages;
    vempty = kempty + kStages;
  }
  // 16-byte aligned space past the barriers (128 bytes hold them)
  __device__ uint8_t* end() const { return reinterpret_cast<uint8_t*>(qbar) + 128; }

  // One thread, before the block's __syncthreads: the producer's arrival
  // (with the bytes) fills a tile, one arrival per consumer warp empties it.
  __device__ void init() {
    mbar_init(qbar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], C::kWG * 4);
      mbar_init(&vempty[s], C::kWG * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The producer thread: the block's Q tile once, then the K and V tiles of
  // n_tiles key tiles, each into its stage once the consumers release it.
  __device__ void produce(const CUtensorMap* qmap, const CUtensorMap* kmap,
                          const CUtensorMap* vmap, int q0, int h, int b, int n_tiles) {
    prefetch_map(qmap);
    prefetch_map(kmap);
    prefetch_map(vmap);
    mbar_expect_tx(qbar, C::kQBytes);
    for (int a = 0; a < C::kAtoms; ++a)
      tma_load(qs + a * C::kBM * kAtomBytes, qmap, qbar, a * kAtom, q0, h, b);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t parity = ((j / kStages) & 1) ^ 1;
      mbar_wait(&kempty[s], parity);
      mbar_expect_tx(&kfull[s], C::kKVBytes);
      for (int a = 0; a < C::kAtoms; ++a)
        tma_load(ks + s * C::kKVBytes + a * C::kBN * kAtomBytes, kmap, &kfull[s], a * kAtom,
                 j * C::kBN, h, b);
      mbar_wait(&vempty[s], parity);
      mbar_expect_tx(&vfull[s], C::kKVBytes);
      for (int a = 0; a < C::kAtoms; ++a)
        tma_load(vs + s * C::kKVBytes + a * C::kBN * kAtomBytes, vmap, &vfull[s], a * kAtom,
                 j * C::kBN, h, b);
    }
  }
};

// ------------------------------------------------------------ d <= 160
template <int D>
struct Cfg {
  static constexpr int kDP = (D + 15) / 16 * 16;           // QK^T depth (d=40 -> 48)
  static constexpr int kAtoms = (D + kAtom - 1) / kAtom;    // 64-column atoms per row
  static constexpr int kWG = 2;                             // consumer warpgroups
  static constexpr int kBM = 64 * kWG;                      // query rows per block
  // keys per tile: the scores (kBN/2), two P sets (kBN/4 each) and the
  // accumulator (D/2) must fit a consumer's 240 registers; at d=128 and
  // 128 keys ptxas spills 416 bytes
  static constexpr int kBN = D <= 80 ? 128 : 64;
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr uint32_t kQBytes = kAtoms * kBM * kAtomBytes;
  static constexpr uint32_t kKVBytes = kAtoms * kBN * kAtomBytes;   // K or V tile
};

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_fwd_hopper(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, OutPtr out, int heads, int sq, int sk,
                 float scale_log2) {
  using C = Cfg<D>;
  constexpr int kBN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  Ring<C> ring(smem_raw);
  uint8_t *qs = ring.qs, *ks = ring.ks, *vs = ring.vs;
  uint64_t *qbar = ring.qbar, *kfull = ring.kfull, *vfull = ring.vfull;
  uint64_t *kempty = ring.kempty, *vempty = ring.vempty;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * C::kBM;
  const int n_tiles = (sk + kBN - 1) / kBN;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) ring.produce(&qmap, &kmap, &vmap, q0, h, b, n_tiles);
  } else {
    // ---- consumer warpgroup c: query rows q0 + 64c .. q0 + 64c + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};   // running max of rows g, g+8 (unscaled)
    float l[2] = {0.f, 0.f};               // this lane's share of the denominators

    const uint32_t q_addr = smem_u32(qs) + c * 64 * kAtomBytes;

    // S = Q K_j^T into sc, issued and committed, not waited for
    auto issue_s = [&](float (&sc)[kBN / 2], int j) {
      const int s = j % kStages;
      const uint32_t k_addr = smem_u32(ks + s * C::kKVBytes);
      mbar_wait(&kfull[s], (j / kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kDP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes into the atom
        wgmma_ss<T, kBN>(sc, sw128_desc(q_addr + (kk / 4) * C::kBM * kAtomBytes + off, 16, 1024),
                         sw128_desc(k_addr + (kk / 4) * kBN * kAtomBytes + off, 16, 1024),
                         kk > 0);
      }
      wgmma_commit();
    };
    // O += P_j V_j, issued and committed, not waited for
    auto issue_pv = [&](const uint32_t (&p)[kBN / 4], int j) {
      const int s = j % kStages;
      const uint32_t v_addr = smem_u32(vs + s * C::kKVBytes);
      mbar_wait(&vfull[s], (j / kStages) & 1);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<T, D>(o, &p[kk * 4],
                       sw128_desc(v_addr + kk * 16 * kAtomBytes, kBN * kAtomBytes, 1024), 1);
      wgmma_commit();
    };
    auto release = [&](uint64_t* empty, int j) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[j % kStages]);
    };
    // online softmax of tile j's scores into P (the A fragments of P V) and
    // the factor alpha that rescales the rows' earlier sums
    auto softmax = [&](float (&sc)[kBN / 2], uint32_t (&p)[kBN / 4], int j, float (&alpha)[2]) {
      // on the unscaled scores (the scale is positive, so maxima commute
      // with it); keys past Sk get -inf and so weight 0
      const int k0 = j * kBN;
      if (k0 + kBN > sk) {
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + n * 8 + 2 * t + (e & 1) >= sk) sc[n * 4 + e] = -INFINITY;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n)
          mx = fmaxf(mx, fmaxf(sc[n * 4 + 2 * r], sc[n * 4 + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        // every tile holds at least one valid key, so m_new is finite
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = fast_exp2((m[r] - m_new) * scale_log2);
        const float m_scaled = m_new * scale_log2;
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n) {
          // 2^(s * scale_log2 - m * scale_log2): one FFMA and one ex2 a score
          const float p0 = fast_exp2(fmaf(sc[n * 4 + 2 * r], scale_log2, -m_scaled));
          const float p1 = fast_exp2(fmaf(sc[n * 4 + 2 * r + 1], scale_log2, -m_scaled));
          sum += p0 + p1;
          // 16 keys (8-key blocks 2kk, 2kk+1) per k-step of P V
          p[(n / 2) * 4 + (n % 2) * 2 + r] = pack2<T>(p0, p1);
        }
        l[r] = l[r] * alpha[r] + sum;
      }
    };
    auto rescale = [&](const float (&alpha)[2]) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n * 4 + 0] *= alpha[0];
        o[n * 4 + 1] *= alpha[0];
        o[n * 4 + 2] *= alpha[1];
        o[n * 4 + 3] *= alpha[1];
      }
    };

    // Tile j's scores are computed while tile j-1's P V runs on the tensor
    // cores, and tile j's softmax overlaps that product.  P alternates
    // between two register sets, as the product reading one is in flight
    // while the softmax writes the other.
    float sc[kBN / 2], alpha[2];
    uint32_t pa[kBN / 4], pb[kBN / 4];
    mbar_wait(qbar, 0);
    issue_s(sc, 0);
    wgmma_wait<0>();
    fence_regs(sc);
    release(kempty, 0);
    softmax(sc, pa, 0, alpha);
    auto step = [&](const uint32_t (&p_prev)[kBN / 4], uint32_t (&p_cur)[kBN / 4], int j) {
      issue_s(sc, j);
      issue_pv(p_prev, j - 1);
      wgmma_wait<1>();   // the scores; the product may still run
      fence_regs(sc);
      release(kempty, j);
      softmax(sc, p_cur, j, alpha);
      wgmma_wait<0>();
      fence_regs(o);
      release(vempty, j - 1);
      rescale(alpha);
    };
    int j = 1;
    for (; j + 1 < n_tiles; j += 2) {
      step(pa, pb, j);
      step(pb, pa, j + 1);
    }
    if (j < n_tiles) {
      step(pa, pb, j);
      issue_pv(pb, j);
    } else {
      issue_pv(pa, j - 1);
    }
    wgmma_wait<0>();
    fence_regs(o);
    const long long obase = b * out.sb + h * out.sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tot = l[r];
      tot += __shfl_xor_sync(0xffffffffu, tot, 1);
      tot += __shfl_xor_sync(0xffffffffu, tot, 2);
      const float inv = 1.f / tot;
      const int row = q0 + c * 64 + warp * 16 + g + 8 * r;
      if (row < sq) {
        T* orow = static_cast<T*>(out.o) + obase + row * out.ss;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
          *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
              pack2<T>(o[n * 4 + 2 * r] * inv, o[n * 4 + 2 * r + 1] * inv);
        // natural-log logsumexp of the scaled scores: ln 2 * (m * scale_log2 + log2 l)
        if constexpr (kLse) {
          if (t == 0)
            out.lse[size_t(bh) * sq + row] =
                fmaf(m[r], scale_log2, log2f(tot)) * 0.6931471805599453f;
        }
      }
    }
  }
}

// ------------------------------------------------------------ d = 512
struct Cfg512 {
  static constexpr int D = 512;
  static constexpr int kAtoms = D / kAtom;   // 8
  static constexpr int kWG = 2;              // consumer warpgroups
  static constexpr int kBM = 64;             // query rows per block
  static constexpr int kBN = 32;             // keys per tile, 16 per consumer
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr uint32_t kQBytes = kAtoms * kBM * kAtomBytes;    // 64 KB
  static constexpr uint32_t kKVBytes = kAtoms * kBN * kAtomBytes;   // 32 KB
  // past the ring: row maxima (2 x 64 floats), P halves (2 x 128 threads
  // x 16 bytes), denominators (2 x 64 floats)
  static constexpr size_t kXBytes = 2 * 64 * 4 + 2 * 128 * 16 + 2 * 64 * 4;
};

template <typename T>
__global__ void __launch_bounds__(Cfg512::kThreads, 1)
flash_fwd_hopper_d512(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, OutPtr out, int heads, int sq,
                      int sk, float scale_log2) {
  using C = Cfg512;
  constexpr int kBN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  Ring<C> ring(smem_raw);
  uint8_t *qs = ring.qs, *ks = ring.ks, *vs = ring.vs;
  uint64_t *qbar = ring.qbar, *kfull = ring.kfull, *vfull = ring.vfull;
  uint64_t *kempty = ring.kempty, *vempty = ring.vempty;
  float* xmax = reinterpret_cast<float*>(ring.end());   // [2][64]
  uint4* xp = reinterpret_cast<uint4*>(xmax + 2 * 64);  // [2][128]
  float* xl = reinterpret_cast<float*>(xp + 2 * 128);   // [2][64]

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * C::kBM;
  const int n_tiles = (sk + kBN - 1) / kBN;

  if (threadIdx.x == 0) ring.init();
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) ring.produce(&qmap, &kmap, &vmap, q0, h, b, n_tiles);
  } else {
    // consumer c: scores of keys 16c..16c+15 of each tile, output columns
    // 256c..256c+255 of the block's 64 rows
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int rows[2] = {warp * 16 + g, warp * 16 + g + 8};

    float o[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};

    const uint32_t q_addr = smem_u32(qs);
    mbar_wait(qbar, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t parity = (j / kStages) & 1;
      const uint32_t k_addr = smem_u32(ks + s * C::kKVBytes) + c * 16 * kAtomBytes;
      const uint32_t v_addr = smem_u32(vs + s * C::kKVBytes) + c * 4 * kBN * kAtomBytes;

      float sc[8];
      mbar_wait(&kfull[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;
        wgmma_ss<T, 16>(sc, sw128_desc(q_addr + (kk / 4) * C::kBM * kAtomBytes + off, 16, 1024),
                        sw128_desc(k_addr + (kk / 4) * kBN * kAtomBytes + off, 16, 1024),
                        kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&kempty[s]);

      const int k0 = j * kBN + c * 16;
      float mx[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int key = k0 + n * 8 + 2 * t + e;
            float& x = sc[n * 4 + 2 * r + e];
            if (key >= sk) x = -INFINITY;
          }
        }
        mx[r] = fmaxf(fmaxf(sc[2 * r], sc[2 * r + 1]), fmaxf(sc[4 + 2 * r], sc[4 + 2 * r + 1]));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        if (t == 0) xmax[c * 64 + rows[r]] = mx[r];
      }
      named_sync(1, 256);

      uint32_t own[4], other[4];   // A fragments of P V for this consumer's keys and the other's
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        // both consumers take the same maximum, so their halves share one scale
        const float m_new = fmaxf(m[r], fmaxf(mx[r], xmax[(1 - c) * 64 + rows[r]]));
        alpha[r] = fast_exp2((m[r] - m_new) * scale_log2);
        const float m_scaled = m_new * scale_log2;
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float p0 = fast_exp2(fmaf(sc[n * 4 + 2 * r], scale_log2, -m_scaled));
          const float p1 = fast_exp2(fmaf(sc[n * 4 + 2 * r + 1], scale_log2, -m_scaled));
          sum += p0 + p1;
          own[n * 2 + r] = pack2<T>(p0, p1);
        }
        l[r] = l[r] * alpha[r] + sum;
      }
      xp[c * 128 + tid] = make_uint4(own[0], own[1], own[2], own[3]);
      named_sync(1, 256);
      const uint4 x = xp[(1 - c) * 128 + tid];
      other[0] = x.x;
      other[1] = x.y;
      other[2] = x.z;
      other[3] = x.w;
      // k-step 0 holds keys 0..15 (consumer 0's), k-step 1 keys 16..31
      uint32_t a0[4], a1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a0[i] = c == 0 ? own[i] : other[i];
        a1[i] = c == 0 ? other[i] : own[i];
      }
#pragma unroll
      for (int n = 0; n < 32; ++n) {
        o[n * 4 + 0] *= alpha[0];
        o[n * 4 + 1] *= alpha[0];
        o[n * 4 + 2] *= alpha[1];
        o[n * 4 + 3] *= alpha[1];
      }

      mbar_wait(&vfull[s], parity);
      fence_regs(o);
      wgmma_fence();
      wgmma_rs<T, 256>(o, a0, sw128_desc(v_addr, kBN * kAtomBytes, 1024), 1);
      wgmma_rs<T, 256>(o, a1, sw128_desc(v_addr + 16 * kAtomBytes, kBN * kAtomBytes, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      __syncwarp();
      if (lane == 0) mbar_arrive(&vempty[s]);
    }

    // each consumer summed its own keys: add the two halves
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (t == 0) xl[c * 64 + rows[r]] = l[r];
    }
    named_sync(1, 256);
    const long long obase = b * out.sb + h * out.sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float inv = 1.f / (l[r] + xl[(1 - c) * 64 + rows[r]]);
      const int row = q0 + rows[r];
      if (row < sq) {
        T* orow = static_cast<T*>(out.o) + obase + row * out.ss + c * 256;
#pragma unroll
        for (int n = 0; n < 32; ++n)
          *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
              pack2<T>(o[n * 4 + 2 * r] * inv, o[n * 4 + 2 * r + 1] * inv);
      }
    }
  }
}

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

// q, k, v, o: (b, h, s, d) with strides[0..11] = (sb, sh, ss) of q, k, v, o.
template <typename T, int D, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int h, int sq,
           int sk, float scale, const long long* strides, cudaStream_t stream) {
  constexpr bool kWide = D == 512;
  using C = std::conditional_t<kWide, Cfg512, Cfg<D>>;
  constexpr int kBM = C::kBM, kBN = C::kBN, kThreads = C::kThreads;
  constexpr size_t kSmem = Ring<C>::kBytes + (kWide ? Cfg512::kXBytes : 0);
  CUtensorMap qm, km, vm;
  int err;
  if ((err = make_map<T>(&qm, q, b, h, sq, D, strides, kBM))) return err;
  if ((err = make_map<T>(&km, k, b, h, sk, D, strides + 3, kBN))) return err;
  if ((err = make_map<T>(&vm, v, b, h, sk, D, strides + 6, kBN))) return err;
  const OutPtr out{o, lse, strides[9], strides[10], strides[11]};
  const dim3 grid((sq + kBM - 1) / kBM, b * h);
  const float scale_log2 = scale * 1.4426950408889634f;
  if constexpr (kWide) {
    constexpr auto kernel = flash_fwd_hopper_d512<T>;
    if ((err = allow_smem<kernel>(kSmem))) return err;
    kernel<<<grid, kThreads, kSmem, stream>>>(qm, km, vm, out, h, sq, sk, scale_log2);
  } else {
    constexpr auto kernel = flash_fwd_hopper<T, D, kLse>;
    if ((err = allow_smem<kernel>(kSmem))) return err;
    kernel<<<grid, kThreads, kSmem, stream>>>(qm, km, vm, out, h, sq, sk, scale_log2);
  }
  return int(cudaGetLastError());
}

// The body of each type's C entry point, dft_flash_attention_forward(q, k,
// v, o, lse, b, h, sq, sk, d, dtype, scale, strides, stream), whose contract
// this is (flash_bf16.cu, flash_fp16.cu and flash_f32.cu share it): q, k, v,
// o are (b, h, s, d) device tensors of one dtype with unit stride on d;
// strides[0..11] are (sb, sh, ss) in elements of q, k, v and o, each a
// multiple of 16 bytes, and every base 16-byte aligned.  lse: null (B1), or
// a contiguous fp32 (b*h, sq) buffer that receives each row's logsumexp
// (B2).  dtype: 0 float32, 1 float16, 2 bfloat16; each library takes its
// own type only.  Launches on `stream` without synchronising and returns a
// cudaError_t.  B1 at every width, B2 at the U-Nets' widths only: the VAE's
// d=512 head never feeds the attention store.
template <typename T>
int forward(const void* q, const void* k, const void* v, void* o, float* lse, int b, int h, int sq,
            int sk, int d, float scale, const long long* strides, cudaStream_t s) {
  if (lse != nullptr) {
    switch (d) {
      case 40: return launch<T, 40, true>(q, k, v, o, lse, b, h, sq, sk, scale, strides, s);
      case 64: return launch<T, 64, true>(q, k, v, o, lse, b, h, sq, sk, scale, strides, s);
      case 80: return launch<T, 80, true>(q, k, v, o, lse, b, h, sq, sk, scale, strides, s);
      case 128: return launch<T, 128, true>(q, k, v, o, lse, b, h, sq, sk, scale, strides, s);
      case 160: return launch<T, 160, true>(q, k, v, o, lse, b, h, sq, sk, scale, strides, s);
      default: return int(cudaErrorInvalidValue);
    }
  }
  switch (d) {
    case 40: return launch<T, 40, false>(q, k, v, o, lse, b, h, sq, sk, scale, strides, s);
    case 64: return launch<T, 64, false>(q, k, v, o, lse, b, h, sq, sk, scale, strides, s);
    case 80: return launch<T, 80, false>(q, k, v, o, lse, b, h, sq, sk, scale, strides, s);
    case 128: return launch<T, 128, false>(q, k, v, o, lse, b, h, sq, sk, scale, strides, s);
    case 160: return launch<T, 160, false>(q, k, v, o, lse, b, h, sq, sk, scale, strides, s);
    case 512: return launch<T, 512, false>(q, k, v, o, lse, b, h, sq, sk, scale, strides, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace hopper
}  // namespace dft
