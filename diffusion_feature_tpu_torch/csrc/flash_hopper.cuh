// Flash-attention forward for Hopper (sm_90a), bf16 and fp16: non-causal,
// unmasked softmax(q k^T * scale) v with an fp32 running max, denominator
// and accumulator; with kLse each row's natural-log logsumexp as well.
// flash_bf16.cu and flash_fp16.cu instantiate it, one type each; the
// helpers it shares with B3 and B4 are in hopper_common.cuh.
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
//   the mma depth 48, d=72 up to 80, d=88 up to 96, d=80 and d=160 up to
//   the next atom) are zero-filled by TMA; keys past Sk are masked to -inf,
//   rows past Sq are never stored.  P V's N is D itself (m64n72k16 at d=72,
//   m64n88k16 at d=88), and the epilogue writes columns up to D only: in
//   (B, S, H, D) memory the next columns are the next head's (HunyuanDiT's
//   d=88 heads are 176 bytes apart, its tokens 2816: both multiples of the
//   16 bytes TMA needs, so its head-split views are read in place).
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
//
// The DiTs' head widths (d=72 PixArt, d=88 HunyuanDiT, d=128 Flux) run
// flash_fwd_pingpong, designed for these widths after flash_fwd_hopper's
// one-block-per-tile template ran 1.05 to 1.31x behind SDPA there.  What
// bounded them, measured on an H100 80GB HBM3 (700 W) in one call against
// variants of the kernel (PERF.md):
//
// * L2.  Every 128-row query tile reads its head's whole K and V, so a call
//   reads b*h*ceil(Sq/128)*Sk*2 rows from L2: 4.08 GB at (2,24,4608,4608,
//   128), 3.7 TB/s in the one-block-per-tile kernel's 1.09 ms and 4.6 in
//   SDPA's 0.89.  At d=72 and 88 a row of a
//   head-split view is 144 or 176 bytes, so its reads straddle 32-byte
//   sectors and cost ~1.2x their bytes.  A cluster of two CTAs on
//   neighbouring query tiles of one head shares each K and V tile (each
//   loads half its rows into both by TMA multicast): d=72 and 88 ran 12 to
//   20% faster than the same kernel without clusters, d=128 0 to 8%.
// * Registers and tile size.  flash_fwd_hopper's two P sets forced 64-key
//   tiles at d=128 (with 128 it spilled 416 bytes).  The FA3 order keeps
//   one: a warpgroup issues tile j's scores and tile j-1's P V, softmaxes
//   tile j in the fp32 score registers while that product runs, and packs
//   them into the one P set only after it.  ptxas budgets each side of
//   setmaxnreg on its own (consumers 240 registers, the producer 24; the
//   launch reports 168), so d=128 takes 192-key tiles (96 score, 48 P and
//   64 accumulator registers): 2 to 9% faster than 128 or 176 keys there
//   (tools/torch_kernel_variants.py times these variants in one call).
//   The producer keeps every ring address as a 32-bit offset from one
//   register, or its cluster bookkeeping spills past 24.
// * Softmax beside the tensor cores.  Ping-pong: each consumer issues its
//   products only after the other has issued its own (named barriers 1 and
//   2), so one warpgroup's softmax runs while the other's products hold the
//   tensor cores.
// * Tail and epilogue.  A persistent grid: cluster x walks units (pairs of
//   query tiles of a head) x, x + clusters, ..., so the producer loads the
//   next unit's Q and K/V during a unit's last products and epilogue, and
//   the clusters running together share their heads' K/V in L2.  The host
//   picks the cluster count (flash_grid: as few clusters as finish in the
//   rounds the card's co-resident clusters need).  The ring is as deep as
//   227 KB holds: 3 stages of 128 keys (d=72, 88), 2 of 192 (d=128).
// * Still bound at 64% of the flop bound at Flux's 4608 tokens: the
//   exponentials (one ex2 per score on 16 special-function lanes an SM)
//   and the per-tile softmax issue beside the tensor cores; at d=72 and 88
//   the zero-filled columns of the second 64-column atom (QK^T depth 80 or
//   96 for 72 or 88) are products and shared-memory bytes spent on nothing.

#pragma once

#include <type_traits>

#include "hopper_common.cuh"

namespace dft {
namespace hopper {

// A block's shared memory: the Q tile, the K and V rings of C::kStages
// stages and their barriers, carved from dynamic shared memory aligned to
// 1024 bytes (the 128-byte swizzle repeats every 1024 bytes).  C gives the
// tile shapes.
template <typename C>
struct Ring {
  static constexpr int kStages = C::kStages;
  static constexpr size_t kBytes = 1024 + C::kQBytes + 2 * kStages * size_t(C::kKVBytes) + 128;
  static_assert((2 + 4 * kStages) * 8 <= 128, "the barriers fit their 128 bytes");
  uint8_t *qs, *ks, *vs;
  uint64_t *qbar, *kfull, *vfull, *kempty, *vempty, *qempty;

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
    qempty = vempty + kStages;
  }
  // 16-byte aligned space past the barriers (128 bytes hold them)
  __device__ uint8_t* end() const { return reinterpret_cast<uint8_t*>(qbar) + 128; }

  // One thread, before the block's __syncthreads: the producer's arrival
  // (with the bytes) fills a tile, one arrival per consumer warp empties it.
  __device__ void init() {
    mbar_init(qbar, 1);
    mbar_init(qempty, C::kWG * 4);
    // with clusters every CTA's producer writes its share of a K or V tile
    // into all of them, so each CTA's consumer warps empty the stage in all
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], C::kWG * 4 * C::kCluster);
      mbar_init(&vempty[s], C::kWG * 4 * C::kCluster);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The producer thread: the block's Q tile once, then the K and V tiles of
  // n_tiles key tiles.
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
// Two designs, chosen per width at compile time (kPingPong).  d=72, 88 and
// 128 (the DiTs' heads) take the persistent ping-pong kernel below; the
// U-Nets' 40, 64, 80 and 160 keep flash_fwd_hopper.
template <int D>
struct Cfg {
  static constexpr bool kPingPong = D == 72 || D == 88 || D == 128;
  static constexpr int kDP = (D + 15) / 16 * 16;           // QK^T depth (d=40 -> 48)
  static constexpr int kAtoms = (D + kAtom - 1) / kAtom;    // 64-column atoms per row
  static constexpr int kWG = 2;                             // consumer warpgroups
  static constexpr int kBM = 64 * kWG;                      // query rows per block
  // keys per tile.  flash_fwd_hopper keeps the scores (kBN/2 registers),
  // two P sets (kBN/4 each) and the accumulator (D/2): with 128 keys ptxas
  // spills 16 bytes at d=80 (and 40 at d=88 before the ping-pong kernel),
  // so d=160 takes 64.  The ping-pong kernel keeps one P set (scores, then
  // P, in the FA3 order): at d=128 192 keys (96 + 48 + 64 registers) fit a
  // consumer's 240, and ran 4 to 9% faster on an H100 than 128 or 176
  // keys; at d=72 and 88 192 keys ran no faster than 128.
  static constexpr int kBN = D == 128 ? 192 : (kPingPong || D <= 80 ? 128 : 64);
  static constexpr int kThreads = 128 * (kWG + 1);
  static constexpr uint32_t kQBytes = kAtoms * kBM * kAtomBytes;
  static constexpr uint32_t kKVBytes = kAtoms * kBN * kAtomBytes;   // K or V tile
  // K/V ring depth: the ping-pong kernel's as deep as 227 KB holds beside
  // Q, up to 3 (three stages of 128 two-atom keys, or two of 192: 224 KB)
  static constexpr int kFit = int((232448 - 1152 - kQBytes) / (2 * kKVBytes));
  static constexpr int kStages = kPingPong ? (kFit < 3 ? kFit : 3) : 2;
  // CTAs of a cluster: the ping-pong kernel's pair of neighbouring query
  // tiles of one head shares each K and V tile, half loaded by each CTA
  static constexpr int kCluster = kPingPong ? 2 : 1;
};

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_fwd_hopper(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, OutPtr out, int heads, int sq, int sk,
                 float scale_log2) {
  using C = Cfg<D>;
  constexpr int kBN = C::kBN, kStages = C::kStages;
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

// ------------------------------------------------- d = 72, 88, 128
// Persistent ping-pong kernel in clusters of kCluster CTAs.  Work unit u
// is the pair of query tiles 2p, 2p + 1 of head (b, h) = divmod(u / n_p,
// heads), p = u % n_p; CTA rank r of a cluster takes tile 2p + r, and the
// pair shares every K and V tile (each CTA loads half its rows into both).
// Cluster x takes units x, x + clusters, ... (the host picks the grid:
// flash_grid in ops/flash_attention.py), so the clusters running together
// share their heads' K and V in L2, and the producer loads the next unit's
// Q and first K/V tiles during a unit's last products and epilogue.
template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(Cfg<D>::kThreads, 1)
flash_fwd_pingpong(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, OutPtr out, int heads, int sq, int sk,
                   float scale_log2, int n_units) {
  using C = Cfg<D>;
  constexpr int kBN = C::kBN, kStages = C::kStages, kCluster = C::kCluster;
  extern __shared__ uint8_t smem_raw[];
  Ring<C> ring(smem_raw);
  uint8_t *qs = ring.qs, *ks = ring.ks, *vs = ring.vs;

  const int n_p = ((sq + C::kBM - 1) / C::kBM + kCluster - 1) / kCluster;
  const int n_tiles = (sk + kBN - 1) / kBN;

  if (threadIdx.x == 0) ring.init();
  cluster_sync();   // every CTA's barriers are initialised

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every load, unit after unit; the
    // K/V ring runs on across units
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      // ptxas budgets the 24 registers setmaxnreg leaves this thread on
      // their own, so every address is a 32-bit shared address at a fixed
      // offset from kfull[0] (Ring's layout): Q below it, then K's and V's
      // rings; qbar 8 bytes below, vfull, kempty, vempty and qempty 8, 16,
      // 24 and 32 kStages bytes above
      constexpr int kRows = kBN / kCluster;
      constexpr uint32_t kK = 8 + 2 * kStages * C::kKVBytes;   // kfull[0] - K's ring
      constexpr uint32_t kQ = kK + C::kQBytes;                  // kfull[0] - Q
      constexpr uint16_t kAll = (1u << kCluster) - 1;
      const int rank = int(cluster_rank());
      const uint32_t bar = smem_u32(ring.kfull);
      int it = 0, local = 0;
      for (int u = blockIdx.x / kCluster; u < n_units; u += gridDim.x / kCluster, ++local) {
        const int bh = u / n_p, b = bh / heads, h = bh % heads;
        // the consumers are done with the last unit's Q (a tile past Sq is
        // TMA's zero fill, computed and never stored)
        mbar_wait(bar + 32 * kStages, (local & 1) ^ 1);   // qempty
        mbar_expect_tx(bar - 8, C::kQBytes);               // qbar
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load(bar - kQ + a * C::kBM * kAtomBytes, &qmap, bar - 8, a * kAtom,
                   ((u % n_p) * kCluster + rank) * C::kBM, h, b);
        // each K and V tile: this CTA's rows into both CTAs of the cluster
        for (int j = 0; j < n_tiles; ++j, ++it) {
          const int s = it % kStages;
          const uint32_t parity = ((it / kStages) & 1) ^ 1;
          const uint32_t kfull = bar + 8 * s;
          const uint32_t dst = bar - kK + s * C::kKVBytes + rank * kRows * kAtomBytes;
          const int row = j * kBN + rank * kRows;
          mbar_wait(kfull + 16 * kStages, parity);   // kempty[s]
          mbar_expect_tx(kfull, C::kKVBytes);
          for (int a = 0; a < C::kAtoms; ++a)
            tma_load_multicast(dst + a * kBN * kAtomBytes, &kmap, kfull, a * kAtom, row, h, b,
                               kAll);
          mbar_wait(kfull + 24 * kStages, parity);   // vempty[s]
          mbar_expect_tx(kfull + 8 * kStages, C::kKVBytes);   // vfull[s]
          for (int a = 0; a < C::kAtoms; ++a)
            tma_load_multicast(dst + kStages * C::kKVBytes + a * kBN * kAtomBytes, &vmap,
                               kfull + 8 * kStages, a * kAtom, row, h, b, kAll);
        }
      }
    }
  } else {
    // ---- consumer warpgroup c: query rows q0 + 64c .. q0 + 64c + 63 of each unit
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const uint32_t q_addr = smem_u32(qs) + c * 64 * kAtomBytes;

    float o[D / 2];
    float m[2], l[2];                      // running max (unscaled), this lane's denominators
    float sc[kBN / 2], alpha[2];
    uint32_t p[kBN / 4];

    // S = Q K^T of ring position it into sc, issued and committed
    auto issue_s = [&](int it) {
      const int s = it % kStages;
      const uint32_t k_addr = smem_u32(ks + s * C::kKVBytes);
      mbar_wait(&ring.kfull[s], (it / kStages) & 1);
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
    // O += P V of ring position it, issued and committed
    auto issue_pv = [&](int it) {
      const int s = it % kStages;
      const uint32_t v_addr = smem_u32(vs + s * C::kKVBytes);
      mbar_wait(&ring.vfull[s], (it / kStages) & 1);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<T, D>(o, &p[kk * 4],
                       sw128_desc(v_addr + kk * 16 * kAtomBytes, kBN * kAtomBytes, 1024), 1);
      wgmma_commit();
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // a K or V stage: free in every CTA of the cluster (each wrote into it)
    auto release_kv = [&](uint64_t* bar) {
      __syncwarp();
      if (lane < kCluster) mbar_arrive_cluster(bar, lane);
    };
    // the online softmax of key tile j's scores, in place: sc becomes the
    // unnormalised probabilities (fp32), alpha the factor that rescales
    // the rows' earlier sums
    auto softmax = [&](int j) {
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
          sc[n * 4 + 2 * r] = fast_exp2(fmaf(sc[n * 4 + 2 * r], scale_log2, -m_scaled));
          sc[n * 4 + 2 * r + 1] = fast_exp2(fmaf(sc[n * 4 + 2 * r + 1], scale_log2, -m_scaled));
          sum += sc[n * 4 + 2 * r] + sc[n * 4 + 2 * r + 1];
        }
        l[r] = l[r] * alpha[r] + sum;
      }
    };
    // the probabilities as P V's A fragments: 16 keys (8-key blocks 2kk,
    // 2kk+1) per k-step
    auto to_p = [&]() {
#pragma unroll
      for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          p[(n / 2) * 4 + (n % 2) * 2 + r] = pack2<T>(sc[n * 4 + 2 * r], sc[n * 4 + 2 * r + 1]);
      }
    };
    auto rescale = [&]() {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n * 4 + 0] *= alpha[0];
        o[n * 4 + 1] *= alpha[0];
        o[n * 4 + 2] *= alpha[1];
        o[n * 4 + 3] *= alpha[1];
      }
    };
    // Ping-pong: consumer c issues its products once the other consumer has
    // issued its own (named barrier 1 + c, which the other arrives on), so
    // one warpgroup's softmax runs while the other's products hold the
    // tensor cores.  Consumer 0 goes first: consumer 1's first arrival on
    // consumer 0's barrier comes now, every later one after its products.
    if (c == 1) named_arrive(1, 256);
    auto my_turn = [&]() { named_sync(1 + c, 256); };
    auto your_turn = [&]() { named_arrive(2 - c, 256); };

    int it = 0, local = 0;
    for (int u = blockIdx.x / kCluster; u < n_units; u += gridDim.x / kCluster, ++local) {
      const int bh = u / n_p, b = bh / heads, h = bh % heads;
      const int q0 = ((u % n_p) * kCluster + int(cluster_rank())) * C::kBM;
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
      mbar_wait(ring.qbar, local & 1);

      // FA3's order within a warpgroup: tile j's scores run on the tensor
      // cores while tile j-1's P V is issued behind them; tile j's softmax
      // (in the score registers) overlaps that product, and the one P set
      // is rewritten only once the product that read it is done.
      my_turn();
      issue_s(it);
      your_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      release_kv(&ring.kempty[it % kStages]);
      if (n_tiles == 1) release(ring.qempty);
      softmax(0);
      to_p();
      for (int j = 1; j < n_tiles; ++j) {
        my_turn();
        issue_s(it + j);
        rescale();
        issue_pv(it + j - 1);
        your_turn();
        wgmma_wait<1>();   // the scores; the product may still run
        fence_regs(sc);
        release_kv(&ring.kempty[(it + j) % kStages]);
        if (j == n_tiles - 1) release(ring.qempty);
        softmax(j);
        wgmma_wait<0>();
        fence_regs(o);
        release_kv(&ring.vempty[(it + j - 1) % kStages]);
        to_p();
      }
      rescale();
      issue_pv(it + n_tiles - 1);
      wgmma_wait<0>();
      fence_regs(o);
      release_kv(&ring.vempty[(it + n_tiles - 1) % kStages]);
      it += n_tiles;

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
  // no CTA leaves while the other may still arrive on its barriers
  cluster_sync();
}

// ------------------------------------------------------------ d = 512
struct Cfg512 {
  static constexpr int D = 512;
  static constexpr int kAtoms = D / kAtom;   // 8
  static constexpr int kWG = 2;              // consumer warpgroups
  static constexpr int kBM = 64;             // query rows per block
  static constexpr int kBN = 32;             // keys per tile, 16 per consumer
  static constexpr int kStages = 2;          // K/V ring depth
  static constexpr int kCluster = 1;
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
  constexpr int kBN = C::kBN, kStages = C::kStages;
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

// The launch configuration of the ping-pong kernel at width D: grid blocks
// in clusters of Cfg<D>::kCluster.
template <int D>
cudaLaunchConfig_t pingpong_config(int grid, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(Cfg<D>::kThreads);
  cfg.dynamicSmemBytes = Ring<Cfg<D>>::kBytes;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = Cfg<D>::kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// q, k, v, o: (b, h, s, d) with strides[0..11] = (sb, sh, ss) of q, k, v, o.
// grid: the ping-pong kernel's block count, kCluster times its clusters (1
// to its b * h * ceil(ceil(sq / 128) / kCluster) units); the other widths
// launch one block per tile and ignore it.
template <typename T, int D, bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int b, int h, int sq,
           int sk, float scale, const long long* strides, int grid, cudaStream_t stream) {
  constexpr bool kWide = D == 512;
  using C = std::conditional_t<kWide, Cfg512, Cfg<D>>;
  constexpr int kBM = C::kBM, kBN = C::kBN, kThreads = C::kThreads;
  constexpr size_t kSmem = Ring<C>::kBytes + (kWide ? Cfg512::kXBytes : 0);
  static_assert(kSmem <= 232448, "more shared memory than a block has");
  CUtensorMap qm, km, vm;
  int err;
  if ((err = make_map<T>(&qm, q, b, h, sq, D, strides, kBM))) return err;
  // with clusters each CTA loads 1 / kCluster of a K or V tile's rows
  if ((err = make_map<T>(&km, k, b, h, sk, D, strides + 3, kBN / C::kCluster))) return err;
  if ((err = make_map<T>(&vm, v, b, h, sk, D, strides + 6, kBN / C::kCluster))) return err;
  const OutPtr out{o, lse, strides[9], strides[10], strides[11]};
  const float scale_log2 = scale * 1.4426950408889634f;
  if constexpr (kWide) {
    constexpr auto kernel = flash_fwd_hopper_d512<T>;
    if ((err = allow_smem<kernel>(kSmem))) return err;
    kernel<<<dim3((sq + kBM - 1) / kBM, b * h), kThreads, kSmem, stream>>>(qm, km, vm, out, h, sq,
                                                                          sk, scale_log2);
  } else if constexpr (C::kPingPong) {
    const long long units =
        (long long)b * h * (((sq + kBM - 1) / kBM + C::kCluster - 1) / C::kCluster);
    if (units > 2147483647ll || grid < C::kCluster || grid % C::kCluster ||
        grid / C::kCluster > units)
      return int(cudaErrorInvalidValue);
    constexpr auto kernel = flash_fwd_pingpong<T, D, kLse>;
    if ((err = allow_smem<kernel>(kSmem))) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = pingpong_config<D>(grid, stream, attr);
    if ((err = int(cudaLaunchKernelEx(&cfg, kernel, qm, km, vm, out, h, sq, sk, scale_log2,
                                      int(units)))))
      return err;
  } else {
    constexpr auto kernel = flash_fwd_hopper<T, D, kLse>;
    if ((err = allow_smem<kernel>(kSmem))) return err;
    kernel<<<dim3((sq + kBM - 1) / kBM, b * h), kThreads, kSmem, stream>>>(qm, km, vm, out, h, sq,
                                                                          sk, scale_log2);
  }
  return int(cudaGetLastError());
}

// How many clusters of the ping-pong kernel at width d the card holds at
// once (the host's persistent grid is at most that many), or 0 where d has
// no ping-pong kernel; a negative cudaError_t on failure.
template <typename T, int D>
int pingpong_slots() {
  constexpr auto kernel = flash_fwd_pingpong<T, D, false>;
  int err = allow_smem<kernel>(Ring<Cfg<D>>::kBytes);
  if (err) return -err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = pingpong_config<D>(Cfg<D>::kCluster, nullptr, attr);
  int n = 0;
  if ((err = int(cudaOccupancyMaxActiveClusters(&n, kernel, &cfg)))) return -err;
  return n;
}
template <typename T>
int cluster_slots(int d) {
  switch (d) {
    case 72: return pingpong_slots<T, 72>();
    case 88: return pingpong_slots<T, 88>();
    case 128: return pingpong_slots<T, 128>();
    default: return 0;
  }
}

// The body of each type's C entry point, dft_flash_attention_forward(q, k,
// v, o, lse, b, h, sq, sk, d, dtype, scale, strides, grid, stream), whose
// contract this is (flash_bf16.cu, flash_fp16.cu and flash_f32.cu share
// it): q, k, v, o are (b, h, s, d) device tensors of one dtype with unit
// stride on d; strides[0..11] are (sb, sh, ss) in elements of q, k, v and
// o, each a multiple of 16 bytes, and every base 16-byte aligned.  lse:
// null (B1), or a contiguous fp32 (b*h, sq) buffer that receives each row's
// logsumexp (B2).  dtype: 0 float32, 1 float16, 2 bfloat16; each library
// takes its own type only.  grid: the ping-pong kernel's block count
// (ops/flash_attention.py's flash_grid), which the kernels that launch one
// block per tile ignore.
// Launches on `stream` without synchronising and returns a cudaError_t.
// B1 at every width, B2 at the U-Nets' and DiTs' widths only: the VAE's
// d=512 head never feeds the attention store.
template <typename T>
int forward(const void* q, const void* k, const void* v, void* o, float* lse, int b, int h, int sq,
            int sk, int d, float scale, const long long* strides, int grid, cudaStream_t s) {
  if (lse != nullptr) {
    switch (d) {
      case 40: return launch<T, 40, true>(q, k, v, o, lse, b, h, sq, sk, scale, strides, grid, s);
      case 64: return launch<T, 64, true>(q, k, v, o, lse, b, h, sq, sk, scale, strides, grid, s);
      case 72: return launch<T, 72, true>(q, k, v, o, lse, b, h, sq, sk, scale, strides, grid, s);
      case 80: return launch<T, 80, true>(q, k, v, o, lse, b, h, sq, sk, scale, strides, grid, s);
      case 88: return launch<T, 88, true>(q, k, v, o, lse, b, h, sq, sk, scale, strides, grid, s);
      case 128: return launch<T, 128, true>(q, k, v, o, lse, b, h, sq, sk, scale, strides, grid, s);
      case 160: return launch<T, 160, true>(q, k, v, o, lse, b, h, sq, sk, scale, strides, grid, s);
      default: return int(cudaErrorInvalidValue);
    }
  }
  switch (d) {
    case 40: return launch<T, 40, false>(q, k, v, o, lse, b, h, sq, sk, scale, strides, grid, s);
    case 64: return launch<T, 64, false>(q, k, v, o, lse, b, h, sq, sk, scale, strides, grid, s);
    case 72: return launch<T, 72, false>(q, k, v, o, lse, b, h, sq, sk, scale, strides, grid, s);
    case 80: return launch<T, 80, false>(q, k, v, o, lse, b, h, sq, sk, scale, strides, grid, s);
    case 88: return launch<T, 88, false>(q, k, v, o, lse, b, h, sq, sk, scale, strides, grid, s);
    case 128: return launch<T, 128, false>(q, k, v, o, lse, b, h, sq, sk, scale, strides, grid, s);
    case 160: return launch<T, 160, false>(q, k, v, o, lse, b, h, sq, sk, scale, strides, grid, s);
    case 512: return launch<T, 512, false>(q, k, v, o, lse, b, h, sq, sk, scale, strides, grid, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace hopper
}  // namespace dft
