// Head-mean attention probabilities for Hopper (sm_90a), bf16 and fp16:
//   out[b, i, j] = (1/H) * sum_h exp(q[b,h,i] . k[b,h,j] * scale - lse[b,h,i])
// for (B, H, S, D) q and k and the per-row logsumexp that B2 wrote, so each
// head's (Sq, Sk) map is normalised without a second softmax pass and the
// per-head (B, H, Sq, Sk) tensor never exists.  fp32 accumulation, output
// in the input's type.  headmean_bf16.cu and headmean_fp16.cu instantiate
// it, one type each; float32 takes the exact kernel of headmean_f32.cu.
//
// Replaces diffusion_feature_tpu/ops/flash_attention.py::_headmean_kernel
// (B3).  The TPU kernel took 256x256 VMEM blocks and ran the heads as a
// sequential grid axis, the sum carried in VMEM scratch.  Here the mean over
// heads stays in registers: a block owns a 128-row x 128-key output tile of
// one batch element and walks all H heads itself (no atomics, no second
// pass), then takes the next tile (a persistent grid of one block per SM).
//
// What bounds it: at (2,10,4096,4096,64) it does 2*B*H*Sq*Sk*D = 42.9 GFLOP
// (43.4 us at 989 TFLOP/s) and writes a 67 MB map (20 us at 3.35 TB/s), but
// its B*H*Sq*Sk = 3.4e8 exponentials, one per head and score on the
// special-function units (16 per clock per SM), take 80 to 90 us: that is the
// practical floor.  Next comes L2: every tile reads each head's Q and K
// tiles again, (128 + 128) rows x D per 128 x 128 outputs, ~0.67 GB per call
// at that shape.  The design spends nothing else per score (one FFMA, one
// ex2, one FADD; no max, no sum), and keeps the loads off the critical path:
//
// * Warp specialisation.  Warpgroup 0 is the producer (setmaxnreg 24); one
//   thread issues every TMA load.  Two consumer warpgroups (240 registers)
//   each own 64 of the tile's rows and share its K tile, so a block reads
//   Q and K once per head for 16384 outputs (a 64 x 256 tile per block would
//   read 25% more per output).
// * A ring over heads.  Each stage holds one head's Q tile (128 rows) and K
//   tile (128 keys), filled by one "full" mbarrier that counts the bytes and
//   released by an "empty" one that each consumer warp arrives on.  The
//   ring runs on across tiles, so the producer loads the next tile's first
//   heads during this tile's epilogue.  Stages: 4 at d <= 64, 3 at d=72/80/88/128,
//   2 at d=160 (what fits beside the output staging in 227 KB).  The tensor
//   maps are 4-d (d, s, h, b) with the caller's strides, so the head-split
//   views of (B, S, H*D) projections are read in place; TMA zero-fills rows
//   past Sq or Sk and the columns of d=40/72/80/88/160 up to the next 64-column
//   atom (d=40's QK^T depth is 48, d=72's 80, d=88's 96).
// * wgmma.  Each consumer computes its 64 x 128 scores with m64n128k16 from
//   shared memory (Q and K K-major, 128-byte swizzle) into registers, waits
//   for them and exponentiates them into its sum; the two warpgroups
//   alternate on their own, one's product on the tensor cores while the
//   other's exponentials run.  One score set (64 registers) beside the sum
//   (64): a second set, to overlap inside a warpgroup as B1 does, left
//   ptxas short of registers (it spilled, and the kernel ran slower).
// * The logsumexp rows come from global memory two heads ahead of their
//   use, into two register pairs (even and odd heads; the next tile's first
//   two under this tile's epilogue).  Loaded one head ahead and copied
//   from one register to another, each head waited for its load there.
// * Exponentials: exp2(s * scale * log2(e) - lse * log2(e)), the scale and
//   log2(e) folded into one FFMA, all on the special-function unit
//   (ex2.approx).  Moving every other 8-key block to the FMA pipe (a
//   round-to-integer split and a degree-3 polynomial, ~10 instructions
//   against 3) ran slower on the H100, so none moves.
// * Tile size.  128 x 128 for every shape: (2,20,1024,1024) gives 128 tiles
//   on 132 SMs (one each) and (2,10,4096,4096) 2048 (15.5 per SM); 128 x 256
//   tiles would leave half the card idle at 1024 tokens.
// * Epilogue.  The sum times 1/H, cast, is staged in shared memory in TMA's
//   128-byte swizzle (the fragment stores free of bank conflicts) and
//   written by two TMA stores, which clip rows past Sq and columns past Sk
//   and run while the warpgroup starts its next tile (every SM reaches its
//   epilogue at about the same time, so the writes come in bursts).  Where
//   Sk is not a multiple of 8 the rows are not 16-byte aligned, which TMA
//   needs, and the warps store the elements themselves.
//
// At the DiTs' d=72 and 88 the lone kernel above ran at 17 to 19% of its
// bound, 1.8x d=64's time per head for 1.125x the columns.  Its Q and K
// re-reads bound it: a 144- or 176-byte row of a head-split view straddles
// 32-byte sectors, so each 128 x 128 tile reads ~1.4x d=64's bytes a row
// from L2, and it ran at the L2 rate d=64's tiles reach.  headmean_cluster
// (below) halves those reads with 2 x 2 clusters sharing Q and K tiles by
// multicast: 16 to 32% faster where every SM walks several tiles (PixArt's
// 4096 tokens), 18 to 31% slower where the tiles fit one round (1024
// tokens: the four CTAs' lockstep), so the host picks it per call
// (headmean_clusters in ops/flash_attention.py; tools/
// torch_kernel_variants.py times both).  Measured on an H100 80GB HBM3
// (700 W), it still takes 2.7x its exponentials' floor: each warpgroup
// waits for its product before its exponentials, and the two warpgroups
// alone do not cover that.  A second score set (two heads in flight a
// warpgroup) spilled past the consumers' 240 registers, and two 64-key
// halves in flight ran slower.

#pragma once

#include "hopper_common.cuh"

namespace dft {
namespace hopper {
namespace headmean {

constexpr int kWG = 2;                   // consumer warpgroups
constexpr int kBM = 64 * kWG;            // query rows per tile
constexpr int kBN = 128;                 // keys per tile
constexpr int kThreads = 128 * (kWG + 1);
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kHalfBytes = 64 * 128;     // 64 rows x 64 output columns, one staged half

template <int D>
struct Cfg {
  static constexpr int kDP = (D + 15) / 16 * 16;           // QK^T depth (d=40 -> 48)
  static constexpr int kAtoms = (D + kAtom - 1) / kAtom;    // 64-column atoms per row
  static constexpr uint32_t kQBytes = kAtoms * kBM * kAtomBytes;
  static constexpr uint32_t kStageBytes = kQBytes + kAtoms * kBN * kAtomBytes;
  static constexpr int kStages = kAtoms == 1 ? 4 : (kAtoms == 2 ? 3 : 2);
  static constexpr uint32_t kOutBytes = kBM * kBN * 2;      // the staged output tile
  static constexpr size_t kSmem = 1024 + size_t(kStages) * kStageBytes + kOutBytes + 128;
  static_assert(kSmem <= 232448, "more shared memory than a block has");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
headmean_hopper(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap omap, bool tma_out,
                const float* __restrict__ lse, T* __restrict__ out, int batch, int heads, int sq,
                int sk, float scale_log2) {
  using C = Cfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  uint8_t* staged = ring + C::kStages * C::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + C::kOutBytes);
  uint64_t* empty = full + C::kStages;

  const int n_q = (sq + kBM - 1) / kBM, n_k = (sk + kBN - 1) / kBN;
  const int n_tiles = batch * n_q * n_k;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread loads every head's Q and K tile of every tile
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int kt = tile % n_k, qt = (tile / n_k) % n_q, b = tile / (n_k * n_q);
        for (int h = 0; h < heads; ++h, ++it) {
          const int s = it % C::kStages;
          mbar_wait(&empty[s], ((it / C::kStages) & 1) ^ 1);
          uint8_t* qs = ring + s * C::kStageBytes;
          uint8_t* ks = qs + C::kQBytes;
          mbar_expect_tx(&full[s], C::kStageBytes);
          for (int a = 0; a < C::kAtoms; ++a) {
            tma_load(qs + a * kBM * kAtomBytes, &qmap, &full[s], a * kAtom, qt * kBM, h, b);
            tma_load(ks + a * kBN * kAtomBytes, &kmap, &full[s], a * kAtom, kt * kBN, h, b);
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroup c: rows 64c .. 64c + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    uint8_t* stage_c = staged + c * 64 * kBN * 2;   // this warpgroup's 64 x 128 output rows
    int it = 0;

    // S = Q_h K_h^T of ring position i into sc, issued and committed
    auto issue = [&](float (&sc)[kBN / 2], int i) {
      const int s = i % C::kStages;
      const uint32_t q_addr = smem_u32(ring + s * C::kStageBytes) + c * 64 * kAtomBytes;
      const uint32_t k_addr = smem_u32(ring + s * C::kStageBytes + C::kQBytes);
      mbar_wait(&full[s], (i / C::kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kDP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes into the atom
        wgmma_ss<T, kBN>(sc, sw128_desc(q_addr + (kk / 4) * kBM * kAtomBytes + off, 16, 1024),
                         sw128_desc(k_addr + (kk / 4) * kBN * kAtomBytes + off, 16, 1024),
                         kk > 0);
      }
      wgmma_commit();
    };

    // head h's logsumexp of this lane's two rows of `tile` (rows past Sq
    // read the last row's: any finite value does, they are never written).
    // Nothing reads the loaded registers until their head comes.
    auto lse2 = [&](int tile, int h, float& l0, float& l1) {
      const int qt = (tile / n_k) % n_q, b = tile / (n_k * n_q);
      const int row = qt * kBM + c * 64 + warp * 16 + g;
      const float* p = lse + (size_t(b) * heads + h) * sq;
      l0 = __ldg(p + min(row, sq - 1));
      l1 = __ldg(p + min(row + 8, sq - 1));
    };
    // Two sets of logsumexp registers, one for even and one for odd heads.
    // Each is reloaded for head h+2 right after head h used it, so a load has
    // a whole head's work to arrive in: a value copied from one register to
    // another the next head would wait for its load there, every head.
    float la0 = 0.f, la1 = 0.f, lb0 = 0.f, lb1 = 0.f;
    if (int(blockIdx.x) < n_tiles) {
      lse2(blockIdx.x, 0, la0, la1);
      if (heads > 1) lse2(blockIdx.x, 1, lb0, lb1);
    }

    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
      const int kt = tile % n_k, qt = (tile / n_k) % n_q, b = tile / (n_k * n_q);
      float acc[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
      // one head: its scores, then their exponentials into the sum; the
      // other warpgroup's product runs on the tensor cores meanwhile
      float sc[kBN / 2];
      auto head = [&](int h, float& l0, float& l1) {
        issue(sc, it);
        wgmma_wait<0>();
        fence_regs(sc);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[it % C::kStages]);
        const float m0 = -l0 * kLog2e, m1 = -l1 * kLog2e;
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n * 4 + e] += fast_exp2(fmaf(sc[n * 4 + e], scale_log2, e < 2 ? m0 : m1));
        }
        if (h + 2 < heads) lse2(tile, h + 2, l0, l1);
        ++it;
      };
      int h = 0;
      for (; h + 1 < heads; h += 2) {
        head(h, la0, la1);
        head(h + 1, lb0, lb1);
      }
      if (h < heads) head(h, la0, la1);
      // the next tile's first two heads, loaded under the epilogue
      if (tile + int(gridDim.x) < n_tiles) {
        lse2(tile + gridDim.x, 0, la0, la1);
        if (heads > 1) lse2(tile + gridDim.x, 1, lb0, lb1);
      }

      // epilogue: the warpgroup's 64 x 128 tile, times 1/H and cast, staged
      // as two 64-column halves in TMA's 128-byte swizzle (16-byte chunk j of
      // row r at chunk j ^ (r % 8): the fragment stores hit 32 banks)
      const float inv = 1.f / heads;
      if (tid == 0) bulk_wait<0, true>();   // the last tile's store has read the staging
      named_sync(1 + c, 128);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n)
          *reinterpret_cast<uint32_t*>(stage_c + (n / 8) * kHalfBytes + row * 128 +
                                       (((n % 8) ^ (row & 7)) * 16) + t * 4) =
              pack2<T>(acc[n * 4 + 2 * r] * inv, acc[n * 4 + 2 * r + 1] * inv);
      }
      const int q_base = qt * kBM + c * 64, k_base = kt * kBN;
      if (tma_out) {
        // one thread stores both halves; TMA clips rows past Sq and columns
        // past Sk, and the warpgroup goes on to its next tile meanwhile
        fence_proxy_async();
        named_sync(1 + c, 128);
        if (tid == 0) {
          tma_store_3d(&omap, stage_c, k_base, q_base, b);
          tma_store_3d(&omap, stage_c + kHalfBytes, k_base + 64, q_base, b);
          bulk_commit();
        }
      } else {
        // rows of Sk % 8 != 0 elements are not 16-byte aligned, which TMA
        // needs: element stores, two rows of 128 columns per warp pass
        named_sync(1 + c, 128);
        for (int i = 0; i < 64 * kBN / 8 / 128; ++i) {
          const int idx = i * 128 + tid, row = idx / (kBN / 8), j = idx % (kBN / 8);
          const int grow = q_base + row, col = k_base + j * 8;
          if (grow >= sq || col >= sk) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(stage_c + (j / 8) * kHalfBytes +
                                                          row * 128 + (((j % 8) ^ (row & 7)) * 16));
          const T* e = reinterpret_cast<const T*>(&v);
          T* dst = out + (size_t(b) * sq + grow) * sk + col;
          for (int u = 0; u < 8 && col + u < sk; ++u) dst[u] = e[u];
        }
      }
    }
    if (tid == 0) bulk_wait<0, false>();   // the last store is done before the block ends
  }
}

// The DiTs' d=72 and 88 in clusters of four CTAs: a cluster owns 2 x 2
// output tiles (query tiles 2i, 2i + 1, key tiles 2j, 2j + 1) of one batch
// element and walks the heads over all four; CTA rank r takes query tile
// 2i + (r >> 1) and key tile 2j + (r & 1).  The two CTAs of a query tile
// each load half its rows into both (multicast), the two of a key tile
// likewise, so a CTA reads half the Q and K bytes from L2 that
// headmean_hopper does: at these widths a row of a head-split view is 144
// or 176 bytes, so its reads straddle 32-byte sectors and the lone kernel
// is bound by L2, not by its exponentials.  The host picks it per call
// (headmean_clusters in ops/flash_attention.py: where the lone kernel's
// tiles take more than one round of the card) and the cluster count.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
headmean_cluster(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap omap, bool tma_out,
                 const float* __restrict__ lse, T* __restrict__ out, int batch, int heads, int sq,
                 int sk, float scale_log2, int clusters) {
  using C = Cfg<D>;
  constexpr int kCluster = 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw_addr = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((raw_addr + 1023) & ~1023u) - raw_addr);
  uint8_t* staged = ring + C::kStages * C::kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + C::kOutBytes);
  uint64_t* empty = full + C::kStages;

  // units of 2 x 2 tiles; unit u is key pair u % n_kp of query pair
  // (u / n_kp) % n_qp of batch element u / (n_kp * n_qp)
  const int n_qp = (sq + 2 * kBM - 1) / (2 * kBM), n_kp = (sk + 2 * kBN - 1) / (2 * kBN);
  const int n_units = batch * n_qp * n_kp;

  if (threadIdx.x == 0) {
    // a stage is written by this CTA's producer and those of the CTAs that
    // share its query or key tile: one arrival per consumer warp of each of
    // the three empties it
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG * 4 * 3);
    }
    mbar_fence_init();
  }
  cluster_sync();   // every CTA's barriers are initialised

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread loads this CTA's halves of every head's Q
    // and K tiles, each into the two CTAs that share it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      const int rank = int(cluster_rank()), qi = rank >> 1, kj = rank & 1;
      // 32-bit shared addresses at fixed offsets from full[0] (the 24
      // registers setmaxnreg leaves this thread are ptxas's budget here):
      // the ring kRing below it, empty[0] kStages barriers above
      constexpr uint32_t kRing = C::kStages * C::kStageBytes + C::kOutBytes;
      const uint32_t full_s = smem_u32(full);
      int it = 0;
      for (int u = blockIdx.x / kCluster; u < n_units; u += clusters) {
        const int q0 = (((u / n_kp) % n_qp) * 2 + qi) * kBM + kj * 64;
        const int k0 = ((u % n_kp) * 2 + kj) * kBN + qi * 64, b = u / (n_kp * n_qp);
        for (int h = 0; h < heads; ++h, ++it) {
          const int s = it % C::kStages;
          const uint32_t stage = full_s - kRing + s * C::kStageBytes;
          mbar_wait(full_s + 8 * (C::kStages + s), ((it / C::kStages) & 1) ^ 1);   // empty[s]
          mbar_expect_tx(full_s + 8 * s, C::kStageBytes);
          for (int a = 0; a < C::kAtoms; ++a) {
            // query rows 64 kj .. to ranks 2 qi and 2 qi + 1, key rows
            // 64 qi .. to ranks kj and kj + 2
            tma_load_multicast(stage + (a * kBM + kj * 64) * kAtomBytes, &qmap, full_s + 8 * s,
                               a * kAtom, q0, h, b, uint16_t(3u << (2 * qi)));
            tma_load_multicast(stage + C::kQBytes + (a * kBN + qi * 64) * kAtomBytes, &kmap,
                               full_s + 8 * s, a * kAtom, k0, h, b, uint16_t(5u << kj));
          }
        }
      }
    }
  } else {
    // ---- consumer warpgroup c: rows 64c .. 64c + 63 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    uint8_t* stage_c = staged + c * 64 * kBN * 2;   // this warpgroup's 64 x 128 output rows
    int it = 0;

    // S = Q_h K_h^T of ring position i into sc, issued and committed
    auto issue = [&](float (&sc)[kBN / 2], int i) {
      const int s = i % C::kStages;
      const uint32_t q_addr = smem_u32(ring + s * C::kStageBytes) + c * 64 * kAtomBytes;
      const uint32_t k_addr = smem_u32(ring + s * C::kStageBytes + C::kQBytes);
      mbar_wait(&full[s], (i / C::kStages) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::kDP / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes into the atom
        wgmma_ss<T, kBN>(sc, sw128_desc(q_addr + (kk / 4) * kBM * kAtomBytes + off, 16, 1024),
                         sw128_desc(k_addr + (kk / 4) * kBN * kAtomBytes + off, 16, 1024),
                         kk > 0);
      }
      wgmma_commit();
    };

    // head h's logsumexp of this lane's two rows of unit u (rows past Sq
    // read the last row's: any finite value does, they are never written)
    auto lse2 = [&](int u, int h, float& l0, float& l1) {
      const int row = (((u / n_kp) % n_qp) * 2 + (int(cluster_rank()) >> 1)) * kBM + c * 64 +
                      warp * 16 + g;
      const float* p = lse + (size_t(u / (n_kp * n_qp)) * heads + h) * sq;
      l0 = __ldg(p + min(row, sq - 1));
      l1 = __ldg(p + min(row + 8, sq - 1));
    };
    // two sets of logsumexp registers, even and odd heads, each reloaded
    // two heads ahead of its use (as headmean_hopper's)
    float la0 = 0.f, la1 = 0.f, lb0 = 0.f, lb1 = 0.f;
    if (int(blockIdx.x / kCluster) < n_units) {
      lse2(blockIdx.x / kCluster, 0, la0, la1);
      if (heads > 1) lse2(blockIdx.x / kCluster, 1, lb0, lb1);
    }

    for (int u = blockIdx.x / kCluster; u < n_units; u += clusters) {
      float acc[kBN / 2];
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
      float sc[kBN / 2];
      auto head = [&](int h, float& l0, float& l1) {
        issue(sc, it);
        wgmma_wait<0>();
        fence_regs(sc);
        // the stage is free here and in the CTAs that wrote into it
        // (ranks rank ^ 1 and rank ^ 2)
        __syncwarp();
        if (lane < 3) {
          const uint32_t rank = cluster_rank();
          mbar_arrive_cluster(&empty[it % C::kStages], lane == 0 ? rank : rank ^ lane);
        }
        const float m0 = -l0 * kLog2e, m1 = -l1 * kLog2e;
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[n * 4 + e] += fast_exp2(fmaf(sc[n * 4 + e], scale_log2, e < 2 ? m0 : m1));
        }
        if (h + 2 < heads) lse2(u, h + 2, l0, l1);
        ++it;
      };
      int h = 0;
      for (; h + 1 < heads; h += 2) {
        head(h, la0, la1);
        head(h + 1, lb0, lb1);
      }
      if (h < heads) head(h, la0, la1);
      if (u + clusters < n_units) {
        lse2(u + clusters, 0, la0, la1);
        if (heads > 1) lse2(u + clusters, 1, lb0, lb1);
      }

      // epilogue as headmean_hopper's; a tile past Sq or Sk (an odd tile
      // count) is computed on TMA's zero fill and never stored
      const float inv = 1.f / heads;
      if (tid == 0) bulk_wait<0, true>();
      named_sync(1 + c, 128);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + g + 8 * r;
#pragma unroll
        for (int n = 0; n < kBN / 8; ++n)
          *reinterpret_cast<uint32_t*>(stage_c + (n / 8) * kHalfBytes + row * 128 +
                                       (((n % 8) ^ (row & 7)) * 16) + t * 4) =
              pack2<T>(acc[n * 4 + 2 * r] * inv, acc[n * 4 + 2 * r + 1] * inv);
      }
      const int rank = int(cluster_rank());
      const int q_base = (((u / n_kp) % n_qp) * 2 + (rank >> 1)) * kBM + c * 64;
      const int k_base = ((u % n_kp) * 2 + (rank & 1)) * kBN, b = u / (n_kp * n_qp);
      if (tma_out) {
        fence_proxy_async();
        named_sync(1 + c, 128);
        if (tid == 0 && q_base < sq && k_base < sk) {
          tma_store_3d(&omap, stage_c, k_base, q_base, b);
          tma_store_3d(&omap, stage_c + kHalfBytes, k_base + 64, q_base, b);
          bulk_commit();
        }
      } else {
        named_sync(1 + c, 128);
        for (int i = 0; i < 64 * kBN / 8 / 128; ++i) {
          const int idx = i * 128 + tid, row = idx / (kBN / 8), j = idx % (kBN / 8);
          const int grow = q_base + row, col = k_base + j * 8;
          if (grow >= sq || col >= sk) continue;
          const uint4 v = *reinterpret_cast<const uint4*>(stage_c + (j / 8) * kHalfBytes +
                                                          row * 128 + (((j % 8) ^ (row & 7)) * 16));
          const T* e = reinterpret_cast<const T*>(&v);
          T* dst = out + (size_t(b) * sq + grow) * sk + col;
          for (int x = 0; x < 8 && col + x < sk; ++x) dst[x] = e[x];
        }
      }
    }
    if (tid == 0) bulk_wait<0, false>();   // the last store is done before the block ends
  }
  // no CTA leaves while another may still arrive on its barriers or write
  // into its ring
  cluster_sync();
}

// ------------------------------------------------------------ host side
// The contiguous (b, sq, sk) output as a 3-d map (sk, sq, b) written in
// boxes of 64 columns x 64 rows, 128-byte swizzle; sk % 8 == 0.
template <typename T>
inline int make_out_map(CUtensorMap* map, void* ptr, int b, int sq, int sk) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return int(cudaErrorNotSupported);
  const cuuint64_t dims[3] = {cuuint64_t(sk), cuuint64_t(sq), cuuint64_t(b)};
  const cuuint64_t bytes[2] = {cuuint64_t(sk) * sizeof(T), cuuint64_t(sk) * sq * sizeof(T)};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult res = enc(map, MapType<T>::value, 3, ptr, dims, bytes, box, unit,
                           CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                           CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : int(cudaErrorInvalidValue);
}

// The 4-CTA cluster launch of headmean_cluster at width D.
template <int D>
cudaLaunchConfig_t cluster_config(int clusters, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * 4);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Cfg<D>::kSmem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 4;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// q (b, h, sq, d) and k (b, h, sk, d) with strides[0..5] = (sb, sh, ss) of q
// and k; lse contiguous fp32 (b, h, sq); out contiguous (b, sq, sk).
// clusters: 0 for headmean_hopper (a persistent grid of one block per SM),
// else headmean_cluster's cluster count (d=72 and 88 only).
template <typename T, int D>
int launch(const void* q, const void* k, const float* lse, void* out, int b, int h, int sq,
           int sk, float scale, const long long* strides, int clusters, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr bool kClustered = D == 72 || D == 88;
  if (clusters < 0 || (clusters > 0 && !kClustered)) return int(cudaErrorInvalidValue);
  // a cluster's CTA loads half the rows of each Q and K tile
  const int rows = clusters ? 64 : kBM;
  CUtensorMap qm, km, om = {};
  int err;
  if ((err = make_map<T>(&qm, q, b, h, sq, D, strides, rows))) return err;
  if ((err = make_map<T>(&km, k, b, h, sk, D, strides + 3, rows))) return err;
  // the map's row stride (sk elements) must be a multiple of 16 bytes
  const bool tma_out = sk % 8 == 0;
  if (tma_out && (err = make_out_map<T>(&om, out, b, sq, sk))) return err;
  const float scale_log2 = scale * kLog2e;
  if constexpr (kClustered) {
    if (clusters > 0) {
      const long long units =
          (long long)b * ((sq + 2 * kBM - 1) / (2 * kBM)) * ((sk + 2 * kBN - 1) / (2 * kBN));
      if (clusters > units) return int(cudaErrorInvalidValue);
      constexpr auto kernel = headmean_cluster<T, D>;
      if ((err = allow_smem<kernel>(C::kSmem))) return err;
      cudaLaunchAttribute attr[1];
      const cudaLaunchConfig_t cfg = cluster_config<D>(clusters, stream, attr);
      if ((err = int(cudaLaunchKernelEx(&cfg, kernel, qm, km, om, tma_out, lse,
                                        static_cast<T*>(out), b, h, sq, sk, scale_log2,
                                        clusters))))
        return err;
      return int(cudaGetLastError());
    }
  }
  constexpr auto kernel = headmean_hopper<T, D>;
  if ((err = allow_smem<kernel>(C::kSmem))) return err;
  const int sms = sm_count();
  if (sms <= 0) return int(cudaErrorInvalidDevice);
  const int n_tiles = b * ((sq + kBM - 1) / kBM) * ((sk + kBN - 1) / kBN);
  kernel<<<n_tiles < sms ? n_tiles : sms, kThreads, C::kSmem, stream>>>(
      qm, km, om, tma_out, lse, static_cast<T*>(out), b, h, sq, sk, scale_log2);
  return int(cudaGetLastError());
}

// How many clusters of headmean_cluster at width d the current device holds
// at once (0 where d has none, a negative cudaError_t on failure): the
// bound of ops/flash_attention.py's headmean_clusters.
template <typename T, int D>
int headmean_slots() {
  constexpr auto kernel = headmean_cluster<T, D>;
  int err = allow_smem<kernel>(Cfg<D>::kSmem);
  if (err) return -err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config<D>(1, nullptr, attr);
  int n = 0;
  if ((err = int(cudaOccupancyMaxActiveClusters(&n, kernel, &cfg)))) return -err;
  return n;
}
template <typename T>
int cluster_slots(int d) {
  switch (d) {
    case 72: return headmean_slots<T, 72>();
    case 88: return headmean_slots<T, 88>();
    default: return 0;
  }
}

// The body of each type's C entry point, dft_headmean_probs(q, k, lse, out,
// b, h, sq, sk, d, dtype, scale, strides, clusters, stream), whose contract
// this is (headmean_bf16.cu, headmean_fp16.cu and headmean_f32.cu share it):
// q and k are (b, h, s, d) device tensors of one dtype with unit stride on
// d; strides[0..5] are (sb, sh, ss) in elements of q and k, each a multiple
// of 16 bytes, and both bases 16-byte aligned; lse is a contiguous fp32
// (b, h, sq) buffer (B2's); out a contiguous (b, sq, sk) buffer of q's
// dtype.  dtype: 0 float32, 1 float16, 2 bfloat16; each library takes its
// own type only.  clusters: 0, or the cluster count of the d=72/88 cluster
// kernel (ops/flash_attention.py's headmean_clusters; float32 takes 0
// only).  Launches on `stream` without synchronising and returns a
// cudaError_t.
template <typename T>
int forward(const void* q, const void* k, const float* lse, void* out, int b, int h, int sq,
            int sk, int d, float scale, const long long* strides, int clusters, cudaStream_t s) {
  switch (d) {
    case 40: return launch<T, 40>(q, k, lse, out, b, h, sq, sk, scale, strides, clusters, s);
    case 64: return launch<T, 64>(q, k, lse, out, b, h, sq, sk, scale, strides, clusters, s);
    case 72: return launch<T, 72>(q, k, lse, out, b, h, sq, sk, scale, strides, clusters, s);
    case 80: return launch<T, 80>(q, k, lse, out, b, h, sq, sk, scale, strides, clusters, s);
    case 88: return launch<T, 88>(q, k, lse, out, b, h, sq, sk, scale, strides, clusters, s);
    case 128: return launch<T, 128>(q, k, lse, out, b, h, sq, sk, scale, strides, clusters, s);
    case 160: return launch<T, 160>(q, k, lse, out, b, h, sq, sk, scale, strides, clusters, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace headmean
}  // namespace hopper
}  // namespace dft
