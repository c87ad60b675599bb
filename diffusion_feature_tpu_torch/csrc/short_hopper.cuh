// Direct-softmax attention for short key sequences on Hopper (sm_90a), bf16
// and fp16:
//   o = softmax(q k^T * scale) v   over (B, H, S, D) tensors, Sk <= 512,
// with fp32 math whatever the input type, keys past Sk masked, and the
// softmax taken exactly: each row's max over all Sk keys is known before
// any exponent, and the division by the row sum comes after P V.
// short_bf16.cu and short_fp16.cu instantiate it, one type each; float32
// takes the exact kernel of short_f32.cu.
//
// Replaces diffusion_feature_tpu/ops/flash_attention.py::_short_attn_kernel
// (B4).  The TPU kernel kept several heads' whole K and V in VMEM per
// program to amortise Mosaic's per-program cost; here a block owns 64 query
// rows of one (b, h) and walks the head's key tiles twice.
//
// What bounds it: at the shapes its gate admits (Sq = 256, Sk = 77 or 256)
// a call moves 4*B*H*S*D elements and does 4*B*H*Sq*Sk*D flops, ~Sk/2
// flops per byte in bf16, below the card's ~295: memory, and at the small
// shapes the latency of one block's chain of loads and products (the bound
// at (2,20,256,256,64) is ~1.6 us).  The design:
//
// * Two passes over the key tiles, with the scores recomputed.  Pass 1
//   computes S = Q K_j^T for every 64-key tile and keeps only the row
//   maxima; pass 2 recomputes S, forms P = exp2(S * c - m * c) (c = scale *
//   log2(e)) and the row sums, and runs P V.  Recomputing costs tensor-core
//   time, which does not bind here; keeping S would cost 64 x Sk fp32 of
//   registers or shared memory (the old kernel's 130 KB score tile).
// * Warp specialisation and TMA.  A producer warp (one thread) loads the Q
//   tile once, every K tile for pass 1, and the V tiles (and, where the K
//   tiles do not all stay, the K tiles again) for pass 2, with "full"
//   mbarriers that count the bytes and "empty" ones the consumer warps
//   arrive on.  The K tiles of a head stay in shared memory for pass 2
//   when they fit: all 512 keys at d <= 64, 256 at d=160, 128 at d=72/80/88/128;
//   past that the K slots are a ring and pass 2 reloads K.  V runs through
//   a 2-stage ring.  The tensor maps are 4-d (d, s, h, b) with the caller's
//   strides, so head-split views are read in place; TMA zero-fills rows
//   past Sq and Sk and the columns of d=40/72/80/88/160 up to the next 64-column
//   atom; P V's N is D itself (m64n72k16 at d=72, m64n88k16 at d=88).
// * wgmma.  The consumer warpgroup's S = Q K^T is m64n64k16 from shared
//   memory.  Pass 1 takes the tiles in pairs, tile j+1's product running
//   while tile j's maxima are taken; in pass 2 tile j's scores are computed
//   while tile j-1's P V runs, and tile j's exponentials overlap that
//   product (two P register sets).  P V takes P from registers (the accumulator layout of S is the
//   A-fragment layout) and V as the transposed B operand from its TMA tile.
// * Precision.  P is split into its bf16/fp16 rounding and the remainder,
//   two products into the same fp32 accumulator, so P keeps ~16 mantissa
//   bits (rounding P once would keep 8 in bf16), as the earlier kernel did.
// * The grid.  64 rows a block, so (2,20,256,256,64) is 160 blocks and the
//   batch-16 shapes 1280.  The block is one consumer warpgroup and the
//   producer warp (160 threads), and allocates shared memory for the K
//   tiles it keeps, so at 256 keys three blocks share an SM at d <= 64
//   (57 KB and at most 136 registers a thread each) and two at d=80/128,
//   and one block's loads and waits overlap the others' products.  d=160
//   keeps its 256 keys resident (169 KB) at one block an SM.  Each block
//   reads its head's K and V (once from memory, then from L2): 64-row
//   blocks fill the SMs at 40 heads, where 128-row blocks would leave 52
//   idle.

#pragma once

#include "hopper_common.cuh"

namespace dft {
namespace hopper {
namespace short_attn {

constexpr int kBM = 64;              // query rows per block: one consumer warpgroup
constexpr int kBN = 64;              // keys per tile
constexpr int kMaxKeys = 512;
constexpr int kThreads = 128 + 32;   // the consumer warpgroup, then the producer warp
constexpr int kVStages = 2;

template <int D>
struct Cfg {
  static constexpr int kDP = (D + 15) / 16 * 16;           // QK^T depth (d=40 -> 48)
  static constexpr int kAtoms = (D + kAtom - 1) / kAtom;    // 64-column atoms per row
  static constexpr uint32_t kQBytes = kAtoms * kBM * kAtomBytes;
  static constexpr uint32_t kTileBytes = kAtoms * kBN * kAtomBytes;   // one K or V tile
  // K tiles that stay for pass 2 (every tile of Sk <= kBN * kKSlots)
  static constexpr int kKSlots = kAtoms == 1 ? 8 : (kAtoms == 2 ? 2 : 4);
  // blocks an SM at 256 keys (registers capped to allow them)
  static constexpr int kMinBlocks = kAtoms == 1 ? 3 : (kAtoms == 2 ? 2 : 1);
  // barriers, alignment slack, Q, the V ring and the K slots a call uses
  static constexpr size_t smem(int n_tiles) {
    return 256 + 1024 + kQBytes +
           size_t(kVStages + (n_tiles < kKSlots ? n_tiles : kKSlots)) * kTileBytes;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Cfg<D>::kMinBlocks)
short_attn_hopper(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, OutPtr out, int heads, int sq, int sk,
                  float scale_log2) {
  using C = Cfg<D>;
  constexpr int kS = C::kKSlots;
  extern __shared__ uint8_t smem_raw[];
  // the barriers first, then the tiles from the next 1024-byte boundary
  // (the 128-byte swizzle repeats every 1024 bytes); only the K slots this
  // call uses are allocated
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem_raw);
  const uint32_t tiles_addr = smem_u32(smem_raw) + 256;
  uint8_t* qs = smem_raw + 256 + (((tiles_addr + 1023) & ~1023u) - tiles_addr);
  uint8_t* vs = qs + C::kQBytes;
  uint8_t* ks = vs + kVStages * C::kTileBytes;
  uint64_t* kfull = qbar + 1;
  uint64_t* kempty = kfull + kS;
  uint64_t* vfull = kempty + kS;
  uint64_t* vempty = vfull + kVStages;

  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kBM;
  const int n = (sk + kBN - 1) / kBN;
  // the ring position of key tile j's use in pass 2: the pass-1 load where
  // every tile stays, a second load otherwise
  const bool resident = n <= kS;
  auto k_use2 = [&](int j) { return resident ? j : n + j; };

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&kempty[s], 4);
    }
    for (int s = 0; s < kVStages; ++s) {
      mbar_init(&vfull[s], 1);
      mbar_init(&vempty[s], 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // ---- producer warp: one thread issues every load
    if (threadIdx.x == 128) {
      prefetch_map(&qmap);
      prefetch_map(&kmap);
      prefetch_map(&vmap);
      mbar_expect_tx(qbar, C::kQBytes);
      for (int a = 0; a < C::kAtoms; ++a)
        tma_load(qs + a * kBM * kAtomBytes, &qmap, qbar, a * kAtom, q0, h, b);
      auto load_k = [&](int u) {   // ring position u holds key tile u % n
        const int s = u % kS;
        mbar_wait(&kempty[s], ((u / kS) & 1) ^ 1);
        mbar_expect_tx(&kfull[s], C::kTileBytes);
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load(ks + s * C::kTileBytes + a * kBN * kAtomBytes, &kmap, &kfull[s], a * kAtom,
                   (u % n) * kBN, h, b);
      };
      for (int u = 0; u < n; ++u) load_k(u);
      for (int j = 0; j < n; ++j) {
        if (!resident) load_k(n + j);
        const int s = j % kVStages;
        mbar_wait(&vempty[s], ((j / kVStages) & 1) ^ 1);
        mbar_expect_tx(&vfull[s], C::kTileBytes);
        for (int a = 0; a < C::kAtoms; ++a)
          tma_load(vs + s * C::kTileBytes + a * kBN * kAtomBytes, &vmap, &vfull[s], a * kAtom,
                   j * kBN, h, b);
      }
    }
    return;
  }

  // ---- the consumer warpgroup: rows q0 .. q0 + 63
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const uint32_t q_addr = smem_u32(qs);

  // S = Q K^T of ring position u into sc, issued and committed
  auto issue_s = [&](float (&sc)[kBN / 2], int u) {
    const int s = u % kS;
    const uint32_t k_addr = smem_u32(ks + s * C::kTileBytes);
    mbar_wait(&kfull[s], (u / kS) & 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C::kDP / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;   // 16 columns = 32 bytes into the atom
      wgmma_ss<T, kBN>(sc, sw128_desc(q_addr + (kk / 4) * kBM * kAtomBytes + off, 16, 1024),
                       sw128_desc(k_addr + (kk / 4) * kBN * kAtomBytes + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
  };
  auto release = [&](uint64_t* empty, int i) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[i]);
  };
  // keys past Sk get -inf (the K tile's zero fill would give them score 0)
  auto mask = [&](float (&sc)[kBN / 2], int j) {
    const int k0 = j * kBN;
    if (k0 + kBN > sk) {
#pragma unroll
      for (int nn = 0; nn < kBN / 8; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + nn * 8 + 2 * t + (e & 1) >= sk) sc[nn * 4 + e] = -INFINITY;
      }
    }
  };

  mbar_wait(qbar, 0);

  // ---- pass 1: each row's max over all keys, of the unscaled scores (the
  // scale is positive); every row has a valid key, so the max is finite
  float m[2] = {-INFINITY, -INFINITY};
  {
    auto row_max = [&](float (&sc)[kBN / 2], int j) {
      fence_regs(sc);
      release(kempty, j % kS);
      mask(sc, j);
#pragma unroll
      for (int nn = 0; nn < kBN / 8; ++nn) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          m[r] = fmaxf(m[r], fmaxf(sc[nn * 4 + 2 * r], sc[nn * 4 + 2 * r + 1]));
      }
    };
    // tiles in pairs: tile j+1's product runs while tile j's maxima are
    // taken, and no product is in flight across the loop's back edge (where
    // the compiler would copy the accumulators and serialise every wgmma)
    float sa[kBN / 2], sb[kBN / 2];
    for (int j = 0; j < n; j += 2) {
      issue_s(sa, j);
      if (j + 1 < n) {
        issue_s(sb, j + 1);
        wgmma_wait<1>();
      } else {
        wgmma_wait<0>();
      }
      row_max(sa, j);
      if (j + 1 < n) {
        wgmma_wait<0>();
        row_max(sb, j + 1);
      }
    }
  }
  float m_scaled[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
    m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    m_scaled[r] = m[r] * scale_log2;
  }

  // ---- pass 2: P = exp2(S * c - m * c), the row sums, and O = P V
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float l[2] = {0.f, 0.f};   // this lane's share of the row sums
  float sc[kBN / 2];
  uint32_t pa_hi[kBN / 4], pa_lo[kBN / 4], pb_hi[kBN / 4], pb_lo[kBN / 4];

  // O += P_j V_j as the rounded P and its remainder, issued and committed
  auto issue_pv = [&](const uint32_t (&hi)[kBN / 4], const uint32_t (&lo)[kBN / 4], int j) {
    const int s = j % kVStages;
    const uint32_t v_addr = smem_u32(vs + s * C::kTileBytes);
    mbar_wait(&vfull[s], (j / kVStages) & 1);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t desc = sw128_desc(v_addr + kk * 16 * kAtomBytes, kBN * kAtomBytes, 1024);
      wgmma_rs<T, D>(o, &hi[kk * 4], desc, 1);
      wgmma_rs<T, D>(o, &lo[kk * 4], desc, 1);
    }
    wgmma_commit();
  };
  auto softmax = [&](float (&s)[kBN / 2], uint32_t (&hi)[kBN / 4], uint32_t (&lo)[kBN / 4],
                     int j) {
    mask(s, j);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int nn = 0; nn < kBN / 8; ++nn) {
        const float p0 = fast_exp2(fmaf(s[nn * 4 + 2 * r], scale_log2, -m_scaled[r]));
        const float p1 = fast_exp2(fmaf(s[nn * 4 + 2 * r + 1], scale_log2, -m_scaled[r]));
        l[r] += p0 + p1;
        // 16 keys (8-key blocks 2kk, 2kk+1) per k-step of P V
        const int i = (nn / 2) * 4 + (nn % 2) * 2 + r;
        hi[i] = pack2<T>(p0, p1);
        const float2 rounded = unpack2<T>(hi[i]);
        lo[i] = pack2<T>(p0 - rounded.x, p1 - rounded.y);
      }
    }
  };
  auto step = [&](const uint32_t (&hi_prev)[kBN / 4], const uint32_t (&lo_prev)[kBN / 4],
                  uint32_t (&hi_cur)[kBN / 4], uint32_t (&lo_cur)[kBN / 4], int j) {
    issue_s(sc, k_use2(j));
    issue_pv(hi_prev, lo_prev, j - 1);
    wgmma_wait<1>();   // the scores; the product may still run
    fence_regs(sc);
    release(kempty, k_use2(j) % kS);
    softmax(sc, hi_cur, lo_cur, j);
    wgmma_wait<0>();
    fence_regs(o);
    release(vempty, (j - 1) % kVStages);
  };
  issue_s(sc, k_use2(0));
  wgmma_wait<0>();
  fence_regs(sc);
  release(kempty, k_use2(0) % kS);
  softmax(sc, pa_hi, pa_lo, 0);
  int j = 1;
  for (; j + 1 < n; j += 2) {
    step(pa_hi, pa_lo, pb_hi, pb_lo, j);
    step(pb_hi, pb_lo, pa_hi, pa_lo, j + 1);
  }
  if (j < n) {
    step(pa_hi, pa_lo, pb_hi, pb_lo, j);
    issue_pv(pb_hi, pb_lo, j);
  } else {
    issue_pv(pa_hi, pa_lo, j - 1);
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
    const int row = q0 + warp * 16 + g + 8 * r;
    if (row < sq) {
      T* orow = static_cast<T*>(out.o) + obase + row * out.ss;
#pragma unroll
      for (int nn = 0; nn < D / 8; ++nn)
        *reinterpret_cast<uint32_t*>(orow + nn * 8 + 2 * t) =
            pack2<T>(o[nn * 4 + 2 * r] * inv, o[nn * 4 + 2 * r + 1] * inv);
    }
  }
}

// ------------------------------------------------------------ host side
// q, k, v, o: (b, h, s, d) with strides[0..11] = (sb, sh, ss) of q, k, v, o.
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int h, int sq, int sk,
           float scale, const long long* strides, cudaStream_t stream) {
  using C = Cfg<D>;
  static_assert((C::smem(4) + 1024) * C::kMinBlocks <= 233472,
                "more shared memory than an SM has at 256 keys");
  if (sk < 1 || sk > kMaxKeys || sq < 1) return int(cudaErrorInvalidValue);
  CUtensorMap qm, km, vm;
  int err;
  if ((err = make_map<T>(&qm, q, b, h, sq, D, strides, kBM))) return err;
  if ((err = make_map<T>(&km, k, b, h, sk, D, strides + 3, kBN))) return err;
  if ((err = make_map<T>(&vm, v, b, h, sk, D, strides + 6, kBN))) return err;
  const OutPtr out{o, nullptr, strides[9], strides[10], strides[11]};
  constexpr auto kernel = short_attn_hopper<T, D>;
  // the limit is raised once, to what the most keys need
  if ((err = allow_smem<kernel>(C::smem(C::kKSlots)))) return err;
  const dim3 grid((sq + kBM - 1) / kBM, b * h);
  kernel<<<grid, kThreads, C::smem((sk + kBN - 1) / kBN), stream>>>(qm, km, vm, out, h, sq, sk,
                                                scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

// The body of each type's C entry point, dft_short_attention_forward(q, k,
// v, o, b, h, sq, sk, d, dtype, scale, strides, stream), whose contract this
// is (short_bf16.cu, short_fp16.cu and short_f32.cu share it): q, k, v, o
// are (b, h, s, d) device tensors of one dtype with unit stride on d;
// strides[0..11] are (sb, sh, ss) in elements of q, k, v and o, each a
// multiple of 16 bytes, and every base 16-byte aligned; 1 <= sk <= 512.
// dtype: 0 float32, 1 float16, 2 bfloat16; each library takes its own type
// only.  Launches on `stream` without synchronising and returns a
// cudaError_t.
template <typename T>
int forward(const void* q, const void* k, const void* v, void* o, int b, int h, int sq, int sk,
            int d, float scale, const long long* strides, cudaStream_t s) {
  switch (d) {
    case 40: return launch<T, 40>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 64: return launch<T, 64>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 72: return launch<T, 72>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 80: return launch<T, 80>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 88: return launch<T, 88>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 128: return launch<T, 128>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 160: return launch<T, 160>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace short_attn
}  // namespace hopper
}  // namespace dft
