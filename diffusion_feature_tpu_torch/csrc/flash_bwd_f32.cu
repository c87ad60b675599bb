// The flash-attention backward for float32 inputs (flash_bwd.cuh holds the
// contract and the delta pre-pass), one source per type so that the types
// build in parallel.
//
// float32 runs on training paths: ade_vpd's prompt tuning and train_unet
// differentiate SD-1.5 in fp32, as the JAX reference trains.  What bounds
// it: five exact fp32 products per score on the FMA pipes (67 TFLOP/s on an
// H100; wgmma has no exact fp32 product), so the FMA issue rate, and ahead
// of it the shared-memory bandwidth the products' operands take.  The
// design feeds the FMA pipes with simt_f32.cuh's register-tiled products
// (no shuffle anywhere in the pass) and computes every score once:
//
// A block of 16 x kTX threads (kTX = 8, or 16 where d/8 is no whole
// number of columns a thread can own: d=80, 128, 160) owns 64 keys of one
// (b, h): their K and V tiles stay in shared memory and their dk, dv in
// registers (thread (ty, tx) owns keys ty + 16 i and the columns
// tx + kTX e, d/kTX of them, so every lane works at d=40 too).  It walks
// every 64-query tile of Q and dO, staged through cp.async
// (double-buffered where two stages leave room for two blocks an SM, or
// where one block an SM is all the widths allow):
//   s^T and dp^T (keys ty + 16 i x queries tx + kTX j, nt: 4 x 8 at
//     kTX = 8);
//   p^T = exp2(s^T * scale * log2 e - lse * log2 e), ds^T = p^T (dp^T -
//     delta) * scale, both written to shared memory;
//   dv += p^T do and dk += ds^T q (nnc), and dq = ds k for the tile's rows
//     4 ty .. 4 ty + 3 (tnc, ds^T read as ds);
//   dq added into the caller's zeroed fp32 dq with atomics, fire and forget
//     while the next tile loads.
// Keys past Sk get p = 0 (their rows of k are zero-filled on load, and dk,
// dv are stored for keys below Sk only); queries past Sq get lse = +inf and
// so p = 0, and no dq row past Sq is touched.

#include <type_traits>

#include "flash_bwd.cuh"
#include "simt_f32.cuh"

namespace dft {
namespace bwd {

template <int D>
struct F32Cfg {
  // 16 x kTX threads; a thread's output columns are tx + kTX e, e < kC
  static constexpr int kTX = D == 80 || D >= 128 ? 16 : 8;
  static constexpr int kThreads = 16 * kTX;
  static constexpr int kC = D / kTX;
  static constexpr int kBK = 64, kBQ = 64;           // keys per block, queries per tile
  static constexpr int kTN = kBQ / kTX;              // queries tx + kTX j of a thread's scores
  static constexpr int kLd = D + 4;                  // K, V, Q and dO rows (ld / 4 odd)
  static constexpr int kLdP = kBQ + kTX;             // p^T and ds^T rows (conflict-free stores)
  static constexpr size_t kTile = size_t(64) * kLd * sizeof(float);
  static constexpr size_t kHalfSm = 113 * 1024;      // two blocks an SM fit below this
  static constexpr size_t kSmem1 = 4 * kTile + 2 * size_t(kBK) * kLdP * sizeof(float);
  static constexpr size_t kSmem2 = kSmem1 + 2 * kTile;
  static constexpr int kStages =
      kSmem2 <= kHalfSm || (kSmem1 > kHalfSm && kSmem2 <= 227 * 1024) ? 2 : 1;
  static constexpr size_t kSmem = kStages == 2 ? kSmem2 : kSmem1;
  static_assert(D % kTX == 0, "a thread's columns tile the head width");
};

template <int D>
__global__ void __launch_bounds__(F32Cfg<D>::kThreads)
bwd_f32(Args<float> a, float scale_log2) {
  using C = F32Cfg<D>;
  using namespace simt;
  constexpr int kLd = C::kLd, kLdP = C::kLdP, kC = C::kC, kTX = C::kTX, kTN = C::kTN;
  constexpr int kStages = C::kStages, kThreads = C::kThreads;
  constexpr int kTileF = 64 * kLd;

  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kTileF;
  float* qs = vs + kTileF;                 // stage s: q at qs + 2 s kTileF, do after it
  float* pt = qs + kStages * 2 * kTileF;   // p^T (keys x queries)
  float* dst = pt + 64 * kLdP;             // ds^T

  const long long* sv = a.st.v;
  const int k0 = blockIdx.x * C::kBK;
  const int bh = blockIdx.y, b = bh / a.h, h = bh % a.h;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int sq = a.sq, sk = a.sk;
  const float* qg = a.q + b * sv[0] + h * sv[1];
  const float* dog = a.dout + b * sv[12] + h * sv[13];
  float* dqg = a.dq + b * sv[15] + h * sv[16] + tx;
  const float* lseg = a.lse + size_t(bh) * sq;
  const float* dlg = a.delta + size_t(bh) * sq;
  const int n_tiles = (sq + C::kBQ - 1) / C::kBQ;

  auto load_q_tile = [&](int i) {
    float* stage = qs + (i % kStages) * 2 * kTileF;
    const int q0 = i * C::kBQ, valid = min(C::kBQ, sq - q0);
    load_tile_async<kThreads, D>(stage, kLd, qg + size_t(q0) * sv[2], sv[2], valid, C::kBQ);
    load_tile_async<kThreads, D>(stage + kTileF, kLd, dog + size_t(q0) * sv[14], sv[14], valid,
                                 C::kBQ);
  };
  const int kv_valid = min(C::kBK, sk - k0);
  load_tile_async<kThreads, D>(ks, kLd, a.k + b * sv[3] + h * sv[4] + size_t(k0) * sv[5], sv[5],
                               kv_valid, C::kBK);
  load_tile_async<kThreads, D>(vs, kLd, a.v + b * sv[6] + h * sv[7] + size_t(k0) * sv[8], sv[8],
                               kv_valid, C::kBK);
  load_q_tile(0);
  cp_async_commit();

  float dk[4][kC], dv[4][kC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < kC; ++e) dk[i][e] = dv[i][e] = 0.f;
  bool key_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) key_ok[i] = k0 + ty + 16 * i < sk;

  for (int it = 0; it < n_tiles; ++it) {
    const int q0 = it * C::kBQ;
    if constexpr (kStages == 2) {
      if (it + 1 < n_tiles) load_q_tile(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // this thread's queries tx + kTX j: the logsumexp (log2 units, +inf
    // past Sq so that p = 0) and delta
    float l2[kTN], dl[kTN];
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int q = q0 + tx + kTX * j;
      l2[j] = q < sq ? lseg[q] * kLog2e : INFINITY;
      dl[j] = q < sq ? dlg[q] : 0.f;
    }
    __syncthreads();   // the tile has landed for every thread
    const float* qt = qs + (it % kStages) * 2 * kTileF;
    const float* dot = qt + kTileF;

    // s^T and dp^T: keys ty + 16 i x queries tx + kTX j
    float s[4][kTN], dp[4][kTN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = dp[i][j] = 0.f;
    nt<4, kTN, 16, kTX, D>(s, ks + ty * kLd, kLd, qt + tx * kLd, kLd);
    nt<4, kTN, 16, kTX, D>(dp, vs + ty * kLd, kLd, dot + tx * kLd, kLd);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const float p = key_ok[i] ? exp2_sfu(fmaf(s[i][j], scale_log2, -l2[j])) : 0.f;
        pt[(ty + 16 * i) * kLdP + tx + kTX * j] = p;
        dst[(ty + 16 * i) * kLdP + tx + kTX * j] = p * (dp[i][j] - dl[j]) * a.scale;
      }
    __syncthreads();   // p^T and ds^T whole

    // dv += p^T do and dk += ds^T q (keys ty + 16 i, columns tx + kTX e);
    // dq = ds k for the tile's rows 4 ty .. 4 ty + 3
    nnc<4, kC, kTX, 64>(dv, pt + ty * kLdP, kLdP, dot + tx, kLd);
    nnc<4, kC, kTX, 64>(dk, dst + ty * kLdP, kLdP, qt + tx, kLd);
    float dq[4][kC];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < kC; ++e) dq[i][e] = 0.f;
    tnc<kC, kTX, 64>(dq, dst + 4 * ty, kLdP, ks + tx, kLd);
    __syncthreads();   // every warp is done with this stage, p^T and ds^T
    if constexpr (kStages == 1) {
      if (it + 1 < n_tiles) load_q_tile(it + 1);
      cp_async_commit();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + 4 * ty + i;
      if (q < sq) {
        float* row = dqg + size_t(q) * sv[17];
#pragma unroll
        for (int e = 0; e < kC; ++e) atomicAdd(row + kTX * e, dq[i][e]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key < sk) {
      float* dkr = a.dk + b * sv[18] + h * sv[19] + size_t(key) * sv[20] + tx;
      float* dvr = a.dv + b * sv[21] + h * sv[22] + size_t(key) * sv[23] + tx;
#pragma unroll
      for (int e = 0; e < kC; ++e) {
        dkr[kTX * e] = dk[i][e];
        dvr[kTX * e] = dv[i][e];
      }
    }
  }
}

template <typename T, int D>
int launch(const Args<T>& a, cudaStream_t stream) {
  static_assert(std::is_same<T, float>::value, "this library is the float32 backward");
  using C = F32Cfg<D>;
  if (int err = launch_delta<T, D>(a, stream)) return err;
  constexpr auto kernel = bwd_f32<D>;
  if (int err = allow_smem<kernel>(C::kSmem)) return err;
  kernel<<<dim3((a.sk + C::kBK - 1) / C::kBK, a.b * a.h), C::kThreads, C::kSmem, stream>>>(
      a, a.scale * kLog2e);
  return int(cudaGetLastError());
}

}  // namespace bwd
}  // namespace dft

// dq, dk, dv of B1/B2; the contract is at dft::bwd::backward in
// flash_bwd.cuh.  This library takes dtype 0 (float32) only; dq_acc is
// unused (dq itself, zeroed by the caller, takes the sums).
DFT_FLASH_BACKWARD_ENTRY(float, 0)
