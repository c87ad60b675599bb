// Direct-softmax attention for short key sequences on Hopper (sm_90a):
//   o = softmax(q k^T * scale) v   over (B*H, S, D) tensors, Sk <= 512,
// with fp32 math whatever the input type, keys past Sk masked, and the
// softmax taken exactly (one max and one sum per row over the whole row),
// not online.
//
// Replaces diffusion_feature_tpu/ops/flash_attention.py::_short_attn_kernel
// (B4).  The TPU kernel kept several heads' whole K and V in VMEM per
// program to amortise Mosaic's per-program cost.  Here one block owns 64
// query rows of one (b, h) and the whole key sequence: its 64 x Sk fp32
// score tile lives in shared memory (130 KB at Sk = 512, so the launch asks
// for dynamic shared memory above 48 KB), which is what bounds Sk.
//
// Steps, for the block's 64 rows (each of the 4 warps owns 16):
//   1. S = Q K^T * scale * log2(e) over 64-key tiles of K, on the tensor
//      cores (mma.sync m16n8k16, fp32 accumulation; bf16/fp16 products are
//      exact in fp32), written to the score tile with keys >= Sk as -inf;
//   2. per row, the exact max m and P = exp2(S - m) in place, and the row
//      sum kept apart;
//   3. O = P V over 64-key tiles of V, and O / sum at the end, as the TPU
//      kernel divides after its PV product.  For bf16/fp16 inputs P is
//      split into a rounded part and its remainder, two products on the
//      tensor cores, so P keeps ~16 mantissa bits (fp32 math; rounding P
//      to bf16 alone would keep 8).  Masked columns have P = 0 and V tiles
//      are zero-filled past Sk.
// Rows past Sq are zero-filled in the Q tile and never written.  d=40 is
// zero-padded to the mma depth of 48 for QK^T.  fp32 inputs take the exact
// fp32 FMA emulation of tile_ops.cuh (TF32 would round the inputs to 10
// mantissa bits).
//
// What bounds it: at the shapes its gate admits (Sq = 256, Sk = 77 or 256)
// one call moves 4*B*H*S*D elements and does 4*B*H*Sq*Sk*D flops, ~Sk/2
// flops per byte in bf16: below the card's ~295, so memory bounds it, and
// at (2,20,256,256,64) that bound is ~1.6 us, under a launch's own cost.
// The design reads Q, K and V once per 64 query rows and writes O once;
// the score tile never reaches device memory.

#include <type_traits>

#include "tile_ops.cuh"

namespace {

using namespace dft;

constexpr int kBlockN = 64;    // keys per K/V tile
constexpr int kMaxKeys = 512;  // the score tile's width limit

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T, int D>
struct Cfg {
  static constexpr int kDP = padded_depth(D);  // QK^T depth
  static constexpr int kLd = kDP + kPad;       // Q/K/V tile row stride (elements)
  static constexpr bool kExact = std::is_same<T, float>::value;
  static __host__ __device__ int sk_pad(int sk) { return (sk + kBlockN - 1) / kBlockN * kBlockN; }
  // score row stride: sk_pad + 8 floats keeps the fragment stores and
  // loads of one warp on distinct banks
  static __host__ __device__ int ld_s(int sk) { return sk_pad(sk) + 8; }
  static size_t smem(int sk) {
    return size_t(kBlockM) * (ld_s(sk) + 1) * sizeof(float) +
           size_t(kBlockM + kBlockN) * kLd * sizeof(T);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
short_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ o, int sq, int sk, float scale_log2) {
  using C = Cfg<T, D>;
  using Op = Ops<T>;
  using Reg = typename Op::Reg;
  constexpr int kDP = C::kDP, kLd = C::kLd, kNT = kBlockN / 8;

  const int sk_pad = C::sk_pad(sk), ld_s = C::ld_s(sk);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ss = reinterpret_cast<float*>(smem_raw);  // kBlockM x ld_s: S, then P
  float* inv_sum = ss + kBlockM * ld_s;            // kBlockM: 1 / row sum
  T* qs = reinterpret_cast<T*>(inv_sum + kBlockM);  // kBlockM x kLd
  T* kvs = qs + kBlockM * kLd;                      // kBlockN x kLd: a K, later a V tile

  const int q0 = blockIdx.x * kBlockM;
  const size_t bh = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const T* kg = k + bh * sk * D;
  const T* vg = v + bh * sk * D;
  load_tile<T, D, kDP>(qs, kLd, q + (bh * sq + q0) * D, D, min(kBlockM, sq - q0), kBlockM);

  // 1. scores of this warp's 16 rows, one 64-key tile at a time
  for (int k0 = 0; k0 < sk_pad; k0 += kBlockN) {
    __syncthreads();  // the Q tile is in; every warp is done with the last K tile
    load_tile<T, D, kDP>(kvs, kLd, kg + size_t(k0) * D, D, min(kBlockN, sk - k0), kBlockN);
    __syncthreads();
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kDP / 16; ++kk) {
      Reg a[4];
      load_a<T>(a, qs, kLd, row0, kk);
      mma_qk<T, kNT>(s, a, kvs, kLd, kk);
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int col = k0 + j * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 val = make_float2(col < sk ? s[j][2 * r] * scale_log2 : -INFINITY,
                                       col + 1 < sk ? s[j][2 * r + 1] * scale_log2 : -INFINITY);
        *reinterpret_cast<float2*>(ss + (row0 + g + 8 * r) * ld_s + col) = val;
      }
    }
  }
  __syncwarp();

  // 2. exact softmax numerator of each of the warp's rows, in place
  for (int r = 0; r < 16; ++r) {
    float* srow = ss + (row0 + r) * ld_s;
    float mx = -INFINITY;
    for (int c = 2 * lane; c < sk_pad; c += 64) {
      const float2 x = *reinterpret_cast<const float2*>(srow + c);
      mx = fmaxf(mx, fmaxf(x.x, x.y));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;  // mx is finite: every row has at least one key
    for (int c = 2 * lane; c < sk_pad; c += 64) {
      float2 x = *reinterpret_cast<const float2*>(srow + c);
      x.x = exp2f(x.x - mx);
      x.y = exp2f(x.y - mx);
      sum += x.x + x.y;
      *reinterpret_cast<float2*>(srow + c) = x;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) inv_sum[row0 + r] = 1.f / sum;
  }

  // 3. O = P V, one 64-key tile of V at a time
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (int k0 = 0; k0 < sk_pad; k0 += kBlockN) {
    __syncthreads();  // every warp is done with the last K or V tile
    load_tile<T, D>(kvs, kLd, vg + size_t(k0) * D, D, min(kBlockN, sk - k0), kBlockN);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      // the A operand (rows g, g+8; keys 2t, 2t+1 and 2t+8, 2t+9) from P
      const float* p = ss + (row0 + g) * ld_s + k0 + kk * 16 + 2 * t;
      const float2 pf[4] = {*reinterpret_cast<const float2*>(p),
                            *reinterpret_cast<const float2*>(p + 8 * ld_s),
                            *reinterpret_cast<const float2*>(p + 8),
                            *reinterpret_cast<const float2*>(p + 8 * ld_s + 8)};
      Reg hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (C::kExact) {
          hi[i] = Op::pack(pf[i].x, pf[i].y);
        } else {
          const T hx = Op::from_float(pf[i].x), hy = Op::from_float(pf[i].y);
          hi[i] = Op::pair(hx, hy);
          lo[i] = Op::pack(pf[i].x - to_float(hx), pf[i].y - to_float(hy));
        }
      }
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const T* vb = kvs + (kk * 16 + 2 * t) * kLd + n * 8 + g;
        Reg b[2];
        b[0] = Op::pair(vb[0], vb[kLd]);
        b[1] = Op::pair(vb[8 * kLd], vb[9 * kLd]);
        Op::mma(acc[n], hi, b);
        if constexpr (!C::kExact) Op::mma(acc[n], lo, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + g + 8 * r;
    if (row >= sq) continue;
    const float inv = inv_sum[row0 + g + 8 * r];
    T* orow = o + (bh * sq + row) * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<Reg*>(orow + n * 8 + 2 * t) =
          Op::pack(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
           float scale, cudaStream_t stream) {
  using C = Cfg<T, D>;
  if (sk < 1 || sk > kMaxKeys || sq < 1) return int(cudaErrorInvalidValue);
  constexpr auto kernel = short_attn_kernel<T, D>;
  const size_t smem = C::smem(sk);
  // the limit is raised once, to what the most keys need
  if (int err = allow_smem<kernel>(C::smem(kMaxKeys))) return err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                           static_cast<const T*>(v), static_cast<T*>(o), sq, sk,
                                           scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
               int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 40: return launch<T, 40>(q, k, v, o, bh, sq, sk, scale, stream);
    case 64: return launch<T, 64>(q, k, v, o, bh, sq, sk, scale, stream);
    case 80: return launch<T, 80>(q, k, v, o, bh, sq, sk, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, sq, sk, scale, stream);
    case 160: return launch<T, 160>(q, k, v, o, bh, sq, sk, scale, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q (bh, sq, d), k and v (bh, sk, d), o (bh, sq, d): contiguous device
// buffers of one dtype, 16-byte aligned; 1 <= sk <= 512.  dtype: 0 float32,
// 1 float16, 2 bfloat16.  Launches on `stream` without synchronising and
// returns the cudaError_t of the launch.
extern "C" int dft_short_attention_forward(const void* q, const void* k, const void* v, void* o,
                                           int bh, int sq, int sk, int d, int dtype, float scale,
                                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, bh, sq, sk, d, scale, s);
    case 1: return dispatch_d<__half>(q, k, v, o, bh, sq, sk, d, scale, s);
    case 2: return dispatch_d<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d, scale, s);
    default: return int(cudaErrorInvalidValue);
  }
}
