// B4 for float32 inputs: direct-softmax attention for short key sequences,
//   o = softmax(q k^T * scale) v   over (B, H, S, D) tensors, Sk <= 512,
// with exact fp32 products, keys past Sk masked, and the softmax taken
// exactly (one max and one sum per row over the whole row), not online.
// float32 is a test dtype: bf16 and fp16 take the Hopper kernel of
// short_hopper.cuh, and wgmma has no exact fp32 product (TF32 would round
// the inputs to 10 mantissa bits).
//
// Replaces diffusion_feature_tpu/ops/flash_attention.py::_short_attn_kernel
// (B4) for float32.  One block owns 64 query rows of one (b, h) and the
// whole key sequence: its 64 x Sk fp32 score tile lives in shared memory
// (130 KB at Sk = 512), which is what bounds Sk.  For the block's 64 rows
// (each of the 4 warps owns 16):
//   1. S = Q K^T * scale * log2(e) over 64-key tiles of K, as an exact fp32
//      FMA emulation of mma.sync m16n8k16's fragment layout (tile_ops.cuh),
//      written to the score tile with keys >= Sk as -inf;
//   2. per row, the exact max m and P = exp2(S - m) in place, and the row
//      sum kept apart;
//   3. O = P V over 64-key tiles of V, and O / sum at the end, as the TPU
//      kernel divides after its PV product.
// Loads are synchronous 16-byte vectors, zero-filled past the ragged edge
// and past d=40's depth of 48.  q, k, v and o may be strided views (unit
// stride on D); rows past Sq are never written.

#include "tile_ops.cuh"

namespace {

using namespace dft;

constexpr int kBlockN = 64;    // keys per K/V tile
constexpr int kMaxKeys = 512;  // the score tile's width limit

template <int D>
struct Cfg {
  static constexpr int kDP = padded_depth(D);  // QK^T depth
  static constexpr int kLd = kDP + kPad;       // Q/K/V tile row stride (elements)
  static __host__ __device__ int sk_pad(int sk) { return (sk + kBlockN - 1) / kBlockN * kBlockN; }
  // score row stride: sk_pad + 8 floats keeps the fragment stores and
  // loads of one warp on distinct banks
  static __host__ __device__ int ld_s(int sk) { return sk_pad(sk) + 8; }
  static size_t smem(int sk) {
    return size_t(kBlockM) * (ld_s(sk) + 1) * sizeof(float) +
           size_t(kBlockM + kBlockN) * kLd * sizeof(float);
  }
};

// Element strides (sb, sh, ss) of q, k, v and o; d has unit stride.
struct Strides {
  long long v[12];
};

template <int D>
__global__ void __launch_bounds__(kThreads)
short_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int heads, int sq, int sk,
                  float scale_log2, Strides st) {
  using C = Cfg<D>;
  using Op = Ops<float>;
  using Reg = typename Op::Reg;
  constexpr int kDP = C::kDP, kLd = C::kLd, kNT = kBlockN / 8;

  const int sk_pad = C::sk_pad(sk), ld_s = C::ld_s(sk);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ss = reinterpret_cast<float*>(smem_raw);  // kBlockM x ld_s: S, then P
  float* inv_sum = ss + kBlockM * ld_s;            // kBlockM: 1 / row sum
  float* qs = inv_sum + kBlockM;                   // kBlockM x kLd
  float* kvs = qs + kBlockM * kLd;                 // kBlockN x kLd: a K, later a V tile

  const int q0 = blockIdx.x * kBlockM;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;
  const int qss = int(st.v[2]), kss = int(st.v[5]), vss = int(st.v[8]);
  const float* kg = k + b * st.v[3] + h * st.v[4];
  const float* vg = v + b * st.v[6] + h * st.v[7];
  load_tile<float, D, kDP>(qs, kLd, q + b * st.v[0] + h * st.v[1] + size_t(q0) * qss, qss,
                           min(kBlockM, sq - q0), kBlockM);

  // 1. scores of this warp's 16 rows, one 64-key tile at a time
  for (int k0 = 0; k0 < sk_pad; k0 += kBlockN) {
    __syncthreads();  // the Q tile is in; every warp is done with the last K tile
    load_tile<float, D, kDP>(kvs, kLd, kg + size_t(k0) * kss, kss, min(kBlockN, sk - k0),
                             kBlockN);
    __syncthreads();
    float s[kNT][4];
#pragma unroll
    for (int j = 0; j < kNT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kDP / 16; ++kk) {
      Reg a[4];
      load_a<float>(a, qs, kLd, row0, kk);
      mma_qk<float, kNT>(s, a, kvs, kLd, kk);
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
    load_tile<float, D>(kvs, kLd, vg + size_t(k0) * vss, vss, min(kBlockN, sk - k0), kBlockN);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      // the A operand (rows g, g+8; keys 2t, 2t+1 and 2t+8, 2t+9) from P
      const float* p = ss + (row0 + g) * ld_s + k0 + kk * 16 + 2 * t;
      const Reg a[4] = {*reinterpret_cast<const float2*>(p),
                        *reinterpret_cast<const float2*>(p + 8 * ld_s),
                        *reinterpret_cast<const float2*>(p + 8),
                        *reinterpret_cast<const float2*>(p + 8 * ld_s + 8)};
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const float* vb = kvs + (kk * 16 + 2 * t) * kLd + n * 8 + g;
        Reg bv[2];
        bv[0] = Op::pair(vb[0], vb[kLd]);
        bv[1] = Op::pair(vb[8 * kLd], vb[9 * kLd]);
        Op::mma(acc[n], a, bv);
      }
    }
  }

  float* obase = o + b * st.v[9] + h * st.v[10];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + g + 8 * r;
    if (row >= sq) continue;
    const float inv = inv_sum[row0 + g + 8 * r];
    float* orow = obase + size_t(row) * st.v[11];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + n * 8 + 2 * t) =
          make_float2(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int b, int h, int sq, int sk,
           float scale, const long long* strides, cudaStream_t stream) {
  using C = Cfg<D>;
  if (sk < 1 || sk > kMaxKeys || sq < 1) return int(cudaErrorInvalidValue);
  constexpr auto kernel = short_attn_kernel<D>;
  // the limit is raised once, to what the most keys need
  if (int err = allow_smem<kernel>(C::smem(kMaxKeys))) return err;
  Strides st;
  for (int i = 0; i < 12; ++i) st.v[i] = strides[i];
  const dim3 grid((sq + kBlockM - 1) / kBlockM, b * h);
  kernel<<<grid, kThreads, C::smem(sk), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), h, sq, sk, scale * 1.4426950408889634f, st);
  return int(cudaGetLastError());
}

}  // namespace

// The entry point; its contract is at dft::hopper::short_attn::forward in
// short_hopper.cuh.  This library takes dtype 0 (float32) only.
extern "C" int dft_short_attention_forward(const void* q, const void* k, const void* v, void* o,
                                           int b, int h, int sq, int sk, int d, int dtype,
                                           float scale, const long long* strides, void* stream) {
  if (dtype != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40: return launch<40>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 64: return launch<64>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 72: return launch<72>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 80: return launch<80>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 88: return launch<88>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 128: return launch<128>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    case 160: return launch<160>(q, k, v, o, b, h, sq, sk, scale, strides, s);
    default: return int(cudaErrorInvalidValue);
  }
}
