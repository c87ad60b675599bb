// B1 and B2 for float32 inputs: flash-attention forward with exact fp32
// products, softmax(q k^T * scale) v over (b, h, s, d) tensors with an fp32
// running max, denominator and accumulator; with kLse each row's
// logsumexp.  float32 is a test dtype, on no path: bf16 and fp16 take the
// Hopper kernel of flash_hopper.cuh, and wgmma has no exact fp32 product
// (TF32 would round the inputs to 10 mantissa bits).
//
// Replaces diffusion_feature_tpu/ops/flash_attention.py::_flash_kernel (B1)
// and ::_flash_lse_kernel (B2) for float32.  One thread block owns 64 query
// rows of one (b, h) and walks every key tile itself.  The products run as
// an exact fp32 FMA emulation of mma.sync m16n8k16's fragment layout
// (tile_ops.cuh); scores stay in registers, the softmax uses exp2 with the
// scale folded in.  Loads are synchronous 16-byte vectors through
// registers, two block-wide barriers per key tile.
//
// Layout: each of the 4 warps owns 16 query rows.  A fragment element
// (row, col) of an m16n8k16 operand lives in lane 4*(row%8) + (col%8)/2, so
// the score accumulator of two adjacent 8-key tiles is already the A operand
// of the PV product.  Head widths: 40, 64, 72, 80, 88, 128, 160 and 512.  d=40,
// 72 and 88 are zero-padded to the depths 48, 80 and 96 in shared memory for QK^T.  Widths up to 160
// keep the whole 16 x d accumulator of a warp in registers; d=512 does not
// fit, so blockIdx.z splits its output columns into 128-wide slices and
// each slice recomputes the scores.

#include "tile_ops.cuh"

namespace {

using namespace dft;

template <typename T, int D>
struct Cfg {
  static constexpr int kDP = padded_depth(D);          // QK^T depth
  static constexpr int kDC = D <= 160 ? D : 128;        // output columns per block
  static constexpr int kBlockN = D <= 128 ? 64 : 32;    // keys per tile
  static constexpr int kLdQK = kDP + kPad;
  static constexpr int kLdV = kDC + kPad;
  static_assert(D % kDC == 0 && kDC % 8 == 0, "output slices must tile the head width");
  static constexpr size_t kSmem =
      (size_t(kBlockM) * kLdQK + size_t(kBlockN) * kLdQK + size_t(kBlockN) * kLdV) * sizeof(T);
};

// Element strides (sb, sh, ss) of q, k, v and o; d has unit stride.
struct Strides {
  long long v[12];
};

template <typename T, int D, bool kLse>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int heads, int sq, int sk,
                 float scale_log2, Strides st) {
  using C = Cfg<T, D>;
  using Op = Ops<T>;
  using Reg = typename Op::Reg;
  constexpr int kDP = C::kDP, kDC = C::kDC, kBN = C::kBlockN;
  constexpr int kLdQK = C::kLdQK, kLdV = C::kLdV;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kBlockM * kLdQK;
  T* vs = ks + kBN * kLdQK;

  const int q0 = blockIdx.x * kBlockM;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int dc0 = blockIdx.z * kDC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;

  const T* kg = k + b * st.v[3] + h * st.v[4];
  const T* vg = v + b * st.v[6] + h * st.v[7] + dc0;
  const int kss = int(st.v[5]), vss = int(st.v[8]);
  load_tile<T, D, kDP>(qs, kLdQK, q + b * st.v[0] + h * st.v[1] + q0 * st.v[2], int(st.v[2]),
                       min(kBlockM, sq - q0), kBlockM);

  float acc[kDC / 8][4];
#pragma unroll
  for (int n = 0; n < kDC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g+8 (log2 units)
  float l[2] = {0.f, 0.f};              // this lane's share of the running denominator

  for (int k0 = 0; k0 < sk; k0 += kBN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    const int kv_valid = min(kBN, sk - k0);
    load_tile<T, D, kDP>(ks, kLdQK, kg + size_t(k0) * kss, kss, kv_valid, kBN);
    load_tile<T, kDC>(vs, kLdV, vg + size_t(k0) * vss, vss, kv_valid, kBN);
    __syncthreads();

    // scores of this warp's 16 rows against the kBN keys of the tile
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < kDP / 16; ++kk) {
      Reg a[4];
      load_a<T>(a, qs, kLdQK, row0, kk);
      mma_qk<T, kBN / 8>(s, a, ks, kLdQK, kk);
    }

    // online softmax; keys past the end get -inf and so weight 0
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        s[j][e] = key < sk ? s[j][e] * scale_log2 : -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      // every tile holds at least one valid key, so m_new is finite
      const float m_new = fmaxf(m[r], mx);
      const float alpha = exp2f(m[r] - m_new);
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        s[j][2 * r] = exp2f(s[j][2 * r] - m_new);
        s[j][2 * r + 1] = exp2f(s[j][2 * r + 1] - m_new);
        sum += s[j][2 * r] + s[j][2 * r + 1];
      }
      l[r] = l[r] * alpha + sum;
#pragma unroll
      for (int n = 0; n < kDC / 8; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

    // acc += P V: two adjacent 8-key score tiles form one A operand
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      Reg a[4];
      a[0] = Op::pack(s[2 * kk][0], s[2 * kk][1]);
      a[1] = Op::pack(s[2 * kk][2], s[2 * kk][3]);
      a[2] = Op::pack(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = Op::pack(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < kDC / 8; ++n) {
        const T* vb = vs + (kk * 16 + 2 * t) * kLdV + n * 8 + g;
        Reg b[2];
        b[0] = Op::pair(vb[0], vb[kLdV]);
        b[1] = Op::pair(vb[8 * kLdV], vb[9 * kLdV]);
        Op::mma(acc[n], a, b);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float tot = l[r];
    tot += __shfl_xor_sync(0xffffffffu, tot, 1);
    tot += __shfl_xor_sync(0xffffffffu, tot, 2);
    const float inv = 1.f / tot;
    const int row = q0 + row0 + g + 8 * r;
    if (row < sq) {
      T* orow = o + b * st.v[9] + h * st.v[10] + row * st.v[11] + dc0;
#pragma unroll
      for (int n = 0; n < kDC / 8; ++n)
        *reinterpret_cast<Reg*>(orow + n * 8 + 2 * t) =
            Op::pack(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
      // natural-log logsumexp of the scaled scores: ln 2 * (m + log2 l)
      if constexpr (kLse) {
        if (t == 0 && blockIdx.z == 0)
          lse[size_t(bh) * sq + row] = (m[r] + log2f(tot)) * 0.6931471805599453f;
      }
    }
  }
}

template <int D, bool kLse>
int launch(const float* q, const float* k, const float* v, float* o, float* lse, int b, int h,
           int sq, int sk, float scale, const Strides& st, cudaStream_t stream) {
  using C = Cfg<float, D>;
  constexpr auto kernel = flash_fwd_kernel<float, D, kLse>;
  if (int err = allow_smem<kernel>(C::kSmem)) return err;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, b * h, D / C::kDC);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(q, k, v, o, lse, h, sq, sk,
                                                scale * 1.4426950408889634f, st);
  return int(cudaGetLastError());
}

// B1 at every width, B2 at the U-Nets' widths only: the VAE's d=512 head
// never feeds the attention store.
template <bool kLse>
int dispatch_d(const float* q, const float* k, const float* v, float* o, float* lse, int b, int h,
               int sq, int sk, int d, float scale, const Strides& st, cudaStream_t s) {
  switch (d) {
    case 40: return launch<40, kLse>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
    case 64: return launch<64, kLse>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
    case 72: return launch<72, kLse>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
    case 80: return launch<80, kLse>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
    case 88: return launch<88, kLse>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
    case 128: return launch<128, kLse>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
    case 160: return launch<160, kLse>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
    case 512:
      if constexpr (!kLse) return launch<512, false>(q, k, v, o, lse, b, h, sq, sk, scale, st, s);
      return int(cudaErrorInvalidValue);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// The entry point; its contract is at dft::hopper::forward in
// flash_hopper.cuh.  This library takes dtype 0 (float32) only.
extern "C" int dft_flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                           float* lse, int b, int h, int sq, int sk, int d,
                                           int dtype, float scale, const long long* strides,
                                           void* stream) {
  if (dtype != 0) return int(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 12; ++i) st.v[i] = strides[i];
  const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
              *vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lse ? dispatch_d<true>(qf, kf, vf, of, lse, b, h, sq, sk, d, scale, st, s)
             : dispatch_d<false>(qf, kf, vf, of, lse, b, h, sq, sk, d, scale, st, s);
}
