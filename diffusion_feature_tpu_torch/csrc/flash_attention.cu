// Flash-attention forward for Hopper (sm_90a): non-causal, unmasked
// softmax(q k^T * scale) v over (B*H, S, D) tensors, with an fp32 running
// max, denominator and accumulator, so the (Sq, Sk) score matrix never
// reaches device memory.
//
// Replaces diffusion_feature_tpu/ops/flash_attention.py::_flash_kernel.
// On the TPU the key axis was a sequential grid dimension carrying its state
// in VMEM scratch; here one thread block owns 64 query rows of one (b, h)
// and walks every key tile itself, so nothing is carried between blocks.
//
// What bounds it: at the main path's d=64 and 4096 tokens one call does
// 4*B*H*S^2*D flops on 4*B*H*S*D*2 bytes, about 4000 flops per byte, far
// above the card's ~295 bf16 flops per byte, so the tensor cores (and the
// S^2 exponentials beside them) are the limit, not memory.  This first
// version spends its time on that side: QK^T and PV run on the tensor cores
// through mma.sync m16n8k16 (bf16/fp16 in, fp32 accumulate), the scores stay
// in registers, the softmax uses exp2 with the scale folded in, and each
// K/V tile is read from device memory once per 64 query rows.  It does not
// yet overlap loads with compute (no cp.async/TMA) nor use wgmma; both are
// the next steps toward the card's peak.
//
// Layout: each of the 4 warps owns 16 query rows.  A fragment element
// (row, col) of an m16n8k16 operand lives in lane 4*(row%8) + (col%8)/2, so
// the score accumulator of two adjacent 8-key tiles is already the A operand
// of the PV product.  Head width d=512 (the VAE's single head) does not fit
// a 16x512 fp32 accumulator in registers: blockIdx.z splits the output
// columns into 128-wide slices and each slice recomputes the scores.
//
// fp32 inputs take the same code with the tensor-core product replaced by
// an exact fp32 FMA emulation of the same fragment layout (TF32 would round
// the inputs to 10 mantissa bits).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kBlockM = kWarps * 16;  // query rows per block
constexpr int kPad = 8;               // elements of padding per shared row

template <typename T>
struct Ops;

template <>
struct Ops<__nv_bfloat16> {
  using Reg = uint32_t;  // two bf16 values
  static __device__ __forceinline__ Reg load2(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ Reg pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    __nv_bfloat162 v = __halves2bfloat162(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ Reg pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float c[4], const Reg a[4], const Reg b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Ops<__half> {
  using Reg = uint32_t;  // two fp16 values
  static __device__ __forceinline__ Reg load2(const __half* p) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  static __device__ __forceinline__ Reg pair(__half lo, __half hi) {
    __half2 v = __halves2half2(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ Reg pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float c[4], const Reg a[4], const Reg b[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};

template <>
struct Ops<float> {
  using Reg = float2;
  static __device__ __forceinline__ Reg load2(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ Reg pair(float lo, float hi) { return make_float2(lo, hi); }
  static __device__ __forceinline__ Reg pack(float lo, float hi) { return make_float2(lo, hi); }
  // c += a * b for one 16x8x16 tile in mma.sync's fragment layout, in fp32.
  // A(row, k) sits in lane 4*(row%8) + (k%8)/2, register 2*(k/8) + row/8;
  // B(k, n) in lane 4*n + (k%8)/2, register k/8; this lane's outputs are
  // rows g and g+8, columns 2t and 2t+1.
  static __device__ __forceinline__ void mma(float c[4], const Reg a[4], const Reg b[2]) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int h = k >> 3, sub = (k & 7) >> 1;
      const bool odd = k & 1;
      const float a_lo = __shfl_sync(0xffffffffu, odd ? a[2 * h].y : a[2 * h].x, (g << 2) | sub);
      const float a_hi = __shfl_sync(0xffffffffu, odd ? a[2 * h + 1].y : a[2 * h + 1].x, (g << 2) | sub);
      const float bv = odd ? b[h].y : b[h].x;
      const float b0 = __shfl_sync(0xffffffffu, bv, ((2 * t) << 2) | sub);
      const float b1 = __shfl_sync(0xffffffffu, bv, ((2 * t + 1) << 2) | sub);
      c[0] = fmaf(a_lo, b0, c[0]);
      c[1] = fmaf(a_lo, b1, c[1]);
      c[2] = fmaf(a_hi, b0, c[2]);
      c[3] = fmaf(a_hi, b1, c[3]);
    }
  }
};

template <typename T, int D>
struct Cfg {
  static constexpr int kDC = D < 128 ? D : 128;         // output columns per block
  static constexpr int kBlockN = D <= 128 ? 64 : 32;    // keys per tile
  static constexpr int kLdQK = D + kPad;
  static constexpr int kLdV = kDC + kPad;
  static constexpr size_t kSmem =
      (size_t(kBlockM) * kLdQK + size_t(kBlockN) * kLdQK + size_t(kBlockN) * kLdV) * sizeof(T);
};

// Copy `rows` rows of COLS elements into shared memory with 16-byte vectors;
// rows at or past `valid` are zero-filled (the ragged edge of the sequence).
template <typename T, int COLS>
__device__ __forceinline__ void load_tile(T* dst, int ld, const T* src, int src_stride,
                                          int valid, int rows) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = COLS / kVec;
  for (int i = threadIdx.x; i < rows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * kVec;
    int4 val = make_int4(0, 0, 0, 0);
    if (r < valid) val = *reinterpret_cast<const int4*>(src + size_t(r) * src_stride + c);
    *reinterpret_cast<int4*>(dst + r * ld + c) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int sq, int sk, float scale_log2) {
  using C = Cfg<T, D>;
  using Op = Ops<T>;
  using Reg = typename Op::Reg;
  constexpr int kDC = C::kDC, kBN = C::kBlockN, kLdQK = C::kLdQK, kLdV = C::kLdV;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);
  T* ks = qs + kBlockM * kLdQK;
  T* vs = ks + kBN * kLdQK;

  const int q0 = blockIdx.x * kBlockM;
  const size_t bh = blockIdx.y;
  const int dc0 = blockIdx.z * kDC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = warp * 16;

  const T* kg = k + bh * sk * D;
  const T* vg = v + bh * sk * D + dc0;
  load_tile<T, D>(qs, kLdQK, q + (bh * sq + q0) * D, D, min(kBlockM, sq - q0), kBlockM);

  float acc[kDC / 8][4];
#pragma unroll
  for (int n = 0; n < kDC / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g+8 (log2 units)
  float l[2] = {0.f, 0.f};              // this lane's share of the running denominator

  for (int k0 = 0; k0 < sk; k0 += kBN) {
    __syncthreads();  // every warp is done with the previous K/V tile
    const int kv_valid = min(kBN, sk - k0);
    load_tile<T, D>(ks, kLdQK, kg + size_t(k0) * D, D, kv_valid, kBN);
    load_tile<T, kDC>(vs, kLdV, vg + size_t(k0) * D, D, kv_valid, kBN);
    __syncthreads();

    // scores of this warp's 16 rows against the kBN keys of the tile
    float s[kBN / 8][4];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D / 16; ++kk) {
      const T* qa = qs + (row0 + g) * kLdQK + kk * 16 + 2 * t;
      Reg a[4];
      a[0] = Op::load2(qa);
      a[1] = Op::load2(qa + 8 * kLdQK);
      a[2] = Op::load2(qa + 8);
      a[3] = Op::load2(qa + 8 * kLdQK + 8);
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        const T* kb = ks + (j * 8 + g) * kLdQK + kk * 16 + 2 * t;
        Reg b[2];
        b[0] = Op::load2(kb);
        b[1] = Op::load2(kb + 8);
        Op::mma(s[j], a, b);
      }
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
      T* orow = o + (bh * sq + row) * D + dc0;
#pragma unroll
      for (int n = 0; n < kDC / 8; ++n)
        *reinterpret_cast<Reg*>(orow + n * 8 + 2 * t) =
            Op::pack(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
           float scale, cudaStream_t stream) {
  using C = Cfg<T, D>;
  auto kernel = flash_fwd_kernel<T, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(C::kSmem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((sq + kBlockM - 1) / kBlockM, bh, D / C::kDC);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, sk, scale * 1.4426950408889634f);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int bh, int sq, int sk,
               int d, float scale, cudaStream_t stream) {
  switch (d) {
    case 64: return launch<T, 64>(q, k, v, o, bh, sq, sk, scale, stream);
    case 128: return launch<T, 128>(q, k, v, o, bh, sq, sk, scale, stream);
    case 512: return launch<T, 512>(q, k, v, o, bh, sq, sk, scale, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// q, k, v, o: contiguous (bh, s, d) device buffers of one dtype, 16-byte
// aligned.  dtype: 0 float32, 1 float16, 2 bfloat16.  Launches on `stream`
// without synchronising and returns the cudaError_t of the launch.
extern "C" int dft_flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                           int bh, int sq, int sk, int d, int dtype,
                                           float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_d<float>(q, k, v, o, bh, sq, sk, d, scale, s);
    case 1: return dispatch_d<__half>(q, k, v, o, bh, sq, sk, d, scale, s);
    case 2: return dispatch_d<__nv_bfloat16>(q, k, v, o, bh, sq, sk, d, scale, s);
    default: return int(cudaErrorInvalidValue);
  }
}
