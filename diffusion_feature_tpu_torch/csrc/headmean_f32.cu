// B3 for float32 inputs: head-mean attention probabilities with exact fp32
// products,
//   out[b, i, j] = (1/H) * sum_h exp(q[b,h,i] . k[b,h,j] * scale - lse[b,h,i])
// for (B, H, S, D) q and k and B2's per-row logsumexp.  float32 runs in
// SD-2.1's upcast attention store (the store hands B2 and B3 fp32 q and k);
// bf16 and fp16 take the Hopper kernel of headmean_hopper.cuh.
//
// Replaces diffusion_feature_tpu/ops/flash_attention.py::_headmean_kernel
// (B3) for float32.  What bounds it: one q k^T product per score and head,
// 2 B H Sq Sk D flops on the FMA pipes (67 TFLOP/s on an H100; wgmma has no
// exact fp32 product: TF32 would round the inputs to 10 mantissa bits), and
// one exponential per score and head on the special-function unit, whose
// 16 a clock an SM against 128 FFMA add at most 8/d of the product's issue
// slots; the (B, Sq, Sk) map it writes is a few percent of that time.  So
// the FMA issue rate bounds it, and ahead of it the shared-memory bandwidth
// the product's operands take (see simt_f32.cuh).
//
// The design is flash_f32.cu's score product without its P V half.  A block
// of 16 x 8 threads (ty = tid / 8, tx = tid % 8) owns a 64-row x 64-key
// output tile of one batch and loops over the H heads; thread (ty, tx) owns
// rows ty + 16 i and keys tx + 8 j, a 4 x 8 block held in registers across
// the heads.  For each head simt::nt computes the 4 x 8 scores from the
// shared Q and K tiles (rows at ld = d + 4, so the 8 K rows a quarter-warp
// reads by tx fall on distinct banks; no shuffle anywhere), and the thread
// adds exp2(s * scale * log2 e - lse * log2 e) (simt::exp2_sfu) into its
// block.  cp.async stages each head's Q and K tiles, double-buffered where
// two stages leave room for two blocks an SM (d <= 88), so that head h + 1
// loads while head h computes; at d=128 and 160 one stage leaves room for
// three and two blocks, which overlap each other instead.  Each thread
// reads its 4 rows' logsumexp from global memory before it waits for the
// tiles.  At the end the block writes its tile once, times 1/H, element by
// element (a quarter-warp's eight keys are 32 consecutive bytes of a row,
// and any Sk, odd too, keeps every store aligned), masking rows past Sq
// and keys past Sk; rows and keys past them are zero-filled on load.  q
// and k may be strided views (unit stride on D, 16-byte aligned strides).

#include "simt_f32.cuh"
#include "tile_ops.cuh"

namespace {

using namespace dft;
using namespace dft::simt;

template <int D>
struct Cfg {
  static constexpr int kTX = 8, kThreads = 16 * kTX;   // ty = tid / 8, tx = tid % 8
  static constexpr int kBQ = 64, kBK = 64;             // rows ty + 16 i, keys tx + 8 j
  static constexpr int kTM = kBQ / 16, kTN = kBK / kTX;
  static constexpr int kLd = D + 4;                    // ld / 4 odd: K rows by tx on distinct banks
  static constexpr size_t kStage = size_t(kBQ + kBK) * kLd * sizeof(float);
  static constexpr size_t kHalfSm = 113 * 1024;        // two blocks an SM fit below this
  static constexpr int kStages = 2 * kStage <= kHalfSm ? 2 : 1;
  static constexpr size_t kSmem = kStages * kStage;
  // three blocks an SM up to d=64 (170 registers a thread), as flash_f32.cu
  static constexpr int kMinBlocks = D <= 64 ? 3 : 1;
  static_assert(D % 8 == 0, "the depth is whole float4s, and ld / 4 odd needs d % 8 == 0");
};

// Element strides (sb, sh, ss) of q and k; d has unit stride.
struct Strides {
  long long v[6];
};

template <int D>
__global__ void __launch_bounds__(Cfg<D>::kThreads, Cfg<D>::kMinBlocks)
headmean_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ lse, float* __restrict__ out, int heads, int sq, int sk,
             float scale_log2, Strides st) {
  using C = Cfg<D>;
  constexpr int kBQ = C::kBQ, kBK = C::kBK, kTM = C::kTM, kTN = C::kTN, kLd = C::kLd;
  constexpr int kTX = C::kTX, kThreads = C::kThreads, kStages = C::kStages;
  constexpr int kStageF = (kBQ + kBK) * kLd;          // floats a stage: Q, then K
  constexpr float kLog2e = 1.4426950408889634f;

  extern __shared__ __align__(16) float smem[];

  const int k0 = blockIdx.x * kBK;
  const int q0 = blockIdx.y * kBQ;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int q_valid = min(kBQ, sq - q0), k_valid = min(kBK, sk - k0);
  const float* qg = q + b * st.v[0] + q0 * st.v[2];
  const float* kg = k + b * st.v[3] + k0 * st.v[5];

  auto load_head = [&](int h) {
    float* stage = smem + (h % kStages) * kStageF;
    load_tile_async<kThreads, D>(stage, kLd, qg + h * st.v[1], st.v[2], q_valid, kBQ);
    load_tile_async<kThreads, D>(stage + kBQ * kLd, kLd, kg + h * st.v[4], st.v[5], k_valid,
                                 kBK);
  };
  load_head(0);
  cp_async_commit();

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int h = 0; h < heads; ++h) {
    // this thread's rows' logsumexp in log2 units (rows past Sq: unused)
    const float* lrow = lse + (size_t(b) * heads + h) * sq + q0 + ty;
    float l2[kTM];
#pragma unroll
    for (int i = 0; i < kTM; ++i) l2[i] = ty + 16 * i < q_valid ? lrow[16 * i] * kLog2e : 0.f;
    if constexpr (kStages == 2) {
      if (h + 1 < heads) load_head(h + 1);
      cp_async_commit();
      cp_async_wait<1>();   // head h's tiles landed; head h + 1's may be in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const float* stage = smem + (h % kStages) * kStageF;
    float s[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) s[i][j] = 0.f;
    nt<kTM, kTN, 16, kTX, D, C::kMinBlocks == 3 ? 1 : 2>(s, stage + ty * kLd, kLd,
                                                         stage + (kBQ + tx) * kLd, kLd);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] += exp2_sfu(s[i][j] * scale_log2 - l2[i]);
    __syncthreads();   // every warp is done with this stage before it is loaded again
    if constexpr (kStages == 1) {
      if (h + 1 < heads) {
        load_head(h + 1);
        cp_async_commit();
      }
    }
  }

  const float inv = 1.f / heads;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_valid) continue;
    float* orow = out + (size_t(b) * sq + q0 + r) * sk + k0 + tx;
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      if (tx + kTX * j < k_valid) orow[kTX * j] = acc[i][j] * inv;
  }
}

template <int D>
int launch(const void* q, const void* k, const float* lse, void* out, int b, int h, int sq,
           int sk, float scale, const long long* strides, cudaStream_t stream) {
  using C = Cfg<D>;
  constexpr auto kernel = headmean_f32<D>;
  if (int err = allow_smem<kernel>(C::kSmem)) return err;
  Strides st;
  for (int i = 0; i < 6; ++i) st.v[i] = strides[i];
  const dim3 grid((sk + C::kBK - 1) / C::kBK, (sq + C::kBQ - 1) / C::kBQ, b);
  kernel<<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), lse, static_cast<float*>(out),
      h, sq, sk, scale * 1.4426950408889634f, st);
  return int(cudaGetLastError());
}

}  // namespace

// The entry point; its contract is at dft::hopper::headmean::forward in
// headmean_hopper.cuh.  This library takes dtype 0 (float32) only.
extern "C" int dft_headmean_probs(const void* q, const void* k, const float* lse, void* out,
                                  int b, int h, int sq, int sk, int d, int dtype, float scale,
                                  const long long* strides, int clusters, void* stream) {
  if (dtype != 0 || clusters != 0) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 40: return launch<40>(q, k, lse, out, b, h, sq, sk, scale, strides, s);
    case 64: return launch<64>(q, k, lse, out, b, h, sq, sk, scale, strides, s);
    case 72: return launch<72>(q, k, lse, out, b, h, sq, sk, scale, strides, s);
    case 80: return launch<80>(q, k, lse, out, b, h, sq, sk, scale, strides, s);
    case 88: return launch<88>(q, k, lse, out, b, h, sq, sk, scale, strides, s);
    case 128: return launch<128>(q, k, lse, out, b, h, sq, sk, scale, strides, s);
    case 160: return launch<160>(q, k, lse, out, b, h, sq, sk, scale, strides, s);
    default: return int(cudaErrorInvalidValue);
  }
}
