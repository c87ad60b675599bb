// B4 for bfloat16 inputs: the Hopper short-attention kernel of short_hopper.cuh
// (two wgmma passes, TMA, a producer warp), one source per type so that the
// types build in parallel.

#include "short_hopper.cuh"

// The entry point; its contract is at dft::hopper::short_attn::forward in
// short_hopper.cuh.  This library takes dtype 2 (bfloat16) only.
extern "C" int dft_short_attention_forward(const void* q, const void* k, const void* v, void* o,
                                           int b, int h, int sq, int sk, int d, int dtype,
                                           float scale, const long long* strides, void* stream) {
  if (dtype != 2) return int(cudaErrorInvalidValue);
  return dft::hopper::short_attn::forward<__nv_bfloat16>(
      q, k, v, o, b, h, sq, sk, d, scale, strides, static_cast<cudaStream_t>(stream));
}
