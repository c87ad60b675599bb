// W8A16 for bfloat16 activations: the int8 weight-only dense product of
// w8a16.cuh, one source per type so that the types build in parallel.

#include "w8a16.cuh"

// The entry point; its contract is at dft::w8a16::forward in w8a16.cuh.
// This library takes dtype 2 (bfloat16) only.
extern "C" int dft_w8a16_linear(const void* x, const int8_t* q, const float* scale,
                                const void* bias, void* y, int m, int n, int k, int dtype,
                                int route, void* stream) {
  if (dtype != 2) return int(cudaErrorInvalidValue);
  return dft::w8a16::forward<__nv_bfloat16>(x, q, scale, bias, y, m, n, k, route,
      static_cast<cudaStream_t>(stream));
}
