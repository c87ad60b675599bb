// B1 and B2 for bfloat16 inputs: the Hopper flash-attention kernel of
// flash_hopper.cuh (wgmma, a TMA ring, warp specialisation), one source per
// type so that the types build in parallel.

#include "flash_hopper.cuh"

// The entry point; its contract is at dft::hopper::forward in
// flash_hopper.cuh.  This library takes dtype 2 (bfloat16) only.
extern "C" int dft_flash_attention_forward(const void* q, const void* k, const void* v, void* o,
                                           float* lse, int b, int h, int sq, int sk, int d,
                                           int dtype, float scale, const long long* strides,
                                           int grid, void* stream) {
  if (dtype != 2) return int(cudaErrorInvalidValue);
  return dft::hopper::forward<__nv_bfloat16>(q, k, v, o, lse, b, h, sq, sk, d, scale, strides,
                                      grid, static_cast<cudaStream_t>(stream));
}

// How many clusters of the ping-pong kernel at head width d the current
// device holds at once (0 where d has none, a negative cudaError_t on
// failure): the bound of ops/flash_attention.py's persistent grid.
extern "C" int dft_flash_cluster_slots(int d, int dtype) {
  if (dtype != 2) return -int(cudaErrorInvalidValue);
  return dft::hopper::cluster_slots<__nv_bfloat16>(d);
}
