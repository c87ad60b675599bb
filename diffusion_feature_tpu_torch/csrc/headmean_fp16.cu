// B3 for float16 inputs: the Hopper head-mean kernel of headmean_hopper.cuh
// (wgmma, a TMA ring over heads, warp specialisation), one source per type
// so that the types build in parallel.

#include "headmean_hopper.cuh"

// The entry point; its contract is at dft::hopper::headmean::forward in
// headmean_hopper.cuh.  This library takes dtype 1 (float16) only.
extern "C" int dft_headmean_probs(const void* q, const void* k, const float* lse, void* out,
                                  int b, int h, int sq, int sk, int d, int dtype, float scale,
                                  const long long* strides, int clusters, void* stream) {
  if (dtype != 1) return int(cudaErrorInvalidValue);
  return dft::hopper::headmean::forward<__half>(q, k, lse, out, b, h, sq, sk, d, scale, strides,
                                              clusters, static_cast<cudaStream_t>(stream));
}

// How many clusters of the d=72/88 cluster kernel at head width d the
// current device holds at once (0 where d has none, a negative cudaError_t
// on failure): the bound of ops/flash_attention.py's headmean_clusters.
extern "C" int dft_headmean_cluster_slots(int d, int dtype) {
  if (dtype != 1) return -int(cudaErrorInvalidValue);
  return dft::hopper::headmean::cluster_slots<__half>(d);
}
