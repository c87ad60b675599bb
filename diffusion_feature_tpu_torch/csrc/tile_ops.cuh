// What every kernel source shares, whatever its products: the host's
// dynamic shared-memory limit and SM count helpers (allow_smem, sm_count;
// the Hopper kernels reach them through hopper_common.cuh) and the 4-warp
// block of the backward's delta pre-pass (flash_bwd.cuh).

#pragma once

#include <cuda_runtime.h>

namespace dft {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

// Raise a kernel's dynamic shared-memory limit once per kernel and device,
// so that the launches a CUDA graph captures make no other runtime call.
template <auto kKernel>
inline int allow_smem(size_t bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  if (dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err != cudaSuccess) return int(err);
  if (dev < 64) done[dev] = true;
  return 0;
}

// The card's SM count, read once per device (a persistent grid's size); 0
// where it cannot be read.
inline int sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && counts[dev]) return counts[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < 64) counts[dev] = n;
  return n;
}

}  // namespace dft
