// Host-side launch helpers shared by the kernels.
#pragma once

#include <cuda_runtime.h>

#include <atomic>

namespace repro {

// Let `Kernel` take `smem` bytes of dynamic shared memory on the current
// device. cudaFuncSetAttribute is a CUDA runtime call that a short kernel
// would otherwise pay on every launch, so the limit is raised once per
// kernel and device, and again only when a launch needs more; at or below
// the default 48 KB nothing is set.
template <auto Kernel>
cudaError_t allow_dynamic_smem(int smem) {
  constexpr int kDefault = 48 * 1024;
  constexpr int kDevices = 64;
  static std::atomic<int> granted[kDevices];  // zero: static storage
  if (smem <= kDefault) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool tracked = dev >= 0 && dev < kDevices;
  if (tracked && granted[dev].load(std::memory_order_relaxed) >= smem)
    return cudaSuccess;
  err = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess && tracked) {
    int seen = granted[dev].load(std::memory_order_relaxed);
    while (seen < smem &&
           !granted[dev].compare_exchange_weak(seen, smem,
                                               std::memory_order_relaxed)) {
    }
  }
  return err;
}

}  // namespace repro
