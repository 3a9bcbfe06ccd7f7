// Fixture: a reduction in a fixed order (warp shuffles, one writer per
// block); the host's std::atomic is not device code.
#include <cuda_runtime.h>

#include <atomic>

__device__ float warp_sum(float v) {
  for (int o = 16; o > 0; o /= 2) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void sum_kernel(const float* x, float* partial, int n) {
  const int i = blockIdx.x * 32 + threadIdx.x;
  const float v = warp_sum(i < n ? x[i] : 0.f);
  if (threadIdx.x == 0) partial[blockIdx.x] = v;
}

int launch(const float* x, float* partial, int n, cudaStream_t s) {
  static std::atomic<int> calls{0};
  calls.fetch_add(1);
  sum_kernel<<<(n + 31) / 32, 32, 0, s>>>(x, partial, n);
  return calls.load();
}
