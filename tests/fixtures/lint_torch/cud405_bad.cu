// Fixture: atomics in kernels that owe a fixed reduction order (CUD405
// twice: in the kernel, and in a device function it calls).
#include <cuda_runtime.h>

__device__ void bump_max(int* m, int v) { atomicMax(m, v); }

__global__ void sum_kernel(const float* x, float* sum, int* top, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  atomicAdd(sum, x[i]);
  bump_max(top, i);
}

void launch(const float* x, float* sum, int* top, int n, cudaStream_t s) {
  sum_kernel<<<(n + 255) / 256, 256, 0, s>>>(x, sum, top, n);
}
