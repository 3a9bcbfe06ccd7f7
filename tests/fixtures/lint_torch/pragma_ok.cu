// Fixture: a real violation suppressed by a well-formed `//` pragma.
#include <cuda_runtime.h>

__global__ void hist_kernel(const int* x, int* bins, int n) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i < n) atomicAdd(&bins[x[i] & 255], 1);  // lint: disable=CUD405(fixture: a histogram, whose counts do not depend on order)
}

void launch(const int* x, int* bins, int n, cudaStream_t s) {
  hist_kernel<<<(n + 255) / 256, 256, 0, s>>>(x, bins, n);
}
