// Fixture: every blockIdx axis the kernel reads is set by its launch.
#include <cuda_runtime.h>

__global__ void scale_kernel(const float* x, float* o, int n) {
  const int j = blockIdx.z;
  const int i = blockIdx.x * 128 + threadIdx.x;
  if (i < n) o[j * n + i] = 2.f * x[j * n + i];
}

__global__ void copy_kernel(const float* x, float* o, int n) {
  const int i = blockIdx.x * 128 + threadIdx.x;
  if (i < n) o[i] = x[i];
}

void launch(const float* x, float* o, int J, int n, cudaStream_t s) {
  const dim3 grid((n + 127) / 128, 1, J);
  scale_kernel<<<grid, 128, 0, s>>>(x, o, n);
  copy_kernel<<<(n + 127) / 128, 128, 0, s>>>(x, o, n);
}
