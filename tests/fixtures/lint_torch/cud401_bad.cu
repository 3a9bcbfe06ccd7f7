// Fixture: a kernel that reads blockIdx.z under launches that set no z
// axis (CUD401 at both launches).
#include <cuda_runtime.h>

__global__ void scale_kernel(const float* x, float* o, int n) {
  const int j = blockIdx.z;
  const int i = blockIdx.x * 128 + threadIdx.x;
  if (i < n) o[j * n + i] = 2.f * x[j * n + i];
}

void launch_2d(const float* x, float* o, int J, int n, cudaStream_t s) {
  const dim3 grid((n + 127) / 128, J);  // rank 2: blockIdx.z is always 0
  scale_kernel<<<grid, 128, 0, s>>>(x, o, n);
}

void launch_1d(const float* x, float* o, int n, cudaStream_t s) {
  scale_kernel<<<(n + 127) / 128, 128, 0, s>>>(x, o, n);
}
