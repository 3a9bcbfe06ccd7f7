// Fixture: shared memory off its budget (CUD406 twice: a tile that drifted
// from the registered bytes, and a kernel with no budget).
#include <cuda_runtime.h>

constexpr int BM = 64;
constexpr int BK = 32;
constexpr int PAD = 1;

__global__ void tiled_kernel(const float* x, float* o, int n) {
  __shared__ float tile[BM][BK + PAD];
  const int i = blockIdx.x * 128 + threadIdx.x;
  tile[threadIdx.x % BM][threadIdx.x % BK] = x[i];
  __syncthreads();
  o[i] = tile[threadIdx.x % BM][0];
}

__global__ void no_budget_kernel(const float* x, float* o, int n) {
  extern __shared__ float buf[];
  const int i = blockIdx.x * 128 + threadIdx.x;
  buf[threadIdx.x] = x[i];
  __syncthreads();
  o[i] = buf[0];
}

void launch(const float* x, float* o, int n, cudaStream_t s) {
  tiled_kernel<<<(n + 127) / 128, 128, 0, s>>>(x, o, n);
  no_budget_kernel<<<(n + 127) / 128, 128, 128 * sizeof(float), s>>>(x, o, n);
}
