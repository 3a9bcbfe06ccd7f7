// Fixture: an inactive lane's outputs written exact zeros, directly, through
// a dereference, or by a device function.
#include <cuda_runtime.h>

template <typename T>
__device__ void zero_row(T* o, int n) {
  for (int e = threadIdx.x; e < n; e += 128) o[e] = T(0);
}

__global__ void two_out_kernel(const float* x, float* o, float* state,
                               const int* active, int n) {
  const int j = blockIdx.y;
  const int i = blockIdx.x * 128 + threadIdx.x;
  float4* st = reinterpret_cast<float4*>(state + 4 * j);
  if (active != nullptr && active[j] == 0) {
    o[j * n + i] = 0.f;
    *st = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  o[j * n + i] = x[j * n + i];
  *st = make_float4(x[j * n], 0.f, 0.f, 0.f);
}

__global__ void ones_kernel(const float* x, float* o, const int* active,
                            int n) {
  const int j = blockIdx.y;
  if (active != nullptr && active[j] == 0) {
    zero_row<float>(o + (long long)j * n, n);
    return;
  }
  const int i = blockIdx.x * 128 + threadIdx.x;
  o[j * n + i] = x[j * n + i];
}

void launch(const float* x, float* o, float* st, const int* a, int J, int n,
            cudaStream_t s) {
  const dim3 grid((n + 127) / 128, J);
  two_out_kernel<<<grid, 128, 0, s>>>(x, o, st, a, n);
  ones_kernel<<<grid, 128, 0, s>>>(x, o, a, n);
}
