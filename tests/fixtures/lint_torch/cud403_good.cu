// Fixture: masked kernels that leave an inactive lane before any load.
#include <cuda_runtime.h>

struct Params {
  const float* x;
  float* o;
  const int* active;
  int n;
};

__global__ void late_gate_kernel(Params p) {
  const int j = blockIdx.y;
  const int i = blockIdx.x * 128 + threadIdx.x;
  float* o = p.o + (long long)j * p.n;  // pointer arithmetic reads nothing
  if (p.active != nullptr && p.active[j] == 0) {
    o[i] = 0.f;
    return;
  }
  const float v = p.x[j * p.n + i];
  o[i] = 2.f * v;
}

__global__ void no_gate_kernel(Params p) {
  const int j = blockIdx.y;
  const int i = blockIdx.x * 128 + threadIdx.x;
  if (p.active != nullptr && p.active[j] == 0) {
    p.o[j * p.n + i] = 0.f;
    return;
  }
  p.o[j * p.n + i] = 2.f * p.x[j * p.n + i];
}

__global__ void no_exit_kernel(const float* x, float* o, const int* active,
                               int n) {
  const int j = blockIdx.y;
  const int i = blockIdx.x * 128 + threadIdx.x;
  if (active != nullptr && active[j] == 0) {
    o[j * n + i] = 0.f;
    return;
  }
  o[j * n + i] = 2.f * x[j * n + i];
}

void launch(Params p, int J, cudaStream_t s) {
  const dim3 grid((p.n + 127) / 128, J);
  late_gate_kernel<<<grid, 128, 0, s>>>(p);
  no_gate_kernel<<<grid, 128, 0, s>>>(p);
  no_exit_kernel<<<grid, 128, 0, s>>>(p.x, p.o, p.active, p.n);
}
