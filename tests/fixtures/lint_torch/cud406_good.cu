// Fixture: static and dynamic shared memory from tile constants (a struct
// template's members, a template parameter bound at nominal dims) within
// the budget.
#include <cuda_runtime.h>

namespace tiles {

constexpr int PAD = 1;

template <int BM_, int BK_>
struct Tile {
  static constexpr int BM = BM_, BK = BK_;
  static constexpr int LD = BK + PAD;
  static constexpr int BYTES = BM * LD * (int)sizeof(float);
};

using Chosen = Tile<64, 32>;

template <typename C>
__global__ void tiled_kernel(const float* x, float* o, int n) {
  constexpr int BM = C::BM, LD = C::LD;
  __shared__ __align__(16) float tile[2][BM * LD];
  extern __shared__ float extra[];
  const int i = blockIdx.x * 128 + threadIdx.x;
  tile[0][threadIdx.x % (BM * LD)] = x[i];
  extra[threadIdx.x] = x[i];
  __syncthreads();
  o[i] = tile[0][0] + extra[0];
}

template <int D>
void launch(const float* x, float* o, int n, cudaStream_t s) {
  using C = Chosen;
  const int smem = D * 128 > 4096 ? D * 128 : 4096;
  tiled_kernel<C><<<(n + 127) / 128, 128, smem, s>>>(x, o, n);
}

}  // namespace tiles
