// Packed multi-job GEMM for Hopper (sm_90a): out[j] = x[j] @ w[j] for every
// lane j, with an optional per-lane predicate.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/packed_gemm.py::packed_gemm
//   (bodies _pg_kernel and _pg_masked_kernel).
// It computes what that kernel computes: x (J,M,K) @ w (J,K,N) -> (J,M,N),
// inputs widened to f32, f32 accumulation, the output rounded once to x's
// dtype; with a predicate, an inactive lane's output is exact zeros and an
// active lane's output is bit-identical to the unmasked launch.
//
// What bounds it on an H100: at the lane pool's step shape (J=16,
// M=K=N=256, f32) the function needs 0.54 GFLOP and moves 12.6 MB, so it is
// bound by operations (8.0 us at 67 TFLOP/s f32, against 3.8 us of bytes);
// at one StableLM-2 MLP up-projection per lane (J=4, M=512, K=2048,
// N=5632, bf16) it is 47 GFLOP, bound by the tensor cores (48 us). This
// first version runs f32 FMAs on the CUDA cores, so it is bound by FP32
// issue and shared-memory reads at both shapes and reaches neither bound;
// mma.sync/wgmma on bf16 tiles with TMA loads are the next step. What the
// design does about the bytes: each CTA stages a 64x16 tile of x and a
// 16x64 tile of w in shared memory per K step, so each input element is
// read from device memory once per 64-wide output tile; an inactive lane's
// CTA stores zeros and returns before any load (the TPU kernel still
// streams those tiles).
//
// Determinism: every output element is one f32 FMA chain over k = 0..K-1
// in order (no split-K, no atomics), so masked == dense bit for bit.
// Ragged edges: M, N and K need not be multiples of the tile; loads past
// an edge read zeros and stores past an edge are skipped; nothing is
// padded in memory. x and w are read through their element strides, so a
// transposed view (the gradient GEMM's x^T) costs no copy: the tile load
// walks whichever of the two axes is contiguous.
//
// Grid: (ceil(N/64), ceil(M/64), J); 256 threads; thread t owns rows
// 4*(t/16)..+3 and columns t%16 + 16*c of the 64x64 output tile.

#include <cuda_runtime.h>

#include "dtype.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int PAD = 4;  // shared-memory row padding

struct Params {
  const void* x;
  const void* w;
  void* o;
  const int* active;  // (J,) or nullptr
  int J, M, N, K;
  long long x_sj, x_sm, x_sk;
  long long w_sj, w_sk, w_sn;
};

template <typename T>
__global__ void __launch_bounds__(THREADS) packed_gemm_kernel(Params p) {
  __shared__ float sX[BK][BM + PAD];  // sX[k][m]
  __shared__ float sW[BK][BN + PAD];  // sW[k][n]

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int j = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  T* o = static_cast<T*>(p.o) + (long long)j * p.M * p.N;

  if (p.active != nullptr && p.active[j] == 0) {
    for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
      const int r = idx / BN, c = idx % BN;
      if (m0 + r < p.M && n0 + c < p.N)
        o[(long long)(m0 + r) * p.N + n0 + c] = from_f32<T>(0.f);
    }
    return;
  }

  const T* x = static_cast<const T*>(p.x) + j * p.x_sj;
  const T* w = static_cast<const T*>(p.w) + j * p.w_sj;
  // walk the contiguous axis with neighbouring threads
  const bool x_m_fast = p.x_sm == 1 && p.x_sk != 1;
  const bool w_k_fast = p.w_sk == 1 && p.w_sn != 1;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += THREADS) {
      const int r = x_m_fast ? idx % BM : idx / BK;  // m within the tile
      const int c = x_m_fast ? idx / BM : idx % BK;  // k within the tile
      const int m = m0 + r, k = k0 + c;
      float v = 0.f;
      if (m < p.M && k < p.K) v = to_f32(x[m * p.x_sm + k * p.x_sk]);
      sX[c][r] = v;
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
      const int r = w_k_fast ? idx % BK : idx / BN;  // k within the tile
      const int c = w_k_fast ? idx / BK : idx % BN;  // n within the tile
      const int k = k0 + r, n = n0 + c;
      float v = 0.f;
      if (k < p.K && n < p.N) v = to_f32(w[k * p.w_sk + n * p.w_sn]);
      sW[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sX[kk][ty * 4 + i];
#pragma unroll
      for (int c = 0; c < 4; ++c) b[c] = sW[kk][tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
    __syncthreads();  // the tiles are read before the next load
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= p.M) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int n = n0 + tx + 16 * c;
      if (n < p.N) o[(long long)m * p.N + n] = from_f32<T>(acc[i][c]);
    }
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.J);
  packed_gemm_kernel<T><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it). Strides are in
// elements; out is contiguous (J, M, N). Returns a cudaError_t (0 on
// success); the Python wrapper raises on anything else.
extern "C" int repro_packed_gemm(
    const void* x, const void* w, void* out, const void* active,
    int J, int M, int N, int K,
    long long x_sj, long long x_sm, long long x_sk,
    long long w_sj, long long w_sk, long long w_sn,
    int dtype, void* stream) {
  Params p;
  p.x = x;
  p.w = w;
  p.o = out;
  p.active = static_cast<const int*>(active);
  p.J = J;
  p.M = M;
  p.N = N;
  p.K = K;
  p.x_sj = x_sj; p.x_sm = x_sm; p.x_sk = x_sk;
  p.w_sj = w_sj; p.w_sk = w_sk; p.w_sn = w_sn;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
