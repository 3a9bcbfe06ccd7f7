// Packed multi-job GEMM for Hopper (sm_90a): out[j] = x[j] @ w[j] for every
// lane j, with an optional per-lane predicate. Two hand-written bodies,
// chosen by dtype:
//   bf16 -> gemm_wgmma_kernel: tensor-core products (wgmma), operands
//           brought into shared memory by TMA through an mbarrier ring;
//   f32  -> gemm_simt_kernel: f32 FMAs on the CUDA cores. The tensor cores
//           take f32 only as TF32, which the port's parity rules forbid, so
//           the f32 body stays on the CUDA cores.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/packed_gemm.py::packed_gemm
//   (bodies _pg_kernel and _pg_masked_kernel).
// It computes what that kernel computes: x (J,M,K) @ w (J,K,N) -> (J,M,N),
// f32 accumulation, the output rounded once to x's dtype; with a predicate,
// an inactive lane's output is exact zeros and an active lane's output is
// bit-identical to the unmasked launch.
//
// What bounds it on an H100: at the lane pool's step shape (J=16,
// M=K=N=256, f32) the function needs 0.54 GFLOP and moves 12.6 MB, so it is
// bound by operations (8.0 us at 67 TFLOP/s f32, against 3.8 us of bytes);
// at one StableLM-2 MLP up-projection per lane (J=4, M=512, K=2048,
// N=5632, bf16) it is 47 GFLOP, bound by the tensor cores (48 us at 989
// TFLOP/s, against 37 us of bytes).
//
// Determinism: each output tile is computed by one CTA over the whole K
// loop in a fixed order (no split-K, no atomics), so masked == dense bit
// for bit in both bodies. A dead lane's CTA stores zeros and returns before
// any load (the TPU kernel still streams those tiles).
//
// wgmma body. One CTA of 384 threads per 128 x 256 output tile of one lane;
// grid (ceil(N/256), ceil(M/128), J). Warpgroup 0 is the producer: one
// thread keeps TMA loads of x (128 x 64) and w (64 x 256) tiles in flight
// in a ring of 4 stages (48 KB each) with full/empty mbarriers; warpgroups
// 1 and 2 are consumers, each owning 64 rows of the tile with a 64 x 256
// f32 accumulator in registers (m64n256k16, both operands in shared
// memory). A consumer releases a stage only after its wgmma on that stage
// has completed (wait_group 1 after the next stage's products are issued).
// Operands are described by tensor maps built per launch (tma.cuh): x is
// K-major (K contiguous) or, for the gradient GEMM's x^T view, M-major (the
// map is laid over the contiguous M axis and the transpose bit is set); w
// is N-major (N contiguous), which wgmma takes through the transpose bit.
// TMA's zero fill supplies the zeros past the M, N and K edges; the
// epilogue rounds once to bf16 and stores with the M/N edges masked. TMA
// needs a 16-byte aligned base and every stride but the innermost a
// multiple of 16 bytes; the Python wrapper copies an operand that breaks
// that into a contiguous buffer whose contiguous axis is zero-padded to a
// multiple of 8 (zero products add exact zeros) and counts the copy.
//
// simt body (f32). Each CTA stages a 64x16 tile of x and a 16x64 tile of w
// in shared memory per K step, so each input element is read from device
// memory once per 64-wide output tile; every output element is one f32 FMA
// chain over k = 0..K-1 in order. Loads past an edge read zeros and stores
// past an edge are skipped; x and w are read through their element strides,
// so a transposed view costs no copy: the tile load walks whichever of the
// two axes is contiguous. Grid: (ceil(N/64), ceil(M/64), J); 256 threads;
// thread t owns rows 4*(t/16)..+3 and columns t%16 + 16*c of the 64x64
// output tile.

#include <cuda_runtime.h>

#include "dtype.cuh"
#include "launch.cuh"
#include "tma.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

// ---------------------------------------------------------------------------
// simt body (f32)
// ---------------------------------------------------------------------------

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
__global__ void __launch_bounds__(THREADS) gemm_simt_kernel(Params p) {
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


// ---------------------------------------------------------------------------
// wgmma body (bf16)
// ---------------------------------------------------------------------------

namespace wg {

using namespace repro::tma;

constexpr int BM = 128;
constexpr int BN = 256;
constexpr int BK = 64;                   // 128 bytes of bf16: one swizzle row
constexpr int STAGES = 4;
constexpr int THREADS = 384;             // producer + 2 consumer warpgroups
constexpr int A_BYTES = BM * BK * 2;     // 16 KB
constexpr int B_BYTES = BK * BN * 2;     // 32 KB
constexpr int SUB = 64 * BK * 2;         // one 64-wide block of an operand
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;

struct Params {
  void* o;
  const int* active;  // (J,) or nullptr
  int J, M, N, K;
};

__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int n, int N,
                                           float a, float b) {
  if (n + 1 < N && (N & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + n) = __floats2bfloat162_rn(a, b);
  } else {
    if (n < N) row[n] = __float2bfloat16(a);
    if (n + 1 < N) row[n + 1] = __float2bfloat16(b);
  }
}

// TA = 1: x is M-major (the transposed view); else K-major.
template <int TA>
__global__ void __launch_bounds__(THREADS, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w, Params p) {
  extern __shared__ uint8_t smem_raw[];
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int j = blockIdx.z;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + (long long)j * p.M * p.N;

  if (p.active != nullptr && p.active[j] == 0) {
    for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
      const int r = idx / BN, c = idx % BN;
      if (m0 + r < p.M && n0 + c < p.N)
        o[(long long)(m0 + r) * p.N + n0 + c] = __float2bfloat16(0.f);
    }
    return;
  }

  uint8_t* base = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + STAGES * STAGE_BYTES);
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int nk = (p.K + BK - 1) / BK;
  const int group = threadIdx.x / 128;
  if (group == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(&empty[s], (kt / STAGES - 1) & 1);
        uint8_t* a = base + s * STAGE_BYTES;
        uint8_t* b = a + A_BYTES;
        const int k0 = kt * BK;
        mbar_expect_tx(&full[s], STAGE_BYTES);
        if (TA) {
          tma_load_3d(a, &map_x, &full[s], m0, k0, j);
          tma_load_3d(a + SUB, &map_x, &full[s], m0 + 64, k0, j);
        } else {
          tma_load_3d(a, &map_x, &full[s], k0, m0, j);
        }
#pragma unroll
        for (int c = 0; c < BN / 64; ++c)
          tma_load_3d(b + c * SUB, &map_w, &full[s], n0 + 64 * c, k0, j);
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int c = group - 1;  // rows m0 + 64 c .. m0 + 64 c + 63
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(&full[s], (kt / STAGES) & 1);
      const uint8_t* a = base + s * STAGE_BYTES + c * SUB;
      const uint8_t* b = base + s * STAGE_BYTES + A_BYTES;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = TA ? desc_sw128(a + kk * 2048, SUB, 1024)
                               : desc_sw128(a + kk * 32, 16, 1024);
        const uint64_t db = desc_sw128(b + kk * 2048, SUB, 1024);
        wgmma_m64n256k16_ss<TA, 1>(acc, da, db, 1);
      }
      wgmma_commit();
      fence_operands(acc);
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      fence_operands(acc);
      if (kt > 0 && threadIdx.x % 128 == 0)
        mbar_arrive(&empty[(kt - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_operands(acc);

    const int t = threadIdx.x % 128;
    const int r0 = m0 + 64 * c + 16 * (t / 32) + (t % 32) / 4;
    const int col = n0 + 2 * (t % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + 8 * h;
      if (r >= p.M) continue;
      __nv_bfloat16* row = o + (long long)r * p.N;
#pragma unroll
      for (int jj = 0; jj < BN / 8; ++jj)
        store_pair(row, col + 8 * jj, p.N, acc[4 * jj + 2 * h],
                   acc[4 * jj + 2 * h + 1]);
    }
  }
}

template <int TA>
int launch(const CUtensorMap& mx, const CUtensorMap& mw, const Params& p,
           cudaStream_t stream) {
  cudaError_t err = repro::allow_dynamic_smem<gemm_wgmma_kernel<TA>>(SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM, p.J);
  gemm_wgmma_kernel<TA><<<grid, THREADS, SMEM, stream>>>(mx, mw, p);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// f32 body. Strides are in elements; out is contiguous (J, M, N). Returns a
// cudaError_t (0 on success); the Python wrapper raises on anything else.
extern "C" int repro_packed_gemm(
    const void* x, const void* w, void* out, const void* active,
    int J, int M, int N, int K,
    long long x_sj, long long x_sm, long long x_sk,
    long long w_sj, long long w_sk, long long w_sn, void* stream) {
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
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, J);
  gemm_simt_kernel<float><<<grid, THREADS, 0, static_cast<cudaStream_t>(
      stream)>>>(p);
  return cudaGetLastError();
}

// bf16 body. x is K-major (x_m_major = 0: x_sk == 1, x_inner = its K
// extent, which a padded copy may round up) or M-major (x_m_major = 1:
// x_sm == 1, x_inner = M); w is N-major (w_sn == 1, w_inner = its N extent,
// possibly rounded up). Strides are in elements, every one but the
// innermost a multiple of 8, bases 16-byte aligned (the wrapper checks).
// out is contiguous (J, M, N). Returns 0, a cudaError_t, or the negated
// CUresult of a refused tensor map.
extern "C" int repro_packed_gemm_wgmma(
    const void* x, const void* w, void* out, const void* active,
    int J, int M, int N, int K,
    long long x_sj, long long x_outer, int x_m_major, long long x_inner,
    long long w_sj, long long w_sk, long long w_inner, void* stream) {
  using namespace repro::tma;
  CUtensorMap mx, mw;
  int err;
  if (x_m_major) {  // (M, K, J): M contiguous, x_outer = x_sk
    const uint64_t dims[3] = {(uint64_t)x_inner, (uint64_t)K, (uint64_t)J};
    const uint64_t strides[2] = {(uint64_t)x_outer * 2, (uint64_t)x_sj * 2};
    const uint32_t box[3] = {64, wg::BK, 1};
    err = encode_bf16(&mx, x, 3, dims, strides, box);
  } else {          // (K, M, J): K contiguous, x_outer = x_sm
    const uint64_t dims[3] = {(uint64_t)x_inner, (uint64_t)M, (uint64_t)J};
    const uint64_t strides[2] = {(uint64_t)x_outer * 2, (uint64_t)x_sj * 2};
    const uint32_t box[3] = {wg::BK, wg::BM, 1};
    err = encode_bf16(&mx, x, 3, dims, strides, box);
  }
  if (err != 0) return err;
  {
    const uint64_t dims[3] = {(uint64_t)w_inner, (uint64_t)K, (uint64_t)J};
    const uint64_t strides[2] = {(uint64_t)w_sk * 2, (uint64_t)w_sj * 2};
    const uint32_t box[3] = {64, wg::BK, 1};
    err = encode_bf16(&mw, w, 3, dims, strides, box);
  }
  if (err != 0) return err;
  wg::Params p;
  p.o = out;
  p.active = static_cast<const int*>(active);
  p.J = J;
  p.M = M;
  p.N = N;
  p.K = K;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_m_major ? wg::launch<1>(mx, mw, p, s) : wg::launch<0>(mx, mw, p, s);
}
