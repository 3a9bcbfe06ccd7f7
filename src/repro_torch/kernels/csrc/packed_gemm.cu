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
// simt body (f32), a SIMT SGEMM in the manner of CUTLASS's. One CTA of
// 256 threads per 128 x 64 output tile of one lane; grid (ceil(N/64),
// ceil(M/128), J): 128 CTAs, one wave of 132 SMs, at the pool step's
// shape. Thread (ty, tx) of a 16 x 16 grid owns an 8 x 4 register tile:
// rows 4ty..4ty+3 and 64+4ty..64+4ty+3, columns 4tx..4tx+3; a warp spans
// 4 ty by 8 tx, so each k reads its 12 operands as three LDS.128 that hit
// distinct banks or broadcast (32 FMAs per 3 shared loads). Shared memory
// holds both operands k-major, sX[k][m] and sW[k][n], in two stages of 16
// k each.
// Each thread holds two K tiles' global loads in registers: the loads of
// tile t + 2 are issued as the CTA starts on tile t, and stored into the
// free stage after tile t's products, so a load has two steps of products
// to arrive in, with one __syncthreads per K step. Global loads are float4
// along whichever axis of an operand is contiguous (a K-major x or w is
// transposed on its way into shared memory, an M-major x or N-major w is
// stored straight) and scalar where the operand is unaligned or its other
// strides are not multiples of 4 (operand_mode decides, per operand); x
// and w are read through their element strides, so the gradient GEMM's x^T
// view costs no copy. Loads past an M, N or K edge read zeros; the
// epilogue stores float4s where N is a multiple of 4 and masks the edges.
// Every output element is one fmaf chain over k = 0..K-1 in order from 0
// (a zero past K adds an exact zero), so the bits do not depend on the
// tile shape.

#include <cuda_runtime.h>

#include "dtype.cuh"
#include "launch.cuh"
#include "tma.cuh"

namespace {

// ---------------------------------------------------------------------------
// simt body (f32)
// ---------------------------------------------------------------------------

namespace simt {

// BM x BN output tile; thread (ty, tx) owns TM rows in groups of 4 at
// 4 ty + 4 TY g and TN columns in groups of 4 at 4 tx + 4 TX g
template <int BM_, int BN_, int TM_, int TN_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, TM = TM_, TN = TN_;
  static constexpr int BK = 16;
  static constexpr int TY = BM / TM, TX = BN / TN;  // the thread grid
  static constexpr int THREADS = TY * TX;
  static_assert(TY % 4 == 0 && TX % 8 == 0, "a warp spans 4 ty by 8 tx");
};

// 256 threads; 64 x 64 tiles of 8 x 4 or 4 x 4 per thread were slower at
// the pool step's shape (PERF.md, section 6)
using Chosen = Tile<128, 64, 8, 4>;

// row padding: keeps rows 16-byte aligned, spreads the k-fast stores
constexpr int PAD = 4;

// How an operand is read: bit 0 set walks K (else M or N), bit 1 set loads
// float4s along that axis.
constexpr int K_FAST = 1;
constexpr int VEC4 = 2;

// The mode of an operand (J, MN, K) with element strides s_j, s_mn, s_k,
// from those and its base alone: along K if s_k < s_mn, else along M or N
// (also on a tie); float4 loads when that axis is contiguous, the base
// 16-byte aligned and every other stride of an axis longer than 1 a
// multiple of 4 elements (an axis of length 1 is never stepped over).
inline int operand_mode(const float* base, int J, int MN, int K,
                        long long s_j, long long s_mn, long long s_k) {
  const bool k_fast = s_k < s_mn;
  const bool vec = (k_fast ? s_k : s_mn) == 1 &&
                   (reinterpret_cast<uintptr_t>(base) & 15u) == 0 &&
                   (J == 1 || s_j % 4 == 0) &&
                   (k_fast ? MN == 1 || s_mn % 4 == 0
                           : K == 1 || s_k % 4 == 0);
  return (k_fast ? K_FAST : 0) | (vec ? VEC4 : 0);
}

struct Params {
  const float* x;
  const float* w;
  float* o;
  const int* active;  // (J,) or nullptr
  int J, M, N, K;
  long long x_sj, x_sm, x_sk;
  long long w_sj, w_sk, w_sn;
  int x_mode, w_mode;
};

// One operand of one lane seen as a (MN, K) matrix: x as (M, K), w as
// (N, K). Its BMN x BK tile goes to shared memory as s[k][mn].
struct Operand {
  const float* p;
  long long s_mn, s_k;
  int MN, K, mode;
};

// A thread's share of one BMN x BK tile: SLOTS runs of 4 elements along
// the operand's fast axis, loaded into registers and later stored.
template <int BMN, int BK, int THREADS>
struct TileLoad {
  static constexpr int SLOTS = BMN * BK / 4 / THREADS;
  static constexpr int LD = BMN + PAD;  // shared-memory row length
  static_assert(SLOTS >= 1 && SLOTS * 4 * THREADS == BMN * BK, "tile");
  float4 r[SLOTS];

  // the first element of slot q: (mn, k) within the tile
  __device__ __forceinline__ static void slot(int q, bool kfast, int* mn,
                                              int* k) {
    const int v = threadIdx.x + q * THREADS;
    if (kfast) {
      *mn = v / (BK / 4);
      *k = 4 * (v % (BK / 4));
    } else {
      *k = v / (BMN / 4);
      *mn = 4 * (v % (BMN / 4));
    }
  }

  __device__ __forceinline__ void load(const Operand& a, int mn0, int k0) {
    const bool kfast = a.mode & K_FAST;
    if ((a.mode & VEC4) && mn0 + BMN <= a.MN && k0 + BK <= a.K) {
      // inside the operand: float4s with nothing to check
#pragma unroll
      for (int q = 0; q < SLOTS; ++q) {
        int mn, k;
        slot(q, kfast, &mn, &k);
        r[q] = *reinterpret_cast<const float4*>(a.p + (mn0 + mn) * a.s_mn +
                                                (k0 + k) * a.s_k);
      }
      return;
    }
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
      int mn, k;
      slot(q, kfast, &mn, &k);
      mn += mn0;
      k += k0;
      const int f = kfast ? k : mn, nf = kfast ? a.K : a.MN;  // fast axis
      const bool in = kfast ? mn < a.MN : k < a.K;            // slow axis
      const float* src = a.p + mn * a.s_mn + k * a.s_k;
      if ((a.mode & VEC4) && in && f + 3 < nf) {
        r[q] = *reinterpret_cast<const float4*>(src);
      } else {
        const long long sf = kfast ? a.s_k : a.s_mn;
        float e[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          e[u] = in && f + u < nf ? src[u * sf] : 0.f;
        r[q] = make_float4(e[0], e[1], e[2], e[3]);
      }
    }
  }

  __device__ __forceinline__ void store(float* s, int mode) const {
    const bool kfast = mode & K_FAST;
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
      int mn, k;
      slot(q, kfast, &mn, &k);
      if (kfast) {  // transposed on the way in
        s[(k + 0) * LD + mn] = r[q].x;
        s[(k + 1) * LD + mn] = r[q].y;
        s[(k + 2) * LD + mn] = r[q].z;
        s[(k + 3) * LD + mn] = r[q].w;
      } else {
        *reinterpret_cast<float4*>(s + k * LD + mn) = r[q];
      }
    }
  }
};

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename C>
__global__ void __launch_bounds__(C::THREADS) gemm_simt_kernel(Params p) {
  constexpr int BM = C::BM, BN = C::BN, BK = C::BK, TM = C::TM, TN = C::TN;
  using LoadX = TileLoad<BM, BK, C::THREADS>;
  using LoadW = TileLoad<BN, BK, C::THREADS>;
  __shared__ __align__(16) float sX[2][BK * LoadX::LD];
  __shared__ __align__(16) float sW[2][BK * LoadW::LD];

  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * BM;
  const int j = blockIdx.z;
  float* o = p.o + (long long)j * p.M * p.N;

  if (p.active != nullptr && p.active[j] == 0) {
    for (int idx = threadIdx.x; idx < BM * BN; idx += C::THREADS) {
      const int r = idx / BN, c = idx % BN;
      if (m0 + r < p.M && n0 + c < p.N)
        o[(long long)(m0 + r) * p.N + n0 + c] = 0.f;
    }
    return;
  }

  const Operand xa{p.x + j * p.x_sj, p.x_sm, p.x_sk, p.M, p.K, p.x_mode};
  const Operand wa{p.w + j * p.w_sj, p.w_sn, p.w_sk, p.N, p.K, p.w_mode};
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int ty = 4 * (warp / (C::TX / 8)) + lane / 8;
  const int tx = 8 * (warp % (C::TX / 8)) + lane % 8;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[i][c] = 0.f;

  // Two register sets per operand: the loads of K tile t + 2 are issued
  // at the start of step t, into the set that held tile t, and stored into
  // shared memory at the end of step t + 1, so each load has two steps of
  // products to arrive in.
  LoadX lx[2];
  LoadW lw[2];
  const int nk = (p.K + BK - 1) / BK;
  lx[0].load(xa, m0, 0);
  lw[0].load(wa, n0, 0);
  lx[0].store(sX[0], p.x_mode);
  lw[0].store(sW[0], p.w_mode);
  if (nk > 1) {
    lx[1].load(xa, m0, BK);
    lw[1].load(wa, n0, BK);
  }
  __syncthreads();

  // step t: products on stage t % 2 while tile t + 2 loads into set t % 2
  // and tile t + 1 goes from set (t + 1) % 2 into stage (t + 1) % 2
  auto step = [&](int t, LoadX& lxa, LoadW& lwa, const LoadX& lxb,
                  const LoadW& lwb) {
    const int s = t & 1;
    if (t + 2 < nk) {
      lxa.load(xa, m0, (t + 2) * BK);
      lwa.load(wa, n0, (t + 2) * BK);
    }
    const float* cx = sX[s];
    const float* cw = sW[s];
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 ag = lds4(cx + kk * LoadX::LD + 4 * (C::TY * g + ty));
        a[4 * g + 0] = ag.x;
        a[4 * g + 1] = ag.y;
        a[4 * g + 2] = ag.z;
        a[4 * g + 3] = ag.w;
      }
#pragma unroll
      for (int g = 0; g < TN / 4; ++g) {
        const float4 bg = lds4(cw + kk * LoadW::LD + 4 * (C::TX * g + tx));
        b[4 * g + 0] = bg.x;
        b[4 * g + 1] = bg.y;
        b[4 * g + 2] = bg.z;
        b[4 * g + 3] = bg.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[i][c] = fmaf(a[i], b[c], acc[i][c]);
    }
    if (t + 1 < nk) {  // stage s ^ 1 was last read before the previous sync
      lxb.store(sX[s ^ 1], p.x_mode);
      lwb.store(sW[s ^ 1], p.w_mode);
    }
    __syncthreads();
  };
  for (int t = 0; t < nk; t += 2) {
    step(t, lx[0], lw[0], lx[1], lw[1]);
    if (t + 1 < nk) step(t + 1, lx[1], lw[1], lx[0], lw[0]);
  }

  const bool vec_out = p.N % 4 == 0;  // o is a fresh contiguous tensor
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + 4 * (C::TY * (i / 4) + ty) + i % 4;
    if (m >= p.M) continue;
    float* row = o + (long long)m * p.N;
#pragma unroll
    for (int g = 0; g < TN / 4; ++g) {
      const int n = n0 + 4 * (C::TX * g + tx);
      if (vec_out && n + 3 < p.N) {
        *reinterpret_cast<float4*>(row + n) =
            make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                        acc[i][4 * g + 3]);
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (n + u < p.N) row[n + u] = acc[i][4 * g + u];
      }
    }
  }
}

}  // namespace simt
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

// f32 body. Strides are in elements (each operand's read mode follows from
// them, simt::operand_mode); out is contiguous (J, M, N). Returns a
// cudaError_t (0 on success); the Python wrapper raises on anything else.
extern "C" int repro_packed_gemm(
    const void* x, const void* w, void* out, const void* active,
    int J, int M, int N, int K,
    long long x_sj, long long x_sm, long long x_sk,
    long long w_sj, long long w_sk, long long w_sn, void* stream) {
  using C = simt::Chosen;
  simt::Params p;
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.o = static_cast<float*>(out);
  p.active = static_cast<const int*>(active);
  p.J = J;
  p.M = M;
  p.N = N;
  p.K = K;
  p.x_sj = x_sj; p.x_sm = x_sm; p.x_sk = x_sk;
  p.w_sj = w_sj; p.w_sk = w_sk; p.w_sn = w_sn;
  p.x_mode = simt::operand_mode(p.x, J, M, K, x_sj, x_sm, x_sk);
  p.w_mode = simt::operand_mode(p.w, J, N, K, w_sj, w_sn, w_sk);
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM, J);
  simt::gemm_simt_kernel<C><<<grid, C::THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(p);
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

