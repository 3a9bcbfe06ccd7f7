// Mamba2 SSD chunked scan for Hopper (sm_90a): y and the final state, with
// an optional per-lane predicate.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan.py::ssd_scan (body _ssd_kernel).
// It computes what that kernel computes, chunk by chunk of Q positions, in
// f32: la = cumsum(dt * A); the intra-chunk dual form
// y_i = sum_{j<=i} (C_i . B_j) exp(la_i - la_j) dt_j x_j; the inter-chunk
// term y_i += exp(la_i) C_i . state_in; the state carried across chunks,
// state = state exp(la_Q) + sum_j exp(la_Q - la_j) dt_j x_j (x) B_j; the
// final state. The state starts from ``init`` (b,nh,hd,N) f32 when it is
// given, from zero otherwise (the TPU kernel always starts from zero; the
// port's model passes a start state to continue a sequence). An inactive
// lane (active[b] == 0) reads nothing and is written as exact zeros in y
// and in the state, the output of the reference's where-zero.
//
// Grid: on the TPU the grid is (b, S/Q) with the chunk axis sequential and
// the state in VMEM scratch. Here the chunks run in parallel, in the block
// decomposition of Mamba2's paper (arXiv:2405.21060, section 6), as three
// kernels on one stream, launched by one call of the C entry:
//   1. ssd_chunk_kernel, one CTA per (chunk, head, batch): the log decays
//      la of its head (written to a (b, nc, nh, Qp) scratch), the chunk's
//      own state contribution sum_j B_j (x) exp(la_Q - la_j) dt_j x_j,
//      (N, hd) f32 into a (b, nc, nh, N, hd) scratch, and, on the CTAs of
//      heads h < Q/16, the row stripes h, h + nh, ... of the causal half of
//      C . B^T, which is the same for every head (ngroups = 1), computed
//      once per chunk into a (b, nc, Qp, Qp) f32 scratch;
//   2. ssd_state_kernel, one thread per 4 state entries of a (head, batch):
//      the carry over the chunks, in order, element-wise; it replaces each
//      chunk's contribution by the state that enters the chunk and writes
//      the final state;
//   3. ssd_out_kernel, one CTA per (chunk, head, batch): y of the chunk,
//      exp(la_i) C_i . state_in + sum_{j<=i} CB_ij exp(la_i - la_j) dt_j x_j.
// At the serving prefill (1, 1024, 24, 64), N = 128, Q = 128, kernels 1
// and 3 each run 192 CTAs on 132 SMs, two per SM.
//
// Products on the tensor cores: mma.sync m16n8k16 bf16 -> f32, operands
// from shared memory by ldmatrix (both layouts through its transpose). No
// f32 operand is rounded to bf16: an f32 value is split exactly into three
// bf16 pieces hi + mid + lo, and a product of an f32 and a bf16 operand is
// three mma's whose partial products are exact. With bf16 x, B and C every
// product has one bf16 side (C . B^T: one mma; (CB * decay * dt) . x and
// C . state and B^T . (decay * dt * x): three). f32 inputs run the same
// body with x, B and C split too; of the nine piece products the three
// whose terms are below 2^-24 of the result are left out (pa + pb < 3).
//
// Copies: the chunk tiles of x, B and C (bf16) arrive by cp.async, 16 bytes
// at a time, straight from the caller's strided rows into padded shared
// memory (row stride + 16 bytes, so ldmatrix's rows fall in distinct
// banks); f32 tiles by 16-byte vector loads that are split into pieces on
// the way in. A layout whose base, row bytes or strides are not multiples
// of 16 bytes (``vec`` = 0, decided by the C entry from its arguments) is
// read element by element, and the entry reports it to the wrapper.
//
// What bounds it on an H100: at the serving prefill the function needs
// about 1.0 GFLOP of f32 work against about 7.5 MB in and out (15 us at the
// f32 rate of the CUDA cores; 2 us of bytes). On the tensor cores the
// products cost at most three bf16 mma's each; the scratch (6.8 MB) stays
// in the 50 MB L2 between the kernels.
//
// Order and bits: every output is one fixed sequence of mma's and FMAs, with
// no atomics and no split of a sum across CTAs, so masked == dense bit for
// bit and a strided view gives the bits of a contiguous copy.
//
// Layouts: x (b,S,nh,hd), B/C (b,S,N), dt (b,S,nh), y (b,S,nh,hd) through
// their element strides (last dim of x/B/C/y contiguous), so the model's
// views of one conv output are read in place; the start and final states
// (b,nh,hd,N) contiguous f32. The layout (shared memory per CTA, grids,
// scratch) is ssd_plan.cuh's: 109,568 bytes of shared memory in each kernel
// at the serving shape in bf16, 216,064 in f32. The wrapper allocates one
// f32 scratch of the size ``repro_ssd_scan_plan`` gives, and the entry
// carves la, cb and cs from it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "dtype.cuh"
#include "launch.cuh"
#include "ssd_plan.cuh"

namespace {

using namespace ssd;
using bf16 = __nv_bfloat16;
using repro::from_f32;
using repro::to_f32;

constexpr int THREADS = 256;  // 8 warps: kernels 1 and 3
constexpr int WARPS = THREADS / 32;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* B;
  const void* C;
  void* y;
  float* state;
  const float* init;  // (b,nh,hd,N) or nullptr (a zero start state)
  const int* active;  // (b,) or nullptr
  float* la;          // scratch (b, nc, nh, Qp)
  float* cb;          // scratch (b, nc, Qp, Qp)
  float* cs;          // scratch (b, nc, nh, N, hd)
  int b, S, nh, hd, N, Q, nc, Qp, hdp, Np, vec;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long A_s;
  long long B_sb, B_ss;
  long long C_sb, C_ss;
  long long y_sb, y_ss, y_sh;
};

// ---------------------------------------------------------------------------
// device helpers: pieces, copies, ldmatrix, mma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// v = hi + mid + lo exactly (each difference is exact in f32)
__device__ __forceinline__ void split3(float v, bf16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(v);
  const float r = v - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r);
  p[2] = __float2bfloat16_rn(r - __bfloat162float(p[1]));
}

// v into P piece arrays `piece` elements apart (P = 1: v is bf16-exact)
template <int P>
__device__ __forceinline__ void store_pieces(bf16* dst, int piece, float v) {
  if constexpr (P == 1) {
    dst[0] = __float2bfloat16_rn(v);
  } else {
    bf16 s[3];
    split3(v, s);
    dst[0] = s[0];
    dst[piece] = s[1];
    dst[2 * piece] = s[2];
  }
}

// the f32 value of an element held as P pieces
template <int P>
__device__ __forceinline__ float load_pieces(const bf16* src, int piece) {
  float v = __bfloat162float(src[0]);
  if constexpr (P == 3)
    v = (v + __bfloat162float(src[piece])) + __bfloat162float(src[2 * piece]);
  return v;
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n"
               ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col).
// Fragments, lane l, g = l / 4, t = l % 4: a = {(g, 2t..2t+1), (g+8, 2t..),
// (g, 2t+8..), (g+8, 2t+8..)}; b = {(k 2t..2t+1, n g), (k 2t+8.., n g)};
// d = {(g, 2t), (g, 2t+1), (g+8, 2t), (g+8, 2t+1)}.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows m0.., k step ks, of a tile stored [m][k] (AT =
// false) or [k][m] (AT = true), row stride ld.
template <bool AT>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t,
                                       int ld, int m0, int ks, int lane) {
  if constexpr (!AT) {
    ldsm_x4(a, t + (m0 + (lane & 15)) * ld + 16 * ks + (lane >> 4) * 8);
  } else {
    const int mat = lane >> 3;
    ldsm_x4_t(a, t + (16 * ks + (lane & 7) + (mat >> 1) * 8) * ld + m0 +
                     (mat & 1) * 8);
  }
}

// The B fragments of the two n8 tiles n0.. and n0+8.., k step ks, of a tile
// stored [k][n] (BKN = true) or [n][k] (BKN = false): {b0, b1} of the first
// tile in r[0..1], of the second in r[2..3].
template <bool BKN>
__device__ __forceinline__ void load_b(uint32_t (&r)[4], const bf16* t,
                                       int ld, int n0, int ks, int lane) {
  if constexpr (BKN) {
    ldsm_x4_t(r, t + (16 * ks + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                     n0 + (lane >> 4) * 8);
  } else {
    ldsm_x4(r, t + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + 16 * ks +
                   ((lane >> 3) & 1) * 8);
  }
}

// acc[2 nb + e] += A (rows m0..m0+15) * B (columns n0 + 16 nb + 8 e ..) over
// k steps 0..ksteps-1, for nb < nblk <= 4; A and B held as PA and PB pieces
// `apiece` / `bpiece` elements apart. Pieces pa, pb with pa + pb < 3.
template <int PA, int PB, bool AT, bool BKN>
__device__ __forceinline__ void warp_mma(float (&acc)[8][4], const bf16* A,
                                         int lda, int apiece, int m0,
                                         const bf16* B, int ldb, int bpiece,
                                         int n0, int nblk, int ksteps,
                                         int lane) {
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t a[PA][4];
#pragma unroll
    for (int pa = 0; pa < PA; ++pa)
      load_a<AT>(a[pa], A + pa * apiece, lda, m0, ks, lane);
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      if (nb >= nblk) break;
      uint32_t b[PB][4];
#pragma unroll
      for (int pb = 0; pb < PB; ++pb)
        load_b<BKN>(b[pb], B + pb * bpiece, ldb, n0 + 16 * nb, ks, lane);
#pragma unroll
      for (int pa = 0; pa < PA; ++pa)
#pragma unroll
        for (int pb = 0; pb < PB; ++pb) {
          if (pa + pb >= 3) continue;
          mma(acc[2 * nb], a[pa], b[pb][0], b[pb][1]);
          mma(acc[2 * nb + 1], a[pa], b[pb][2], b[pb][3]);
        }
    }
  }
}

// A (rows x cols) tile of T at `src` (row stride in elements, last dim
// contiguous) into P piece arrays of (rows_p, cols_p + PAD) bf16, zeros in
// rows >= rows and columns >= cols. bf16 rows go by cp.async when `vec`
// (the caller waits); f32 by 16-byte loads split into pieces; otherwise one
// element at a time.
template <typename T, int P>
__device__ __forceinline__ void load_tile(bf16* dst, int rows_p, int cols_p,
                                          const T* src, long long stride,
                                          int rows, int cols, int vec) {
  const int ld = cols_p + PAD, piece = rows_p * ld;
  if (vec) {
    if constexpr (P == 1) {
      const int chunks = cols / 8;
      for (int idx = threadIdx.x; idx < rows * chunks; idx += THREADS) {
        const int r = idx / chunks, k = 8 * (idx % chunks);
        cp_async16(dst + r * ld + k, src + r * stride + k);
      }
      if (rows < rows_p || cols < cols_p) {
        const bf16 zero = __float2bfloat16_rn(0.f);
        for (int idx = threadIdx.x; idx < rows_p * cols_p; idx += THREADS) {
          const int r = idx / cols_p, k = idx % cols_p;
          if (r >= rows || k >= cols) dst[r * ld + k] = zero;
        }
      }
      return;
    } else {
      const int c4 = cols_p / 4;
      for (int idx = threadIdx.x; idx < rows_p * c4; idx += THREADS) {
        const int r = idx / c4, k = 4 * (idx % c4);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (r < rows && k < cols)
          v = *reinterpret_cast<const float4*>(src + r * stride + k);
        bf16* d = dst + r * ld + k;
        store_pieces<P>(d, piece, v.x);
        store_pieces<P>(d + 1, piece, v.y);
        store_pieces<P>(d + 2, piece, v.z);
        store_pieces<P>(d + 3, piece, v.w);
      }
      return;
    }
  }
  for (int idx = threadIdx.x; idx < rows_p * cols_p; idx += THREADS) {
    const int r = idx / cols_p, k = idx % cols_p;
    const float v = (r < rows && k < cols) ? to_f32(src[r * stride + k]) : 0.f;
    store_pieces<P>(dst + r * ld + k, piece, v);
  }
}

// Inclusive cumsum of la[0..Q-1] in place by warp 0: each lane sums a run of
// consecutive steps in order, then the runs' totals are scanned across the
// warp. Steps Q..Qp-1 repeat la[Q-1], so their decays stay finite.
__device__ __forceinline__ void chunk_cumsum(float* la, int Q, int Qp) {
  const int tid = threadIdx.x;
  if (tid >= 32) return;
  const int per = (Q + 31) / 32;
  const int lo = min(tid * per, Q), hi = min(lo + per, Q);
  float run = 0.f;
  for (int j = lo; j < hi; ++j) {
    run += la[j];
    la[j] = run;
  }
  float incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, off);
    if (tid >= off) incl += v;
  }
  float base = __shfl_up_sync(0xffffffffu, incl, 1);
  if (tid == 0) base = 0.f;
  for (int j = lo; j < hi; ++j) la[j] += base;
  __syncwarp();
  for (int j = Q + tid; j < Qp; j += 32) la[j] = la[Q - 1];
}

// ---------------------------------------------------------------------------
// kernel 1: la, the chunk's state contribution, and stripes of C . B^T
// ---------------------------------------------------------------------------

template <typename T, int P>
__global__ void __launch_bounds__(THREADS, 2) ssd_chunk_kernel(Params p) {
  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  if (p.active != nullptr && p.active[bi] == 0) return;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Q = p.Q, Qp = p.Qp, hdp = p.hdp, Np = p.Np;
  const ChunkLayout L = chunk_layout(Qp, hdp, Np, P);
  bf16* sB = reinterpret_cast<bf16*>(smem + L.b);  // [j][n], P pieces
  bf16* sX = reinterpret_cast<bf16*>(smem + L.x);  // [j][q], P pieces
  bf16* sW = reinterpret_cast<bf16*>(smem + L.w);  // [j][q], 3 pieces
  bf16* sC = reinterpret_cast<bf16*>(smem + L.c);  // [i][n], P pieces
  float* sla = reinterpret_cast<float*>(smem + L.la);
  float* sw = reinterpret_cast<float*>(smem + L.dt);  // dt, then decay * dt
  const int ldn = Np + PAD, ldq = hdp + PAD;
  const int pn = Qp * ldn, pq = Qp * ldq;

  const long long s0 = (long long)c * Q;
  const T* Bg = static_cast<const T*>(p.B) + bi * p.B_sb + s0 * p.B_ss;
  const T* Cg = static_cast<const T*>(p.C) + bi * p.C_sb + s0 * p.C_ss;
  const T* xg = static_cast<const T*>(p.x) + bi * p.x_sb + h * p.x_sh +
                s0 * p.x_ss;
  const float* dtg = p.dt + bi * p.dt_sb + h * p.dt_sh + s0 * p.dt_ss;

  load_tile<T, P>(sB, Qp, Np, Bg, p.B_ss, Q, p.N, p.vec);
  load_tile<T, P>(sX, Qp, hdp, xg, p.x_ss, Q, p.hd, p.vec);
  const float A = p.A[h * p.A_s];
  for (int j = tid; j < Qp; j += THREADS) {
    const float d = j < Q ? dtg[j * p.dt_ss] : 0.f;
    sw[j] = d;
    sla[j] = d * A;
  }
  __syncthreads();
  chunk_cumsum(sla, Q, Qp);
  __syncthreads();
  float* la_out = p.la + (((long long)bi * p.nc + c) * p.nh + h) * Qp;
  const float la_last = sla[Q - 1];
  for (int j = tid; j < Qp; j += THREADS) {
    la_out[j] = sla[j];
    sw[j] = j < Q ? expf(la_last - sla[j]) * sw[j] : 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  // W[j][q] = exp(la_Q - la_j) dt_j x_j[q], in three pieces
  for (int idx = tid; idx < Qp * hdp; idx += THREADS) {
    const int j = idx / hdp, q = idx % hdp;
    store_pieces<3>(sW + j * ldq + q, pq,
                    load_pieces<P>(sX + j * ldq + q, pq) * sw[j]);
  }
  __syncthreads();

  // contribution^T[n][q] = sum_j B[j][n] W[j][q]: M = N, K = Q, N = hd
  float* cs = p.cs + (((long long)bi * p.nc + c) * p.nh + h) *
                         (long long)p.N * p.hd;
  const int g = lane / 4, t = lane % 4;
  const int mtiles = Np / 16, groups = (hdp + 63) / 64;
  for (int u = warp; u < mtiles * groups; u += WARPS) {
    const int mt = u % mtiles, grp = u / mtiles;
    const int nblk = min(4, hdp / 16 - 4 * grp);
    float acc[8][4] = {};
    warp_mma<P, 3, true, true>(acc, sB, ldn, pn, 16 * mt, sW, ldq, pq,
                               64 * grp, nblk, Qp / 16, lane);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int q = 64 * grp + 8 * e + 2 * t;
      if (e >= 2 * nblk || q >= p.hd) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int n = 16 * mt + g + 8 * r;
        if (n < p.N)
          *reinterpret_cast<float2*>(cs + (long long)n * p.hd + q) =
              make_float2(acc[e][2 * r], acc[e][2 * r + 1]);
      }
    }
  }

  // stripes h, h + nh, ... of CB = C . B^T, 16-column blocks j <= i only
  const int rtiles = Qp / 16;
  if (h >= rtiles) return;
  __syncthreads();  // x and W are done with: C takes their room
  load_tile<T, P>(sC, Qp, Np, Cg, p.C_ss, Q, p.N, p.vec);
  cp_async_wait_all();
  __syncthreads();
  float* cb = p.cb + ((long long)bi * p.nc + c) * Qp * Qp;
  int u = 0;
  for (int r = h; r < rtiles; r += p.nh) {
    for (int g4 = 0; 4 * g4 <= r; ++g4, ++u) {
      if (u % WARPS != warp) continue;
      const int nblk = min(4, r + 1 - 4 * g4);
      float acc[8][4] = {};
      warp_mma<P, P, false, false>(acc, sC, ldn, pn, 16 * r, sB, ldn, pn,
                                   64 * g4, nblk, Np / 16, lane);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        if (e >= 2 * nblk) continue;
        const int j = 64 * g4 + 8 * e + 2 * t;
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const int i = 16 * r + g + 8 * rr;
          *reinterpret_cast<float2*>(cb + (long long)i * Qp + j) =
              make_float2(acc[e][2 * rr], acc[e][2 * rr + 1]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// kernel 2: the state carried across the chunks
// ---------------------------------------------------------------------------

// Thread (q, n0..n0+3) of a (head, batch): state_in[0] = init (or 0);
// state_in[c+1] = state_in[c] exp(la_Q[c]) + contribution[c], each chunk's
// contribution replaced by its state_in in the scratch; the final state
// written (b,nh,hd,N).
__global__ void __launch_bounds__(STATE_THREADS) ssd_state_kernel(Params p) {
  const int h = blockIdx.y, bi = blockIdx.z;
  const int idx = blockIdx.x * STATE_THREADS + threadIdx.x;
  if (idx >= p.hd * (p.N / 4)) return;
  const int q = idx % p.hd, n0 = 4 * (idx / p.hd);
  const long long at = (((long long)bi * p.nh + h) * p.hd + q) * p.N + n0;
  float4* out = reinterpret_cast<float4*>(p.state + at);
  if (p.active != nullptr && p.active[bi] == 0) {
    *out = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (p.init != nullptr) {
    const float4 v = *reinterpret_cast<const float4*>(p.init + at);
    s[0] = v.x; s[1] = v.y; s[2] = v.z; s[3] = v.w;
  }
  const long long step = (long long)p.nh * p.N * p.hd;  // one chunk
  float* cs = p.cs + ((long long)bi * p.nc * p.nh + h) * p.N * p.hd +
              (long long)n0 * p.hd + q;
  const float* la = p.la + ((long long)bi * p.nc * p.nh + h) * p.Qp + p.Q - 1;
  float next[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) next[k] = cs[k * p.hd];
  for (int c = 0; c < p.nc; ++c) {
    float* here = cs + c * step;
    float cur[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) cur[k] = next[k];
    if (c + 1 < p.nc) {
#pragma unroll
      for (int k = 0; k < 4; ++k) next[k] = here[step + k * p.hd];
    }
    const float e = expf(la[(long long)c * p.nh * p.Qp]);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      here[k * p.hd] = s[k];
      s[k] = fmaf(s[k], e, cur[k]);
    }
  }
  *out = make_float4(s[0], s[1], s[2], s[3]);
}

// ---------------------------------------------------------------------------
// kernel 3: y of one chunk and head
// ---------------------------------------------------------------------------

template <typename T, int P>
__global__ void __launch_bounds__(THREADS, 2) ssd_out_kernel(Params p) {
  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int Q = p.Q, Qp = p.Qp, hdp = p.hdp, Np = p.Np;
  const long long s0 = (long long)c * Q;
  T* y = static_cast<T*>(p.y) + bi * p.y_sb + h * p.y_sh + s0 * p.y_ss;
  if (p.active != nullptr && p.active[bi] == 0) {
    for (int idx = tid; idx < Q * p.hd; idx += THREADS)
      y[(idx / p.hd) * p.y_ss + idx % p.hd] = from_f32<T>(0.f);
    return;
  }
  extern __shared__ __align__(16) unsigned char smem[];
  const OutLayout L = out_layout(Qp, hdp, Np, P);
  bf16* sC = reinterpret_cast<bf16*>(smem + L.c);  // [i][n], P pieces
  bf16* sX = reinterpret_cast<bf16*>(smem + L.x);  // [j][q], P pieces
  bf16* sS = reinterpret_cast<bf16*>(smem + L.s);  // [n][q], 3 pieces
  float* sla = reinterpret_cast<float*>(smem + L.la);
  float* sdt = reinterpret_cast<float*>(smem + L.dt);
  const int ldn = Np + PAD, ldq = hdp + PAD;
  const int pn = Qp * ldn, pq = Qp * ldq, ps = Np * ldq;

  const T* Cg = static_cast<const T*>(p.C) + bi * p.C_sb + s0 * p.C_ss;
  const T* xg = static_cast<const T*>(p.x) + bi * p.x_sb + h * p.x_sh +
                s0 * p.x_ss;
  const float* dtg = p.dt + bi * p.dt_sb + h * p.dt_sh + s0 * p.dt_ss;
  load_tile<T, P>(sC, Qp, Np, Cg, p.C_ss, Q, p.N, p.vec);
  load_tile<T, P>(sX, Qp, hdp, xg, p.x_ss, Q, p.hd, p.vec);
  const float* la_in = p.la + (((long long)bi * p.nc + c) * p.nh + h) * Qp;
  for (int j = tid; j < Qp; j += THREADS) {
    sla[j] = la_in[j];
    sdt[j] = j < Q ? dtg[j * p.dt_ss] : 0.f;
  }
  // the state entering the chunk (zero for the first chunk without init)
  const bool has_state = c > 0 || p.init != nullptr;
  if (has_state) {
    const float* st = p.cs + (((long long)bi * p.nc + c) * p.nh + h) *
                                 (long long)p.N * p.hd;
    const int q4 = hdp / 4;
    for (int idx = tid; idx < Np * q4; idx += THREADS) {
      const int n = idx / q4, q = 4 * (idx % q4);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < p.N && q < p.hd)
        v = *reinterpret_cast<const float4*>(st + (long long)n * p.hd + q);
      bf16* d = sS + n * ldq + q;
      store_pieces<3>(d, ps, v.x);
      store_pieces<3>(d + 1, ps, v.y);
      store_pieces<3>(d + 2, ps, v.z);
      store_pieces<3>(d + 3, ps, v.w);
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const float* cb = p.cb + ((long long)bi * p.nc + c) * Qp * Qp;
  const int g = lane / 4, t = lane % 4;
  const int rtiles = Qp / 16, groups = (hdp + 63) / 64;
  for (int u = warp; u < rtiles * groups; u += WARPS) {
    const int mt = u % rtiles, grp = u / rtiles;
    const int m0 = 16 * mt, n0 = 64 * grp;
    const int nblk = min(4, hdp / 16 - 4 * grp);
    const int i0 = m0 + g, i1 = i0 + 8;
    float acc[8][4] = {};
    // inter-chunk: exp(la_i) (C_i . state_in)
    if (has_state) {
      warp_mma<P, 3, false, true>(acc, sC, ldn, pn, m0, sS, ldq, ps, n0,
                                  nblk, Np / 16, lane);
      const float e0 = expf(sla[i0]), e1 = expf(sla[i1]);
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        acc[e][0] *= e0;
        acc[e][1] *= e0;
        acc[e][2] *= e1;
        acc[e][3] *= e1;
      }
    }
    // intra-chunk: sum_{j<=i} CB_ij exp(la_i - la_j) dt_j x_j, k steps of
    // 16 j up to the diagonal; G = CB * decay * dt in three pieces, built
    // in registers in the A fragment's layout. The exp is taken only where
    // j <= i < Q, so it never overflows.
    for (int ks = 0; ks <= mt; ++ks) {
      const int jb = 16 * ks + 2 * t;
      float gv[2][4];  // rows i0, i1; columns jb, jb+1, jb+8, jb+9
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r ? i1 : i0;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int j = jb + 8 * hf;
          const float2 v =
              *reinterpret_cast<const float2*>(cb + (long long)i * Qp + j);
          const bool in = i < Q;
          gv[r][2 * hf] = (in && j <= i)
              ? v.x * expf(sla[i] - sla[j]) * sdt[j] : 0.f;
          gv[r][2 * hf + 1] = (in && j + 1 <= i)
              ? v.y * expf(sla[i] - sla[j + 1]) * sdt[j + 1] : 0.f;
        }
      }
      uint32_t a[3][4];
      {
        bf16 pc[2][4][3];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) split3(gv[r][k], pc[r][k]);
#pragma unroll
        for (int pa = 0; pa < 3; ++pa) {
          a[pa][0] = pack(pc[0][0][pa], pc[0][1][pa]);
          a[pa][1] = pack(pc[1][0][pa], pc[1][1][pa]);
          a[pa][2] = pack(pc[0][2][pa], pc[0][3][pa]);
          a[pa][3] = pack(pc[1][2][pa], pc[1][3][pa]);
        }
      }
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        if (nb >= nblk) break;
        uint32_t b[P][4];
#pragma unroll
        for (int pb = 0; pb < P; ++pb)
          load_b<true>(b[pb], sX + pb * pq, ldq, n0 + 16 * nb, ks, lane);
#pragma unroll
        for (int pa = 0; pa < 3; ++pa)
#pragma unroll
          for (int pb = 0; pb < P; ++pb) {
            if (pa + pb >= 3) continue;
            mma(acc[2 * nb], a[pa], b[pb][0], b[pb][1]);
            mma(acc[2 * nb + 1], a[pa], b[pb][2], b[pb][3]);
          }
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int q = n0 + 8 * e + 2 * t;
      if (e >= 2 * nblk || q >= p.hd) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = r ? i1 : i0;
        if (i >= Q) continue;
        T* dst = y + i * p.y_ss + q;
        dst[0] = from_f32<T>(acc[e][2 * r]);
        dst[1] = from_f32<T>(acc[e][2 * r + 1]);
      }
    }
  }
}

template <typename T, int P>
cudaError_t launch(const Params& p, const Plan& pl, cudaStream_t stream) {
  cudaError_t err =
      repro::allow_dynamic_smem<ssd_chunk_kernel<T, P>>(pl.chunk_smem);
  if (err != cudaSuccess) return err;
  err = repro::allow_dynamic_smem<ssd_out_kernel<T, P>>(pl.out_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(pl.grid[0], pl.grid[1], pl.grid[2]);
  ssd_chunk_kernel<T, P><<<grid, THREADS, pl.chunk_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 sgrid(pl.state_grid[0], pl.state_grid[1], pl.state_grid[2]);
  ssd_state_kernel<<<sgrid, STATE_THREADS, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_out_kernel<T, P><<<grid, THREADS, pl.out_smem, stream>>>(p);
  return cudaGetLastError();
}

// The kernels' CTAs of one SM, by the runtime's occupancy, after granting
// their shared memory.
template <typename T, int P>
cudaError_t occupancy(const Plan& pl, long long* out) {
  cudaError_t err =
      repro::allow_dynamic_smem<ssd_chunk_kernel<T, P>>(pl.chunk_smem);
  if (err == cudaSuccess)
    err = repro::allow_dynamic_smem<ssd_out_kernel<T, P>>(pl.out_smem);
  int n[2] = {0, 0};
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n[0], ssd_chunk_kernel<T, P>, THREADS, pl.chunk_smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n[1], ssd_out_kernel<T, P>, THREADS, pl.out_smem);
  out[0] = n[0];
  out[1] = n[1];
  return err;
}

}  // namespace

// The plan of one call, for the wrapper. out[0]: the scratch the call needs
// in floats (one allocation; the entry carves it); out[1], out[2]: the
// dynamic shared memory of a CTA of the chunk and the output kernel, bytes;
// out[3]: the most one CTA may take on this device; out[4], out[5]: the CTAs
// of the chunk and output kernels one SM holds. Returns 0;
// cudaErrorInvalidValue for a shape the kernels do not take, with out[1..3]
// set when only the shared memory is at fault; or the runtime's error.
extern "C" int repro_ssd_scan_plan(int b, int S, int nh, int hd, int N,
                                   int Q, int dtype, long long* out) {
  for (int k = 0; k < 6; ++k) out[k] = 0;
  if (!ssd::shape_ok(b, S, nh, hd, N, Q) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const ssd::Plan pl = ssd::make_plan(b, S, nh, hd, N, Q, dtype == 0 ? 3 : 1);
  out[0] = pl.la + pl.cb + pl.cs;
  out[1] = pl.chunk_smem;
  out[2] = pl.out_smem;
  int dev = 0, most = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&most,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[3] = most;
  if (pl.chunk_smem > most || pl.out_smem > most)
    return static_cast<int>(cudaErrorInvalidValue);
  err = dtype == 0 ? occupancy<float, 3>(pl, out + 4)
                   : occupancy<__nv_bfloat16, 1>(pl, out + 4);
  return static_cast<int>(err);
}

// dtype (of x, B, C and y): 0 = float32 (the body with every operand split
// in three bf16 pieces), 1 = bfloat16; dt and A are f32. Strides are in
// elements. scratch: f32, of the size repro_ssd_scan_plan gives. *scalar
// is set to 1 when a row of x, B or C does not start on a 16-byte boundary
// (those tiles are read element by element), to 0 otherwise. Returns a
// cudaError_t (0 on success); the Python wrapper raises on anything else.
extern "C" int repro_ssd_scan(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* state, const void* init,
    const void* active, void* scratch,
    int b, int S, int nh, int hd, int N, int Q,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long A_s,
    long long B_sb, long long B_ss, long long C_sb, long long C_ss,
    long long y_sb, long long y_ss, long long y_sh,
    int dtype, int* scalar, void* stream) {
  if (!ssd::shape_ok(b, S, nh, hd, N, Q) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec = ssd::inputs_copyable(x, B, C, b, S, nh, hd, N,
                                  dtype == 0 ? 4 : 2, x_sb, x_ss, x_sh, B_sb,
                                  B_ss, C_sb, C_ss);
  *scalar = !vec;
  const ssd::Plan pl = ssd::make_plan(b, S, nh, hd, N, Q, dtype == 0 ? 3 : 1);
  Params p;
  p.x = x;
  p.dt = static_cast<const float*>(dt);
  p.A = static_cast<const float*>(A);
  p.B = B;
  p.C = C;
  p.y = y;
  p.state = static_cast<float*>(state);
  p.init = static_cast<const float*>(init);
  p.active = static_cast<const int*>(active);
  p.la = static_cast<float*>(scratch);
  p.cb = p.la + pl.la;
  p.cs = p.cb + pl.cb;
  p.b = b;
  p.S = S;
  p.nh = nh;
  p.hd = hd;
  p.N = N;
  p.Q = Q;
  p.nc = S / Q;
  p.Qp = pl.Qp;
  p.hdp = pl.hdp;
  p.Np = pl.Np;
  p.vec = vec;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh;
  p.dt_sb = dt_sb; p.dt_ss = dt_ss; p.dt_sh = dt_sh;
  p.A_s = A_s;
  p.B_sb = B_sb; p.B_ss = B_ss;
  p.C_sb = C_sb; p.C_ss = C_ss;
  p.y_sb = y_sb; p.y_ss = y_ss; p.y_sh = y_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float, 3>(p, pl, s);
  return launch<__nv_bfloat16, 1>(p, pl, s);
}
