// Mamba2 SSD chunked scan for Hopper (sm_90a): y and the final state, with
// an optional per-lane predicate.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/ssd_scan.py::ssd_scan (body _ssd_kernel).
// It computes what that kernel computes, chunk by chunk of Q positions, all
// in f32: la = cumsum(dt * A); xb = x * dt; the intra-chunk dual form
// y_i = sum_{j<=i} (C_i . B_j) exp(la_i - la_j) xb_j; the inter-chunk term
// y_i += exp(la_i) C_i . state_in; the state update
// state = state exp(la_Q) + sum_j exp(la_Q - la_j) xb_j (x) B_j; the final
// state written once. The state starts from ``init`` (b,nh,hd,N) f32 when it
// is given, from zero otherwise (the TPU kernel always starts from zero; the
// port's model passes a start state to continue a sequence). An inactive
// lane (active[b] == 0) is written as exact zeros in y and in the state, the
// output of the reference's where-zero; it reads nothing, ``init`` included.
//
// Grid and loop: on the TPU the grid is (b, S/Q) with the chunk axis
// sequential and the state in VMEM scratch. Hopper's blocks run in no
// order, so the chunk loop runs inside one CTA. Heads are independent (B
// and C are shared across heads, the decay and the state are per head), so
// there is one CTA of 256 threads per (head, batch), and the (hd, N) state
// stays in shared memory across all chunks of the sequence.
//
// What bounds it on an H100: at the serving prefill shape (1, 1024, 24, 64),
// N = 128, Q = 128, bf16 x/B/C, the function needs about 1.0 GFLOP of f32
// work (the causal half of C.B^T and of the intra product, the inter and
// state products in full) against about 7.5 MB in and out, so it is bound
// by operations (~15 us at 67 TFLOP/s; the bytes take ~2 us). This first
// version is right and slow by design: the four products run as f32 FMAs on
// the CUDA cores from register tiles fed by 16-byte shared-memory loads, in
// a fixed order, so masked == dense bit for bit and f32 inputs match the
// plain version to rounding. Its grid is nh x b CTAs (24 on 132 SMs at the
// prefill shape), and each head's CTA recomputes C.B^T, which is the same
// for every head. A later PR fixes both: tensor-core (mma.sync / wgmma)
// tiles for the four products, C.B^T computed once per chunk, and a split
// of hd (or of the chunks, with a second pass for the carried state) across
// CTAs to fill the card.
//
// Shared memory (``Layout``; 219,648 bytes at Q = 128, hd = 64, N = 128,
// whatever the input dtype): C and B of the chunk transposed to (N, Q4 + 4)
// so that a thread's 4 rows of C or B at one n are one 16-byte load; x * dt
// as (Q4, hd); one block of 32 rows of C.B^T, decayed and masked, stored
// transposed (Q4, 36); the state transposed (N, hd); the log decays. Q4 is Q
// rounded up to 4. B is read a second time, row-major into C's buffer, for
// the state update. Layouts: x (b,S,nh,hd), B/C (b,S,N), dt (b,S,nh) are
// read through their element strides (last dim of x/B/C contiguous), so the
// model's views of one conv output are read in place; y (b,S,nh,hd) through
// its strides; the start and final states are (b,nh,hd,N) contiguous f32.

#include <cuda_runtime.h>

#include "dtype.cuh"
#include "launch.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int THREADS = 256;
constexpr int IB = 32;       // rows of y (and of C.B^T) per block
constexpr int LDG = IB + 4;  // row stride of the C.B^T block

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
  int b, S, nh, hd, N, Q;
  long long x_sb, x_ss, x_sh;
  long long dt_sb, dt_ss, dt_sh;
  long long A_s;
  long long B_sb, B_ss;
  long long C_sb, C_ss;
  long long y_sb, y_ss, y_sh;
};

// Offsets in floats into the dynamic shared memory; every buffer starts on a
// 16-byte boundary. ssd_scan.py::smem_bytes repeats this sum.
struct Layout {
  int q4, ldt;
  int ct, bt, xb, g, st, la, floats;
};

__host__ __device__ inline Layout make_layout(int Q, int hd, int N) {
  Layout L;
  L.q4 = (Q + 3) & ~3;
  L.ldt = L.q4 + 4;
  L.ct = 0;
  L.bt = L.ct + N * L.ldt;
  L.xb = L.bt + N * L.ldt;
  L.g = L.xb + L.q4 * hd;
  L.st = L.g + L.q4 * LDG;
  L.la = L.st + N * hd;
  L.floats = L.la + L.q4;
  return L;
}

__device__ __forceinline__ void fma4x4(float (&acc)[4][4], float4 a,
                                       float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

__device__ __forceinline__ void fma2x4(float (&acc)[2][4], float2 a,
                                       float4 b) {
  const float av[2] = {a.x, a.y};
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ssd_scan_kernel(Params p) {
  extern __shared__ __align__(16) float smem[];
  const int h = blockIdx.x;
  const int bi = blockIdx.y;
  const int tid = threadIdx.x;
  const int Q = p.Q, hd = p.hd, N = p.N;
  const int hd4 = hd / 4, N4 = N / 4;
  const Layout L = make_layout(Q, hd, N);

  T* y = static_cast<T*>(p.y) + bi * p.y_sb + h * p.y_sh;
  float* state_out = p.state + ((long long)bi * p.nh + h) * hd * N;
  if (p.active != nullptr && p.active[bi] == 0) {
    const long long n_y = (long long)p.S * hd;
    for (long long idx = tid; idx < n_y; idx += THREADS)
      y[(idx / hd) * p.y_ss + idx % hd] = from_f32<T>(0.f);
    for (int idx = tid; idx < hd * N; idx += THREADS) state_out[idx] = 0.f;
    return;
  }

  float* Ct = smem + L.ct;  // Ct[n*ldt + j] = C_j[n]; then Bn[j*N + n] = B_j[n]
  float* Bt = smem + L.bt;  // Bt[n*ldt + j] = B_j[n]
  float* xb = smem + L.xb;  // xb[j*hd + q] = x_j[q] dt_j
  float* G = smem + L.g;    // G[j*LDG + i - i0b] = (C_i . B_j) exp(la_i - la_j)
  float* St = smem + L.st;  // St[n*hd + q] = state[q][n]
  float* la = smem + L.la;  // inclusive cumsum of dt A over the chunk

  const T* x = static_cast<const T*>(p.x) + bi * p.x_sb + h * p.x_sh;
  const float* dt = p.dt + bi * p.dt_sb + h * p.dt_sh;
  const T* Bg = static_cast<const T*>(p.B) + bi * p.B_sb;
  const T* Cg = static_cast<const T*>(p.C) + bi * p.C_sb;
  const float A = p.A[h * p.A_s];

  const float* init =
      p.init == nullptr ? nullptr : p.init + ((long long)bi * p.nh + h) * hd * N;
  for (int idx = tid; idx < N * hd; idx += THREADS) {
    const int n = idx / hd, q = idx % hd;
    St[idx] = init == nullptr ? 0.f : init[q * N + n];
  }

  const int nc = p.S / Q;
  for (int c = 0; c < nc; ++c) {
    const long long s0 = (long long)c * Q;
    __syncthreads();  // the previous chunk is done with every buffer

    // ---- load: C and B transposed, x dt, dt A ----
    for (int idx = tid; idx < Q * N; idx += THREADS) {
      const int j = idx / N, n = idx % N;
      Ct[n * L.ldt + j] = to_f32(Cg[(s0 + j) * p.C_ss + n]);
      Bt[n * L.ldt + j] = to_f32(Bg[(s0 + j) * p.B_ss + n]);
    }
    for (int idx = tid; idx < Q * hd; idx += THREADS) {
      const int j = idx / hd, q = idx % hd;
      xb[idx] = to_f32(x[(s0 + j) * p.x_ss + q]) * dt[(s0 + j) * p.dt_ss];
    }
    for (int j = tid; j < Q; j += THREADS) la[j] = dt[(s0 + j) * p.dt_ss] * A;
    __syncthreads();

    // inclusive cumsum of la by warp 0: each lane sums a run of consecutive
    // steps in order, then the runs' totals are scanned across the warp.
    // Padded steps Q..Q4-1 repeat la[Q-1], so their decays stay finite.
    if (tid < 32) {
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
      for (int j = Q + tid; j < L.q4; j += 32) la[j] = la[Q - 1];
    }
    __syncthreads();

    // ---- y, one block of IB rows at a time ----
    for (int i0b = 0; i0b < Q; i0b += IB) {
      const int rows = min(IB, L.q4 - i0b);     // a multiple of 4
      const int njt = min(i0b + IB, L.q4) / 4;  // column tiles with j <= i
      // (1) G[j][i] = (C_i . B_j) exp(la_i - la_j) for j <= i < Q, else 0;
      // tiles wholly above the diagonal are never read and not computed.
      // The exp is taken only where j <= i, so it never overflows.
      for (int t = tid; t < (rows / 4) * njt; t += THREADS) {
        const int j0 = 4 * (t % njt), i0 = i0b + 4 * (t / njt);
        if (j0 > i0 + 3) continue;
        float acc[4][4] = {};
        for (int n = 0; n < N; ++n) {
          const float4 cv = *reinterpret_cast<const float4*>(Ct + n * L.ldt + i0);
          const float4 bv = *reinterpret_cast<const float4*>(Bt + n * L.ldt + j0);
          fma4x4(acc, cv, bv);
        }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = j0 + jj;
          float g[4];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const int i = i0 + a;
            g[a] = (j <= i && i < Q) ? acc[a][jj] * expf(la[i] - la[j]) : 0.f;
          }
          *reinterpret_cast<float4*>(G + j * LDG + (i0 - i0b)) =
              make_float4(g[0], g[1], g[2], g[3]);
        }
      }
      __syncthreads();

      // (2) y_i = exp(la_i) (C_i . state_in) + sum_{j<=i} G[j][i] xb_j, two
      // rows by four columns per thread
      for (int t = tid; t < (rows / 2) * hd4; t += THREADS) {
        const int q0 = 4 * (t % hd4), i0 = i0b + 2 * (t / hd4);
        if (i0 >= Q) continue;
        float acc[2][4] = {};
        for (int n = 0; n < N; ++n) {
          const float2 cv = *reinterpret_cast<const float2*>(Ct + n * L.ldt + i0);
          const float4 sv = *reinterpret_cast<const float4*>(St + n * hd + q0);
          fma2x4(acc, cv, sv);
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          const float e = expf(la[i0 + a]);
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[a][k] *= e;
        }
        const int jmax = min(i0 + 1, Q - 1);
        for (int j = 0; j <= jmax; ++j) {
          const float2 gv = *reinterpret_cast<const float2*>(G + j * LDG + (i0 - i0b));
          const float4 xv = *reinterpret_cast<const float4*>(xb + j * hd + q0);
          fma2x4(acc, gv, xv);
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
          if (i0 + a >= Q) break;
          T* row = y + (s0 + i0 + a) * p.y_ss + q0;
#pragma unroll
          for (int k = 0; k < 4; ++k) row[k] = from_f32<T>(acc[a][k]);
        }
      }
      __syncthreads();  // G is rewritten by the next block
    }

    // ---- state = state exp(la_last) + sum_j B_j (x) exp(la_last - la_j) xb_j
    const float la_last = la[Q - 1];
    for (int idx = tid; idx < Q * hd; idx += THREADS)
      xb[idx] *= expf(la_last - la[idx / hd]);
    float* Bn = Ct;  // C is done with for this chunk: B again, row-major
    for (int idx = tid; idx < Q * N; idx += THREADS) {
      const int j = idx / N, n = idx % N;
      Bn[idx] = to_f32(Bg[(s0 + j) * p.B_ss + n]);
    }
    __syncthreads();
    const float decay = expf(la_last);
    for (int t = tid; t < N4 * hd4; t += THREADS) {
      const int q0 = 4 * (t % hd4), n0 = 4 * (t / hd4);
      float acc[4][4] = {};
      for (int j = 0; j < Q; ++j) {
        const float4 bv = *reinterpret_cast<const float4*>(Bn + j * N + n0);
        const float4 xv = *reinterpret_cast<const float4*>(xb + j * hd + q0);
        fma4x4(acc, bv, xv);
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float4* s = reinterpret_cast<float4*>(St + (n0 + a) * hd + q0);
        float4 v = *s;
        v.x = fmaf(v.x, decay, acc[a][0]);
        v.y = fmaf(v.y, decay, acc[a][1]);
        v.z = fmaf(v.z, decay, acc[a][2]);
        v.w = fmaf(v.w, decay, acc[a][3]);
        *s = v;
      }
    }
  }

  __syncthreads();
  for (int idx = tid; idx < hd * N; idx += THREADS) {
    const int q = idx / N, n = idx % N;
    state_out[idx] = St[n * hd + q];
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const Layout L = make_layout(p.Q, p.hd, p.N);
  const int smem = L.floats * (int)sizeof(float);
  cudaError_t err = repro::allow_dynamic_smem<ssd_scan_kernel<T>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(p.nh, p.b);
  ssd_scan_kernel<T><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype (of x, B, C and y): 0 = float32, 1 = bfloat16; dt and A are f32.
// Strides are in elements. Returns a cudaError_t (0 on success); the Python
// wrapper raises on anything else.
extern "C" int repro_ssd_scan(
    const void* x, const void* dt, const void* A, const void* B,
    const void* C, void* y, void* state, const void* init,
    const void* active,
    int b, int S, int nh, int hd, int N, int Q,
    long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long A_s,
    long long B_sb, long long B_ss, long long C_sb, long long C_ss,
    long long y_sb, long long y_ss, long long y_sh,
    int dtype, void* stream) {
  if (b <= 0 || S <= 0 || nh <= 0 || Q <= 0 || S % Q != 0 || hd <= 0 ||
      N <= 0 || hd % 4 != 0 || N % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.b = b;
  p.S = S;
  p.nh = nh;
  p.hd = hd;
  p.N = N;
  p.Q = Q;
  p.x_sb = x_sb; p.x_ss = x_ss; p.x_sh = x_sh;
  p.dt_sb = dt_sb; p.dt_ss = dt_ss; p.dt_sh = dt_sh;
  p.A_s = A_s;
  p.B_sb = B_sb; p.B_ss = B_ss;
  p.C_sb = C_sb; p.C_ss = C_ss;
  p.y_sb = y_sb; p.y_ss = y_ss; p.y_sh = y_sh;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(p, s);
  if (dtype == 1) return launch<__nv_bfloat16>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
