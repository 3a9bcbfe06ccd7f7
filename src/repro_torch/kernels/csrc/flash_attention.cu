// Forward flash attention for Hopper (sm_90a), GQA + causal/sliding-window
// masks + an optional per-lane predicate.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_fwd
//   (bodies _fwd_kernel and _fwd_masked_kernel).
// It computes what that kernel computes: online softmax over KV tiles with
// scale 1/sqrt(D) applied to q, masked scores filled with -1e30, f32 running
// max / denominator / accumulator, the denominator clamped at 1e-30, keys past
// Sk masked in-kernel, q-head h reading kv-head h / G (no KV repeat), whole
// KV tiles skipped above the causal diagonal or older than the window, and
// inactive lanes (active[b] == 0) written as exact zeros.
//
// What bounds it on an H100: at the serving prefill shape (1, 1024, 32, 64)
// bf16 causal, the function needs ~4.3 GFLOP and moves ~16.8 MB, so the
// card's own roofline is the byte time (~5 us at 3.35 TB/s; the FLOP time at
// 989 TFLOP/s is ~4.3 us). This first version does not reach the tensor
// cores: it runs the two products as f32 FMAs on the CUDA cores (so f32
// inputs match the plain version at 2e-5, and bf16 inputs are widened once
// on load), which makes it bound by FP32 issue and shared-memory reads, not by
// device memory. What the design does about the bytes: each CTA reads its Q
// tile once and each K/V tile once into shared memory, keeps S/P for one
// 64x64 tile in shared memory, never writes scores to device memory, and an
// inactive lane's CTA stores zeros and returns without loading a tile (the
// TPU kernel still streams its tiles). wgmma, TMA and warp specialisation
// are the next step.
//
// Layout: q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D), o (B,Sq,Hq,D), read through their
// element strides (last dim contiguous), so no transpose copies are made.
// Grid: (ceil(Sq/64), Hq, B); one CTA of 256 threads per (q tile, head,
// batch). Thread t owns rows 4*(t/16)..+3 of the tile and columns
// t%16 + 16*j, so a row's 16 owners sit in one half-warp and its max/sum
// reduce with shuffles.

#include <cuda_runtime.h>

#include "dtype.cuh"
#include "launch.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int THREADS = 256;
constexpr int LDP = BK + 1;  // padded row stride of the P tile
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* active;  // (B,) or nullptr
  int B, Sq, Sk, Hq, Hkv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float scale;
};

// Copy rows row0.. of a (rows, D) slab with row stride `stride` into a
// (64, D+1) f32 tile; rows at or past `n_rows` become zeros (the TPU kernel
// pads the same rows with zeros). The +1 pad keeps column reads of the tile
// free of bank conflicts.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long stride, int row0,
                                          int n_rows, float mul) {
  for (int idx = threadIdx.x; idx < BK * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    float x = 0.f;
    if (row0 + r < n_rows) x = to_f32(src[(long long)(row0 + r) * stride + c]) * mul;
    dst[r * (D + 1) + c] = x;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) fa_fwd_kernel(Params p) {
  constexpr int LD = D + 1;
  constexpr int DJ = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;           // BQ x LD, pre-scaled
  float* sK = sQ + BQ * LD;   // BK x LD
  float* sV = sK + BK * LD;   // BK x LD
  float* sP = sV + BK * LD;   // BQ x LDP

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  if (p.active != nullptr && p.active[b] == 0) {
    for (int idx = threadIdx.x; idx < BQ * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      if (q0 + r < p.Sq) o[(long long)(q0 + r) * p.o_ss + c] = from_f32<T>(0.f);
    }
    return;
  }

  const int hk = h / (p.Hq / p.Hkv);
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  load_tile<T, D>(sQ, q, p.q_ss, q0, p.Sq, p.scale);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const int nk = (p.Sk + BK - 1) / BK;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    // block-level skips: every later tile lies above the diagonal too
    if (p.causal && k0 > q0 + BQ - 1) break;
    if (p.window && k0 + BK - 1 < q0 - p.window + 1) continue;

    __syncthreads();  // the previous tile's sK/sV reads are done
    load_tile<T, D>(sK, k, p.k_ss, k0, p.Sk, 1.f);
    load_tile<T, D>(sV, v, p.v_ss, k0, p.Sk, 1.f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mc = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < p.Sk;
        if (p.causal) ok = ok && qpos >= kpos;
        if (p.window) ok = ok && qpos - kpos < p.window;
        if (!ok) s[i][j] = NEG_INF;
        mc = fmaxf(mc, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, off));
      const float mn = fmaxf(m[i], mc);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pj = expf(s[i][j] - mn);
        sP[(ty * 4 + i) * LDP + tx + 16 * j] = pj;
        ps += pj;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float corr = expf(m[i] - mn);
      l[i] = l[i] * corr + ps;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
      m[i] = mn;
    }
    // a row of P is written and read by the same half-warp
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= p.Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      o[(long long)row * p.o_ss + tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int LD = D + 1;
  const int smem = (BQ * LD + 2 * BK * LD + BQ * LDP) * (int)sizeof(float);
  cudaError_t err = repro::allow_dynamic_smem<fa_fwd_kernel<T, D>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  fa_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements. Returns a
// cudaError_t (0 on success); the Python wrapper raises on anything else.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* active,
    int B, int Sq, int Sk, int Hq, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float scale, int dtype, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.active = static_cast<const int*>(active);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch<float, 64>(p, s);
  if (dtype == 0 && D == 128) return launch<float, 128>(p, s);
  if (dtype == 1 && D == 64) return launch<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && D == 128) return launch<__nv_bfloat16, 128>(p, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
