// Forward flash attention for Hopper (sm_90a), GQA + causal/sliding-window
// masks + an optional per-lane predicate. Two hand-written bodies, chosen
// by dtype:
//   bf16 -> fa_fwd_wgmma_kernel: both products on the tensor cores (wgmma),
//           Q, K and V tiles brought into shared memory by TMA;
//   f32  -> fa_fwd_simt_kernel: both products as f32 FMAs on the CUDA
//           cores. The tensor cores take f32 only as TF32, which the port's
//           parity rules forbid, so the f32 body stays on the CUDA cores.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention.py::flash_attention_fwd
//   (bodies _fwd_kernel and _fwd_masked_kernel).
// It computes what that kernel computes: online softmax over KV tiles with
// scale 1/sqrt(D), masked scores filled with -1e30, f32 running max /
// denominator / accumulator, the denominator clamped at 1e-30, keys past Sk
// masked in-kernel, q-head h reading kv-head h / G (no KV repeat), whole KV
// tiles skipped above the causal diagonal or older than the window, and
// inactive lanes (active[b] == 0) written as exact zeros, with active lanes
// bit-identical to the unmasked launch.
//
// What bounds it on an H100: at the serving prefill shape (1, 1024, 32, 64)
// bf16 causal, the function needs ~4.3 GFLOP and moves ~16.8 MB, so the
// card's own roofline is the byte time (~5 us at 3.35 TB/s; the FLOP time at
// 989 TFLOP/s is ~4.3 us). What both designs do about the bytes: each CTA
// reads its Q tile once and each K/V tile once into shared memory, never
// writes scores to device memory, and an inactive lane's CTA stores zeros
// and returns without loading a tile (the TPU kernel still streams them).
//
// wgmma body. One CTA of 384 threads per (128-row q tile, head, batch),
// q tiles launched longest first (the causal tail's short CTAs go last);
// grid (ceil(Sq/128), Hq, B). Warpgroup 0 is the producer: one thread
// loads the Q tile once and K and V tiles of 128 keys into a ring of two
// stages with full/empty mbarriers. Tensor maps are 4-D over (D, H, S, B)
// with the tensors' own strides, so no transpose copy is made; TMA's zero
// fill supplies the rows past Sq and Sk, and kv-head h / G is a coordinate.
// Warpgroups 1 and 2 are consumers of 64 q rows each. Per KV tile:
//   S = Q K^T by m64n128k16 with both operands K-major in shared memory,
//   f32 in registers; S scaled in f32 (scale * log2 e, for exp2); the
//   causal, window and Sk masks (-1e30) on edge and diagonal tiles only;
//   the online softmax (exp2 by MUFU.EX2 alone), a row's max and sum over
//   the four threads that share it; O rescaled in f32 registers by the
//   correction factor; P converted to bf16 in registers and used as the
//   register A operand of O += P V (m64nDk16, V MN-major in shared memory
//   through the transpose bit).
// A consumer releases a stage after its P V product on it has completed.
// Each tile's softmax (16,384 exp2 per 128 x 128 tile on the CUDA cores)
// takes longer than its two products on the tensor cores, and the two
// consumer warpgroups are not scheduled to alternate; issuing the next
// tile's S before this tile's softmax gained nothing on the card.
// The finish divides by max(l, 1e-30) and stores bf16. Head dims: every
// multiple of 16 up to 128. The body is instantiated at DP = 64 and 128 (a
// row of 128 is two 64-column boxes, one per 128-byte swizzle span); a
// smaller D runs the next DP up, its tensor maps over the true D, so TMA
// fills the box's columns D..DP-1 with zeros: Q K^T over them adds exact
// zeros, P V gives zero columns there, and only the D true columns are
// stored. The scale is 1/sqrt(D) of the true D (the wrapper's). TMA needs
// 16-byte aligned bases and strides of multiples of 16 bytes; the Python
// wrapper raises on a layout that breaks that.
//
// simt body (f32). One CTA of 256 threads per (64-row q tile, head, batch),
// 64-row KV tiles and a 64x64 P tile in shared memory, f32 FMAs; thread t
// owns rows 4*(t/16)..+3 of the tile and columns t%16 + 16*j, so a row's 16
// owners sit in one half-warp and its max/sum reduce with shuffles. Its
// scale is applied to q on load. Grid: (ceil(Sq/64), Hq, B). Instantiated
// for every head dim that is a multiple of 16 up to 128 (D/16 accumulator
// columns per thread).
//
// Layout: q (B,Sq,Hq,D), k/v (B,Sk,Hkv,D), o (B,Sq,Hq,D), read through their
// element strides (last dim contiguous).

#include <cuda_runtime.h>

#include "dtype.cuh"
#include "launch.cuh"
#include "tma.cuh"

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

// ---------------------------------------------------------------------------
// simt body (f32)
// ---------------------------------------------------------------------------

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
__global__ void __launch_bounds__(THREADS) fa_fwd_simt_kernel(Params p) {
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

// Launch the f32 body, or with `smem_out` only write the dynamic shared
// memory the launch passes and launch nothing.
template <int D>
cudaError_t launch_simt(const Params& p, cudaStream_t stream, int* smem_out) {
  constexpr int LD = D + 1;
  const int smem = (BQ * LD + 2 * BK * LD + BQ * LDP) * (int)sizeof(float);
  if (smem_out != nullptr) {
    *smem_out = smem;
    return cudaSuccess;
  }
  cudaError_t err =
      repro::allow_dynamic_smem<fa_fwd_simt_kernel<float, D>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  fa_fwd_simt_kernel<float, D><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

int simt_dispatch(const Params& p, int D, cudaStream_t s, int* smem_out) {
  switch (D) {
    case 16: return launch_simt<16>(p, s, smem_out);
    case 32: return launch_simt<32>(p, s, smem_out);
    case 48: return launch_simt<48>(p, s, smem_out);
    case 64: return launch_simt<64>(p, s, smem_out);
    case 80: return launch_simt<80>(p, s, smem_out);
    case 96: return launch_simt<96>(p, s, smem_out);
    case 112: return launch_simt<112>(p, s, smem_out);
    case 128: return launch_simt<128>(p, s, smem_out);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// wgmma body (bf16)
// ---------------------------------------------------------------------------

namespace wg {

using namespace repro::tma;

constexpr int BQ = 128;
constexpr int BKV = 128;
constexpr int STAGES = 2;
constexpr int THREADS = 384;  // producer + 2 consumer warpgroups
constexpr int ROW = 128;      // bytes of one 64-column box row

template <int D>
struct Smem {
  static constexpr int Q_SUB = BQ * ROW;   // one 64-column block of Q
  static constexpr int KV_SUB = BKV * ROW;  // one 64-column block of K or V
  static constexpr int Q_BYTES = (D / 64) * Q_SUB;
  static constexpr int KV_BYTES = (D / 64) * KV_SUB;
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;  // K then V
  static constexpr int BYTES =
      1024 + Q_BYTES + STAGES * STAGE_BYTES + (1 + 2 * STAGES) * 8;
};

struct Params {
  void* o;
  const int* active;  // (B,) or nullptr
  int B, Sq, Sk, Hq, Hkv;
  int D;  // the true head dim, at most the instantiation's
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float scale_log2;  // 1/sqrt(D) * log2(e)
};

// 2^x by the MUFU.EX2 unit alone (results below 2^-126 flush to zero);
// exp2f adds range handling around it that a softmax does not need
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
    fa_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                        const __grid_constant__ CUtensorMap map_k,
                        const __grid_constant__ CUtensorMap map_v, Params p) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(p.o) + b * p.o_sb + h * p.o_sh;

  if (p.active != nullptr && p.active[b] == 0) {
    for (int idx = threadIdx.x; idx < BQ * p.D; idx += THREADS) {
      const int r = idx / p.D, c = idx % p.D;
      if (q0 + r < p.Sq)
        o[(long long)(q0 + r) * p.o_ss + c] = __float2bfloat16(0.f);
    }
    return;
  }

  // the KV tiles this q tile reads: none above the causal diagonal, none
  // wholly older than the window of its first row
  const int nk = (p.Sk + BKV - 1) / BKV;
  int hi = nk;
  if (p.causal) hi = min(nk, (q0 + BQ - 1) / BKV + 1);
  int lo = 0;
  if (p.window)
    while (lo < hi && lo * BKV + BKV - 1 < q0 - p.window + 1) ++lo;

  uint8_t* base = align_1024(smem_raw);
  uint8_t* sq = base;
  uint8_t* skv = base + L::Q_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(skv + STAGES * L::STAGE_BYTES);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;
  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrival per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int group = threadIdx.x / 128;
  if (group == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && lo < hi) {
      const int hk = h / (p.Hq / p.Hkv);
      mbar_expect_tx(qbar, L::Q_BYTES);
#pragma unroll
      for (int ch = 0; ch < D / 64; ++ch)
        tma_load_4d(sq + ch * L::Q_SUB, &map_q, qbar, 64 * ch, h, q0, b);
      for (int kt = lo; kt < hi; ++kt) {
        const int i = kt - lo, s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        uint8_t* sk = skv + s * L::STAGE_BYTES;
        uint8_t* sv = sk + L::KV_BYTES;
        mbar_expect_tx(&full[s], L::STAGE_BYTES);
#pragma unroll
        for (int ch = 0; ch < D / 64; ++ch) {
          tma_load_4d(sk + ch * L::KV_SUB, &map_k, &full[s], 64 * ch, hk,
                      kt * BKV, b);
          tma_load_4d(sv + ch * L::KV_SUB, &map_v, &full[s], 64 * ch, hk,
                      kt * BKV, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int c = group - 1;  // q rows q0 + 64 c .. q0 + 64 c + 63
    const int t = threadIdx.x % 128;
    const int row0 = q0 + 64 * c + 16 * (t / 32) + (t % 32) / 4;  // +8
    const int col0 = 2 * (t % 4);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

    float sc[BKV / 2];
    if (lo < hi) mbar_wait(qbar, 0);
    for (int kt = lo; kt < hi; ++kt) {
      const int i = kt - lo, s = i % STAGES;
      const uint8_t* sk = skv + s * L::STAGE_BYTES;
      const uint8_t* sv = sk + L::KV_BYTES;
      mbar_wait(&full[s], (i / STAGES) & 1);

      // S = Q K^T: both operands K-major in shared memory, f32 in registers
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) sc[e] = 0.f;
      fence_operands(sc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk / 4) * L::Q_SUB + (kk % 4) * 32;
        const uint64_t da = desc_sw128(sq + off + 64 * c * ROW, 16, 1024);
        const uint64_t db = desc_sw128(sk + (kk / 4) * L::KV_SUB
                                       + (kk % 4) * 32, 16, 1024);
        wgmma_m64n128k16_ss<0, 0>(sc, da, db, 1);
      }
      wgmma_commit();
      fence_operands(sc);
      wgmma_wait<0>();
      fence_operands(sc);

      // scale in f32, then the masks on edge and diagonal tiles only
      const int k0 = kt * BKV;
      const bool edge = k0 + BKV > p.Sk
                        || (p.causal && k0 + BKV - 1 > q0)
                        || (p.window && q0 + BQ - 1 - k0 >= p.window);
#pragma unroll
      for (int e = 0; e < BKV / 2; ++e) {
        float v = sc[e] * p.scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * (e / 4) + col0 + (e & 1);
          const int qpos = row0 + 8 * ((e / 2) & 1);
          bool ok = kpos < p.Sk;
          if (p.causal) ok = ok && qpos >= kpos;
          if (p.window) ok = ok && qpos - kpos < p.window;
          if (!ok) v = NEG_INF;
        }
        sc[e] = v;
      }

      // online softmax: row r's 32 values of this thread, then its 4 owners
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG_INF;
#pragma unroll
        for (int jj = 0; jj < BKV / 8; ++jj)
          mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * r], sc[4 * jj + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[r], mx);
        corr[r] = fast_exp2(m[r] - mn);
        m[r] = mn;
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < BKV / 8; ++jj) {
          const float p0 = fast_exp2(sc[4 * jj + 2 * r] - mn);
          const float p1 = fast_exp2(sc[4 * jj + 2 * r + 1] - mn);
          sc[4 * jj + 2 * r] = p0;
          sc[4 * jj + 2 * r + 1] = p1;
          sum += p0 + p1;
        }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        l[r] = l[r] * corr[r] + sum;
      }
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        acc[4 * jj + 0] *= corr[0];
        acc[4 * jj + 1] *= corr[0];
        acc[4 * jj + 2] *= corr[1];
        acc[4 * jj + 3] *= corr[1];
      }

      // O += P V: P from registers (bf16), V MN-major in shared memory;
      // every fragment is packed before the fence, so no register the
      // products read is written between them
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) wgmma_a_fragment(pa[kk], sc, kk);
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        const uint64_t db = desc_sw128(sv + kk * 16 * ROW, L::KV_SUB, 1024);
        if constexpr (D == 64)
          wgmma_m64n64k16_rs<1>(acc, pa[kk], db, 1);
        else
          wgmma_m64n128k16_rs<1>(acc, pa[kk], db, 1);
      }
      wgmma_commit();
      fence_operands(acc);
      wgmma_wait<0>();  // this tile's P V and the next tile's S are done
      fence_operands(acc);
      if (t == 0) mbar_arrive(&empty[s]);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.Sq) continue;
      const float denom = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* dst = o + (long long)row * p.o_ss + col0;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj)
        if (8 * jj < p.D)  // columns past the true D are the box's zeros
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * jj) =
            __floats2bfloat162_rn(acc[4 * jj + 2 * r] / denom,
                                  acc[4 * jj + 2 * r + 1] / denom);
    }
  }
}

// A 4-D map over (D, H, S, B) of one of q, k, v; box (64, 1, rows, 1).
inline int map_qkv(CUtensorMap* map, const void* ptr, int D, int H, int S,
                   int B, long long sh, long long ss, long long sb,
                   int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)sh * 2, (uint64_t)ss * 2,
                               (uint64_t)sb * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return encode_bf16(map, ptr, 4, dims, strides, box);
}

// Launch the bf16 body, or with `smem_out` only write the dynamic shared
// memory the launch passes and launch nothing.
template <int D>
int launch(const CUtensorMap& mq, const CUtensorMap& mk,
           const CUtensorMap& mv, const Params& p, cudaStream_t stream,
           int* smem_out) {
  constexpr int smem = Smem<D>::BYTES;
  if (smem_out != nullptr) {
    *smem_out = smem;
    return cudaSuccess;
  }
  cudaError_t err = repro::allow_dynamic_smem<fa_fwd_wgmma_kernel<D>>(smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.Hq, p.B);
  fa_fwd_wgmma_kernel<D><<<grid, THREADS, smem, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

// p.D up to 64 runs the 64-column instantiation, the rest the 128-column one
int dispatch(const CUtensorMap& mq, const CUtensorMap& mk,
             const CUtensorMap& mv, const Params& p, cudaStream_t s,
             int* smem_out) {
  if (p.D <= 64) return launch<64>(mq, mk, mv, p, s, smem_out);
  return launch<128>(mq, mk, mv, p, s, smem_out);
}

}  // namespace wg

}  // namespace

// f32 body. Strides are in elements. Returns a cudaError_t (0 on success);
// the Python wrapper raises on anything else.
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, const void* active,
    int B, int Sq, int Sk, int Hq, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float scale, void* stream) {
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
  return simt_dispatch(p, D, static_cast<cudaStream_t>(stream), nullptr);
}

// bf16 body. q/k/v strides are in elements, multiples of 8, bases 16-byte
// aligned (the wrapper checks); o is written through its strides. D is a
// multiple of 16 up to 128; the maps cover the true D, the box 64 columns. Returns
// 0, a cudaError_t, or the negated CUresult of a refused tensor map.
extern "C" int repro_flash_attention_fwd_wgmma(
    const void* q, const void* k, const void* v, void* o, const void* active,
    int B, int Sq, int Sk, int Hq, int Hkv, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, float scale_log2, void* stream) {
  if (D < 16 || D > 128 || D % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  int err = wg::map_qkv(&mq, q, D, Hq, Sq, B, q_sh, q_ss, q_sb, wg::BQ);
  if (err == 0)
    err = wg::map_qkv(&mk, k, D, Hkv, Sk, B, k_sh, k_ss, k_sb, wg::BKV);
  if (err == 0)
    err = wg::map_qkv(&mv, v, D, Hkv, Sk, B, v_sh, v_ss, v_sb, wg::BKV);
  if (err != 0) return err;
  wg::Params p;
  p.o = o;
  p.active = static_cast<const int*>(active);
  p.B = B;
  p.Sq = Sq;
  p.Sk = Sk;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.D = D;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale_log2;
  return wg::dispatch(mq, mk, mv, p, static_cast<cudaStream_t>(stream),
                      nullptr);
}

// The dynamic shared memory, in bytes, that a launch at head dim D passes
// (body 0: the f32 body, 1: the bf16 body), written to *smem through the
// launch functions themselves, which launch nothing here. Returns 0, or
// cudaErrorInvalidValue for a head dim the body does not take.
extern "C" int repro_flash_attention_smem(int body, int D, int* smem) {
  if (body == 0) return simt_dispatch(Params{}, D, nullptr, smem);
  if (D < 16 || D > 128 || D % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  wg::Params p{};
  p.D = D;
  const CUtensorMap none{};
  return wg::dispatch(none, none, none, p, nullptr, smem);
}
