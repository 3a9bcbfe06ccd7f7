// Row RMSNorm for Hopper (sm_90a): the lane-batched variant with per-lane
// weights and a per-lane predicate, and the plain row variant, on one body.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/fused_rmsnorm.py::packed_rmsnorm (_packed_rmsnorm_kernel)
//   src/repro/kernels/fused_rmsnorm.py::fused_rmsnorm  (_rmsnorm_kernel).
// Both compute, per row of d elements, out = x * rsqrt(mean(x^2) + eps) * w
// with f32 statistics, rounded once to x's dtype. packed_rmsnorm normalizes
// x (J, rows, d) with weights w (J, d) and writes exact zeros for an
// inactive lane; an active lane equals fused_rmsnorm on the same slice bit
// for bit, because both kernels call the same __device__ row routines
// below with the same template argument (the TPU kernels share their body
// for the same reason).
//
// What bounds it on an H100: it does ~4 operations per element and moves
// 2 bytes (bf16) or 8 bytes (f32) per element in and out, so it is bound by
// device memory: (4, 2048, 2048) bf16 moves 67 MB, 20 us at 3.35 TB/s, and
// (1, 1024, 2048) bf16 8.4 MB, 2.5 us. What the design does about that:
// each row is read from device memory once and written once, in 16-byte
// vectors where the row is aligned, and a warp issues all of its row's
// loads, of x and of w, before it uses the first, so the whole row is in
// flight at once. The row lives in registers: lane l holds the vectors
// l, l + 32, ..., l + 32 (VPL - 1) (VPL vectors per lane, a power of two
// from 1 to 8 that the Python wrappers pick from d,
// fused_rmsnorm.py::row_vectors; the vectors past d read zeros). A row
// that fills all 32 VPL vectors is loaded with no predicate: a load whose
// result is merged from two branches makes the warp wait for it there,
// which would put one vector in flight at a time again. x and out go
// evict-first, w stays in L2 for the next row. No shared memory is used,
// so blocks of 4 warps, one row each, fit many to an SM. A row longer
// than 8 vectors per lane (bf16 d > 2048, f32 d > 1024) is read twice
// instead, the second time from L2, in pieces of 8 vectors per lane whose
// loads are all in flight at once (rmsnorm_row_twice; 16 vectors per lane
// took 255 registers and spilled, and staging the row in shared memory
// was slower). An inactive lane's warps write zeros without loading x.
//
// Reduction order: element e of a row is owned by lane (e / V) % 32 of the
// row's warp (V = elements per 16-byte vector) and summed in increasing e
// with fmaf, whether it was loaded as a vector or alone and in both
// routines (a predicated-off element is a zero, whose square adds an exact
// zero); the 32 partial sums then meet in a fixed xor-butterfly of warp
// shuffles, which leaves the same bits in every lane. So the result
// depends on the row's values only.
//
// Grid: one warp per row, 4 warps per block; packed: (ceil(rows/4), J),
// fused: (ceil(rows/4)).

#include <cuda_runtime.h>

#include <cstdint>

#include "dtype.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int WARPS = 4;

template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ float warp_sum(float acc) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// One vector of a row (elements base .. base + V - 1, those below d, the
// rest zeros): one 16-byte load where the row allows it, else element by
// element.
template <typename T>
__device__ __forceinline__ Vec<T> load_vec(const T* __restrict__ p, int base,
                                           int d, bool vec) {
  if (vec && base < d) return *reinterpret_cast<const Vec<T>*>(p + base);
  Vec<T> r;
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i)
    r.v[i] = base + i < d ? p[base + i] : from_f32<T>(0.f);
  return r;
}

// x is read once and out written once: both evict-first (ld/st.global.cs),
// so they do not push w out of L2.
template <typename T>
__device__ __forceinline__ Vec<T> load_once(const T* __restrict__ p) {
  Vec<T> r;
  *reinterpret_cast<uint4*>(&r) = __ldcs(reinterpret_cast<const uint4*>(p));
  return r;
}

template <typename T>
__device__ __forceinline__ void store_vec(T* __restrict__ o, int base, int d,
                                          bool vec, const Vec<T>& r) {
  constexpr int V = Vec<T>::N;
  if (vec) {
    __stcs(reinterpret_cast<uint4*>(o + base),
           *reinterpret_cast<const uint4*>(&r));
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (base + i < d) o[base + i] = r.v[i];
  }
}

// Vectors lane, lane + 32, ..., lane + 32 (N - 1) of a row piece of d
// elements of x, and of w if W (zeros past d), every load issued before
// any is used: with no predicate where the piece fills all 32 N vectors.
// x and w load in one branch, since a load whose result is merged from two
// branches makes the warp wait for it there, which would put one operand
// (or one vector) in flight at a time. X_ONCE: x is loaded evict-first.
template <typename T, int N, bool X_ONCE, bool W>
__device__ __forceinline__ void load_piece(const T* __restrict__ x,
                                           const T* __restrict__ w, int d,
                                           bool vec, Vec<T> (&xv)[N],
                                           Vec<T> (&wv)[N]) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x % 32;
  if (vec && d >= 32 * V * N) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const T* p = x + (lane + 32 * i) * V;
      if constexpr (X_ONCE)
        xv[i] = load_once(p);
      else
        xv[i] = *reinterpret_cast<const Vec<T>*>(p);
    }
    if constexpr (W) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        wv[i] = *reinterpret_cast<const Vec<T>*>(w + (lane + 32 * i) * V);
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      xv[i] = load_vec(x, (lane + 32 * i) * V, d, vec);
      if constexpr (W) wv[i] = load_vec(w, (lane + 32 * i) * V, d, vec);
    }
  }
}

template <typename T>
__device__ __forceinline__ Vec<T> scale(const Vec<T>& x, const Vec<T>& w,
                                        float r) {
  Vec<T> o;
#pragma unroll
  for (int i = 0; i < Vec<T>::N; ++i)
    o.v[i] = from_f32<T>(to_f32(x.v[i]) * r * to_f32(w.v[i]));
  return o;
}

// Sum of squares of a piece's vectors, in increasing element order.
template <typename T, int N>
__device__ __forceinline__ float sum_squares(const Vec<T> (&v)[N],
                                             float acc) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int q = 0; q < Vec<T>::N; ++q) {
      const float f = to_f32(v[i].v[q]);
      acc = fmaf(f, f, acc);
    }
  return acc;
}

template <typename T, int N>
__device__ __forceinline__ void store_piece(T* __restrict__ o, int d,
                                            bool vec, const Vec<T> (&x)[N],
                                            const Vec<T> (&w)[N], float r) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int base = (lane + 32 * i) * V;
    if (base < d) store_vec(o, base, d, vec, scale(x[i], w[i], r));
  }
}

__device__ __forceinline__ bool row_vec(int d, int V, const void* x,
                                        const void* w, const void* o) {
  return d % V == 0 && aligned16(x) && aligned16(w) && aligned16(o);
}

// Normalize one row of d <= 32 * VPL * V elements with the calling warp,
// the row held in registers: every load is issued before the first use.
template <typename T, int VPL>
__device__ void rmsnorm_row(const T* __restrict__ x, const T* __restrict__ w,
                            T* __restrict__ o, int d, float eps) {
  const bool vec = row_vec(d, Vec<T>::N, x, w, o);
  Vec<T> xv[VPL], wv[VPL];
  load_piece<T, VPL, true, true>(x, w, d, vec, xv, wv);
  const float r =
      rsqrtf(warp_sum(sum_squares(xv, 0.f)) / static_cast<float>(d) + eps);
  store_piece(o, d, vec, xv, wv, r);
}

// A row too long for the registers, taken in pieces of 8 vectors per lane
// (each piece's loads all in flight at once): x is read once for the sum
// of squares and again, from L2, for the scaling (the same order of sums).
template <typename T>
__device__ void rmsnorm_row_twice(const T* __restrict__ x,
                                  const T* __restrict__ w, T* __restrict__ o,
                                  int d, float eps) {
  constexpr int N = 8, STEP = 32 * N * Vec<T>::N;
  const bool vec = row_vec(d, Vec<T>::N, x, w, o);
  float acc = 0.f;
  for (int c = 0; c < d; c += STEP) {
    Vec<T> xv[N];  // x alone: the w arguments are not touched
    load_piece<T, N, false, false>(x + c, nullptr, d - c, vec, xv, xv);
    acc = sum_squares(xv, acc);
  }
  const float r = rsqrtf(warp_sum(acc) / static_cast<float>(d) + eps);
  for (int c = 0; c < d; c += STEP) {
    Vec<T> xv[N], wv[N];
    load_piece<T, N, true, true>(x + c, w + c, d - c, vec, xv, wv);
    store_piece(o + c, d - c, vec, xv, wv, r);
  }
}

// VPL = 0: the two-read routine; else the register routine.
template <typename T, int VPL>
__device__ __forceinline__ void norm_row(const T* x, const T* w, T* o, int d,
                                         float eps) {
  if constexpr (VPL == 0)
    rmsnorm_row_twice<T>(x, w, o, d, eps);
  else
    rmsnorm_row<T, VPL>(x, w, o, d, eps);
}

template <typename T>
__device__ void zero_row(T* o, int d) {
  for (int e = threadIdx.x % 32; e < d; e += 32) o[e] = from_f32<T>(0.f);
}

template <typename T, int VPL>
__global__ void __launch_bounds__(WARPS * 32)
    fused_rmsnorm_kernel(const T* x, const T* w, T* o, int rows, int d,
                         float eps) {
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  norm_row<T, VPL>(x + row * d, w, o + row * d, d, eps);
}

template <typename T, int VPL>
__global__ void __launch_bounds__(WARPS * 32)
    packed_rmsnorm_kernel(const T* x, const T* w, T* o, const int* active,
                          int rows, int d, float eps) {
  const int j = blockIdx.y;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const long long off = ((long long)j * rows + row) * d;
  if (active != nullptr && active[j] == 0) {
    zero_row<T>(o + off, d);
    return;
  }
  norm_row<T, VPL>(x + off, w + (long long)j * d, o + off, d, eps);
}

template <typename T, int VPL>
cudaError_t launch(const T* x, const T* w, T* o, const int* active, int J,
                   int rows, int d, float eps, bool packed,
                   cudaStream_t stream) {
  const dim3 grid((rows + WARPS - 1) / WARPS, packed ? J : 1);
  if (packed)
    packed_rmsnorm_kernel<T, VPL><<<grid, WARPS * 32, 0, stream>>>(
        x, w, o, active, rows, d, eps);
  else
    fused_rmsnorm_kernel<T, VPL><<<grid, WARPS * 32, 0, stream>>>(
        x, w, o, rows, d, eps);
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* xp, const void* wp, void* op, const void* ap, int J,
             int rows, int d, float eps, int vpl, bool packed, void* sp) {
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  T* o = static_cast<T*>(op);
  const int* a = static_cast<const int*>(ap);
  cudaStream_t s = static_cast<cudaStream_t>(sp);
  cudaError_t err;
  switch (vpl) {
    case 0: err = launch<T, 0>(x, w, o, a, J, rows, d, eps, packed, s); break;
    case 1: err = launch<T, 1>(x, w, o, a, J, rows, d, eps, packed, s); break;
    case 2: err = launch<T, 2>(x, w, o, a, J, rows, d, eps, packed, s); break;
    case 4: err = launch<T, 4>(x, w, o, a, J, rows, d, eps, packed, s); break;
    case 8: err = launch<T, 8>(x, w, o, a, J, rows, d, eps, packed, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

int dispatch_dtype(int dtype, const void* x, const void* w, void* o,
                   const void* a, int J, int rows, int d, float eps, int vpl,
                   bool packed, void* s) {
  if (dtype == 0)
    return dispatch<float>(x, w, o, a, J, rows, d, eps, vpl, packed, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, o, a, J, rows, d, eps, vpl, packed,
                                   s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it). vpl: 16-byte
// vectors per lane of the register routine (1, 2, 4 or 8, with
// 32 * vpl vectors covering d), or 0 for the two-read routine. x and out
// are contiguous (rows, d) and w is (d,). Returns a cudaError_t.
extern "C" int repro_fused_rmsnorm(const void* x, const void* w, void* out,
                                   int rows, int d, float eps, int dtype,
                                   int vpl, void* stream) {
  return dispatch_dtype(dtype, x, w, out, nullptr, 1, rows, d, eps, vpl,
                        false, stream);
}

// x and out contiguous (J, rows, d), w contiguous (J, d), active (J,) int32
// or null; dtype and vpl as above.
extern "C" int repro_packed_rmsnorm(const void* x, const void* w, void* out,
                                    const void* active, int J, int rows, int d,
                                    float eps, int dtype, int vpl,
                                    void* stream) {
  return dispatch_dtype(dtype, x, w, out, active, J, rows, d, eps, vpl, true,
                        stream);
}
