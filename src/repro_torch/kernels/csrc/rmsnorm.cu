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
// for bit, because both kernels call the one __device__ routine rmsnorm_row
// below (the TPU kernels share their body for the same reason).
//
// What bounds it on an H100: it does ~4 operations per element and moves
// 2 bytes (bf16) or 8 bytes (f32) per element in and out, so it is bound by
// device memory: (4, 2048, 2048) bf16 moves 67 MB, 20 us at 3.35 TB/s. What
// the design does about that: each row is read from device memory once
// (staged in shared memory between the sum of squares and the scaling) and
// written once, in 16-byte vectors where the row is aligned; an inactive
// lane's blocks write zeros without loading x.
//
// Reduction order: element e of a row is owned by lane (e / V) % 32 of the
// row's warp (V = elements per 16-byte vector) and summed in increasing e
// with fmaf, whether it was loaded as a vector or alone; the 32 partial sums
// then meet in a fixed xor-butterfly of warp shuffles, which leaves the
// same bits in every lane. So the result depends on the row's values only.
//
// Grid: one warp per row, W warps per block (W = 8 unless a row is too long
// for W rows of shared memory); packed: (ceil(rows/W), J), fused:
// (ceil(rows/W)). A row longer than the shared memory of one block is read
// twice instead (the order of the sums does not change).

#include <cuda_runtime.h>

#include <cstdint>

#include "dtype.cuh"
#include "launch.cuh"

namespace {

using repro::from_f32;
using repro::to_f32;

constexpr int MAX_WARPS = 8;
constexpr int MAX_SMEM = 200 * 1024;  // of the 227 KB a block may use

template <typename T>
struct alignas(16) Vec {
  static constexpr int N = 16 / sizeof(T);
  T v[N];
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Normalize one row with the calling warp. `stage` holds d elements of
// shared memory for this warp, or is nullptr (then x is read twice).
template <typename T>
__device__ void rmsnorm_row(const T* __restrict__ x, const T* __restrict__ w,
                            T* __restrict__ o, T* stage, int d, float eps) {
  constexpr int V = Vec<T>::N;
  const int lane = threadIdx.x % 32;
  const bool vec = d % V == 0 && aligned16(x) && aligned16(w) &&
                   aligned16(o) && (stage == nullptr || aligned16(stage));

  float acc = 0.f;
  for (int base = lane * V; base < d; base += 32 * V) {
    if (vec) {
      const Vec<T> xv = *reinterpret_cast<const Vec<T>*>(x + base);
      if (stage != nullptr) *reinterpret_cast<Vec<T>*>(stage + base) = xv;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float f = to_f32(xv.v[i]);
        acc = fmaf(f, f, acc);
      }
    } else {
      for (int i = 0; i < V && base + i < d; ++i) {
        const T xe = x[base + i];
        if (stage != nullptr) stage[base + i] = xe;
        const float f = to_f32(xe);
        acc = fmaf(f, f, acc);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  const float r = rsqrtf(acc / static_cast<float>(d) + eps);

  const T* src = stage != nullptr ? stage : x;  // each lane re-reads its own
  for (int base = lane * V; base < d; base += 32 * V) {
    if (vec) {
      const Vec<T> xv = *reinterpret_cast<const Vec<T>*>(src + base);
      const Vec<T> wv = *reinterpret_cast<const Vec<T>*>(w + base);
      Vec<T> ov;
#pragma unroll
      for (int i = 0; i < V; ++i)
        ov.v[i] = from_f32<T>(to_f32(xv.v[i]) * r * to_f32(wv.v[i]));
      *reinterpret_cast<Vec<T>*>(o + base) = ov;
    } else {
      for (int i = 0; i < V && base + i < d; ++i)
        o[base + i] = from_f32<T>(to_f32(src[base + i]) * r *
                                  to_f32(w[base + i]));
    }
  }
}

template <typename T>
__device__ void zero_row(T* o, int d) {
  for (int e = threadIdx.x % 32; e < d; e += 32) o[e] = from_f32<T>(0.f);
}

// This warp's d elements of the block's dynamic shared memory, or nullptr.
template <typename T>
__device__ __forceinline__ T* warp_stage(unsigned char* smem, bool staged,
                                         int d) {
  return staged
             ? reinterpret_cast<T*>(smem) + (threadIdx.x / 32) * (long long)d
             : nullptr;
}

template <typename T>
__global__ void fused_rmsnorm_kernel(const T* x, const T* w, T* o, int rows,
                                     int d, float eps, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  rmsnorm_row<T>(x + row * d, w, o + row * d, warp_stage<T>(smem, staged, d),
                 d, eps);
}

template <typename T>
__global__ void packed_rmsnorm_kernel(const T* x, const T* w, T* o,
                                      const int* active, int rows, int d,
                                      float eps, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int j = blockIdx.y;
  const long long row =
      (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;
  const long long off = ((long long)j * rows + row) * d;
  if (active != nullptr && active[j] == 0) {
    zero_row<T>(o + off, d);
    return;
  }
  rmsnorm_row<T>(x + off, w + (long long)j * d, o + off,
                 warp_stage<T>(smem, staged, d), d, eps);
}

// Warps per block and shared memory per block for rows of d elements.
template <typename T>
void shape(int d, int* warps, int* smem, int* staged) {
  const long long row_bytes = (long long)d * sizeof(T);
  *staged = row_bytes <= MAX_SMEM;
  *warps = *staged ? (int)(MAX_SMEM / row_bytes) : MAX_WARPS;
  if (*warps > MAX_WARPS) *warps = MAX_WARPS;
  *smem = *staged ? (int)(*warps * row_bytes) : 0;
}

template <typename T>
cudaError_t launch(const T* x, const T* w, T* o, const int* active, int J,
                   int rows, int d, float eps, bool packed,
                   cudaStream_t stream) {
  int warps, smem, staged;
  shape<T>(d, &warps, &smem, &staged);
  const dim3 grid((rows + warps - 1) / warps, packed ? J : 1);
  cudaError_t err;
  if (packed) {
    err = repro::allow_dynamic_smem<packed_rmsnorm_kernel<T>>(smem);
    if (err != cudaSuccess) return err;
    packed_rmsnorm_kernel<T><<<grid, warps * 32, smem, stream>>>(
        x, w, o, active, rows, d, eps, staged);
  } else {
    err = repro::allow_dynamic_smem<fused_rmsnorm_kernel<T>>(smem);
    if (err != cudaSuccess) return err;
    fused_rmsnorm_kernel<T><<<grid, warps * 32, smem, stream>>>(
        x, w, o, rows, d, eps, staged);
  }
  return cudaGetLastError();
}

template <typename T>
int dispatch(const void* x, const void* w, void* o, const void* active, int J,
             int rows, int d, float eps, bool packed, void* stream) {
  return static_cast<int>(launch<T>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(o),
      static_cast<const int*>(active), J, rows, d, eps, packed,
      static_cast<cudaStream_t>(stream)));
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w and out share it). x and out are
// contiguous (rows, d) and w is (d,). Returns a cudaError_t.
extern "C" int repro_fused_rmsnorm(const void* x, const void* w, void* out,
                                   int rows, int d, float eps, int dtype,
                                   void* stream) {
  if (dtype == 0)
    return dispatch<float>(x, w, out, nullptr, 1, rows, d, eps, false, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, out, nullptr, 1, rows, d, eps, false,
                                   stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x and out contiguous (J, rows, d), w contiguous (J, d), active (J,) int32
// or null.
extern "C" int repro_packed_rmsnorm(const void* x, const void* w, void* out,
                                    const void* active, int J, int rows, int d,
                                    float eps, int dtype, void* stream) {
  if (dtype == 0)
    return dispatch<float>(x, w, out, active, J, rows, d, eps, true, stream);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w, out, active, J, rows, d, eps, true,
                                   stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
