// The layout of the SSD scan's kernels (csrc/ssd_scan.cu): each CTA's
// shared memory, the three grids, the f32 scratch, and whether the rows of
// x, B and C can be copied 16 bytes at a time. Plain C++: the kernels
// launch with it, and the host compiler alone builds it for the CPU tests
// (tests/test_torch_ssd.py), so the one copy of these sums is the one that
// runs.
#pragma once

#include <cstdint>

#ifdef __CUDACC__
#define SSD_HD __host__ __device__
#else
#define SSD_HD
#endif

namespace ssd {

constexpr int STATE_THREADS = 256;  // threads per CTA of the state kernel
constexpr int PAD = 8;  // bf16 elements after each shared-memory row
constexpr int MAX_Q = 128;

SSD_HD inline int tile_bytes(int pieces, int rows, int cols) {
  return pieces * rows * (cols + PAD) * 2;
}

SSD_HD inline int imax(int a, int b) { return a > b ? a : b; }

SSD_HD inline int round16(int v) { return (v + 15) / 16 * 16; }

// Shared memory in bytes, every region a multiple of 16.
// Kernel 1: B, then x and W = decay dt x (three pieces), whose room C takes
// once the contribution is done; la and the decay weights.
struct ChunkLayout {
  int b, x, w, c, la, dt, bytes;
};

SSD_HD inline ChunkLayout chunk_layout(int Qp, int hdp, int Np, int P) {
  ChunkLayout L;
  L.b = 0;
  L.x = L.b + tile_bytes(P, Qp, Np);
  L.w = L.x + tile_bytes(P, Qp, hdp);
  L.c = L.x;
  L.la = L.x + imax(tile_bytes(P + 3, Qp, hdp), tile_bytes(P, Qp, Np));
  L.dt = L.la + 4 * Qp;
  L.bytes = L.dt + 4 * Qp;
  return L;
}

// Kernel 3: C, x, the state entering the chunk (three pieces, (N, hd)), la,
// dt.
struct OutLayout {
  int c, x, s, la, dt, bytes;
};

SSD_HD inline OutLayout out_layout(int Qp, int hdp, int Np, int P) {
  OutLayout L;
  L.c = 0;
  L.x = L.c + tile_bytes(P, Qp, Np);
  L.s = L.x + tile_bytes(P, Qp, hdp);
  L.la = L.s + tile_bytes(3, Np, hdp);
  L.dt = L.la + 4 * Qp;
  L.bytes = L.dt + 4 * Qp;
  return L;
}

inline bool shape_ok(int b, int S, int nh, int hd, int N, int Q) {
  return b > 0 && S > 0 && nh > 0 && Q > 0 && Q <= MAX_Q && S % Q == 0 &&
         hd > 0 && N > 0 && hd % 4 == 0 && N % 4 == 0;
}

// One call: the scratch la (b,nc,nh,Qp), cb (b,nc,Qp,Qp), cs (b,nc,nh,N,hd)
// in floats, carved in that order from one allocation (each a multiple of
// 16 floats, so every part starts 64-byte aligned); the grid of the chunk
// and output kernels, one CTA per (chunk, head, batch), and of the state
// kernel, one thread per 4 state entries of a (head, batch); each CTA's
// dynamic shared memory. P: bf16 pieces per operand element (1 or 3).
struct Plan {
  int Qp, hdp, Np;
  long long la, cb, cs;
  int grid[3], state_grid[3];
  int chunk_smem, out_smem;
};

inline Plan make_plan(int b, int S, int nh, int hd, int N, int Q, int P) {
  Plan pl;
  pl.Qp = round16(Q);
  pl.hdp = round16(hd);
  pl.Np = round16(N);
  const int nc = S / Q;
  const long long bc = (long long)b * nc;
  pl.la = bc * nh * pl.Qp;
  pl.cb = bc * pl.Qp * pl.Qp;
  pl.cs = bc * nh * N * hd;
  pl.grid[0] = nc;
  pl.grid[1] = nh;
  pl.grid[2] = b;
  pl.state_grid[0] = (hd * (N / 4) + STATE_THREADS - 1) / STATE_THREADS;
  pl.state_grid[1] = nh;
  pl.state_grid[2] = b;
  pl.chunk_smem = chunk_layout(pl.Qp, pl.hdp, pl.Np, P).bytes;
  pl.out_smem = out_layout(pl.Qp, pl.hdp, pl.Np, P).bytes;
  return pl;
}

// Whether every row of a tensor (its last axis, `cols` elements of `size`
// bytes, contiguous) starts on a 16-byte boundary: the base, the row's
// bytes and the stride of each axis longer than one are multiples of 16
// bytes.
inline bool rows_copyable(const void* base, int cols, int size,
                          const long long* stride, const int* extent,
                          int axes) {
  if (reinterpret_cast<uintptr_t>(base) % 16 != 0 || cols * size % 16 != 0)
    return false;
  for (int a = 0; a < axes; ++a)
    if (extent[a] > 1 && stride[a] * size % 16 != 0) return false;
  return true;
}

// x (b,S,nh,hd), B and C (b,S,N), all of `size`-byte elements.
inline bool inputs_copyable(const void* x, const void* B, const void* C,
                            int b, int S, int nh, int hd, int N, int size,
                            long long x_sb, long long x_ss, long long x_sh,
                            long long B_sb, long long B_ss, long long C_sb,
                            long long C_ss) {
  const long long xs[3] = {x_sb, x_ss, x_sh}, Bs[2] = {B_sb, B_ss},
                  Cs[2] = {C_sb, C_ss};
  const int xe[3] = {b, S, nh}, be[2] = {b, S};
  return rows_copyable(x, hd, size, xs, xe, 3) &&
         rows_copyable(B, N, size, Bs, be, 2) &&
         rows_copyable(C, N, size, Cs, be, 2);
}

}  // namespace ssd

// The plan as numbers, for the tests: out[0..2] la, cb, cs in floats;
// out[3..5] the chunk and output kernels' grid; out[6..8] the state
// kernel's; out[9], out[10] the chunk and output kernels' shared memory per
// CTA in bytes. dtype: 0 = float32 (three pieces), 1 = bfloat16. Returns 0,
// or 1 for a shape the kernels do not take.
extern "C" int repro_ssd_scan_layout(int b, int S, int nh, int hd, int N,
                                     int Q, int dtype, long long* out) {
  if (!ssd::shape_ok(b, S, nh, hd, N, Q) || (dtype != 0 && dtype != 1))
    return 1;
  const ssd::Plan pl = ssd::make_plan(b, S, nh, hd, N, Q, dtype ? 1 : 3);
  const long long v[11] = {pl.la, pl.cb, pl.cs,
                           pl.grid[0], pl.grid[1], pl.grid[2],
                           pl.state_grid[0], pl.state_grid[1],
                           pl.state_grid[2], pl.chunk_smem, pl.out_smem};
  for (int k = 0; k < 11; ++k) out[k] = v[k];
  return 0;
}

// 1 when the C entry would copy every row of x, B and C 16 bytes at a time.
extern "C" int repro_ssd_scan_copyable(
    const void* x, const void* B, const void* C, int b, int S, int nh,
    int hd, int N, int size, long long x_sb, long long x_ss, long long x_sh,
    long long B_sb, long long B_ss, long long C_sb, long long C_ss) {
  return ssd::inputs_copyable(x, B, C, b, S, nh, hd, N, size, x_sb, x_ss,
                              x_sh, B_sb, B_ss, C_sb, C_ss);
}
