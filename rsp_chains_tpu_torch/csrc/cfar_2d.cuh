// The 2-D rectangular-annulus CA CFAR over a range-Doppler magnitude map:
// the detector of Kernel J (rd_2d.cu).
//
// Replaces rsp_chains_tpu/kernels/rd_pallas.py::_cfar2d_into (:348, with
// `_cbox` :317 and `_interval_count` :339). Its semantics: the cells of the
// map outside [active_lo, active_hi) in range count as zero; the noise of
// cell (d, r) is the sum over the outer rectangle of half-extents
// (a_d = g_d + w_d, a_r = g_r + w_r) minus the inner rectangle (g_d, g_r),
// divided by the true training count (the product of the per-axis interval
// counts, outer minus inner, at least 1); the threshold is noise * scaler
// (linear) or noise + scaler (log), 0 outside the active range; a peak is
// mag > thr inside it, and with grouping a maximum of its 8 neighbours, a
// neighbour outside the frame counting as -inf.
//
// The TPU builds the box sums from dyadic rolls over the whole padded map in
// VMEM. Here one block of 256 threads takes a tile of RSP_C2D_TD (32)
// Doppler rows by RSP_C2D_TR (128) range cells and stages the map rows its
// Doppler windows reach, [d0 - a_d, d0 + 31 + a_d], with cp.async (zeros
// outside the map and the active range, range halos of a_r), so each map
// cell is read about once (42 rows for 32 at the bench's a_d = 5), and sums
// its windows with adds only:
// * range sums: a lane a staged row and a warp a 16-cell run, the 16
//   windows of 2 a_r + 1 and of 2 g_r + 1 cells by `rsp_window_runs` (the
//   cells every window holds once, the edges as running sums), into two
//   planes of range sums; rows of an odd number of floats keep the 32 rows
//   of a warp in 32 banks.
// * Doppler sums: a thread a 16-row run of one column (two runs a column),
//   the same run sums down the column; the outer sums are added to the 16
//   annulus sums the thread keeps in registers, the inner ones taken off.
// * the test: the threshold from a table of each tile row's counts (a
//   multiply by the reciprocal where the active range holds a column's
//   windows whole), the cell and its 8 neighbours from the staged rows.
// Up to RSP_C2D_RB1 (52) rows, a_d <= 10, they are staged in one chunk (the
// one-chunk route: 42 rows and 68,760 bytes of shared memory at the bench's
// registers, three blocks an SM; 107,088 bytes at the most). A longer
// Doppler reach takes the chunked route: RSP_C2D_RB (32) rows at a time
// inside the map, the next chunk in flight while a chunk's Doppler sums run,
// those sums clipped to the chunk, the tile's cells kept in `own`; 83,728
// bytes at the most (a_r = 63), whatever the reach, so every reach runs
// here. Every sum restarts at each tile: no prefix sum or running
// subtraction along a column (the inner sums come off once a chunk, each
// partial sum at most the outer sum of the rows staged so far), so the
// rounding is a plain sum's whatever P.
// Bound: device memory, 9 bytes a sample (the magnitude in, 4 + 1 out),
// ~0.045 ms at 64 x 256 x 1024.
#pragma once

#include <cstdint>

#include "ca_cfar.cuh"

#define RSP_C2D_TD 32     // Doppler rows of a tile: two 16-row runs a column
#define RSP_C2D_TR 128    // range cells of a tile: eight 16-cell runs a row
#define RSP_C2D_THREADS (2 * RSP_C2D_TR)  // a 16-row run a thread
#define RSP_C2D_RB 32     // map rows staged at a time (the chunked route)
#define RSP_C2D_RB1 52    // rows the one-chunk route stages, at most
#define RSP_C2D_SUMS (RSP_C2D_TR + 1)  // floats a range-sum row (odd)
#define RSP_C2D_OWN (RSP_C2D_TR + 2)  // floats a row of `own`

// The 2-D register file after the host clamps (kernels/rd.py,
// `cfar_2d_registers`, as rd_pallas.py:488-500 clamps it), passed by value.
struct RspCfar2dRegs {
  int w_r;            // reference cells per side, range (>= 1)
  int g_r;            // guard cells per side, range
  int w_d;            // reference cells per side, Doppler (>= 1)
  int g_d;            // guard cells per side, Doppler
  int log_or_linear;  // 1 linear (scaler multiplies), else log (adds)
  int peak_grouping;  // 1: peaks must be 8-neighbour maxima
  int active_lo;      // active range cells [active_lo, active_hi)
  int active_hi;
  int mag_mode;       // the magnitude of the front; clipped on the host
  float scaler;
};

// |[pos - a, pos + a] ∩ [lo, hi)|
static __device__ __forceinline__ float rsp_interval_count(int pos, int a,
                                                           int lo, int hi) {
  return (float)max(min(pos + a, hi - 1) - max(pos - a, lo) + 1, 0);
}

// Floats of a staged row of RSP_C2D_TR + 2 a_r cells: an odd count, so the
// same cell of 32 rows falls in 32 banks.
static __host__ __device__ inline int rsp_c2d_row_floats(int a_r) {
  return RSP_C2D_TR + 2 * a_r + 1;
}

// Whether a tile's Doppler windows (half-extent a_d) reach few enough rows
// for the one-chunk route.
static __host__ __device__ inline bool rsp_c2d_one(int a_d) {
  return RSP_C2D_TD + 2 * a_d <= RSP_C2D_RB1;
}

// Bytes of shared memory of the detector at the half-extents a_r, a_d: the
// staged rows, the two range-sum planes and the rows' Doppler counts, and on
// the chunked route `own`.
static inline size_t rsp_c2d_smem(int a_r, int a_d) {
  const bool one = rsp_c2d_one(a_d);
  const int rows = one ? RSP_C2D_TD + 2 * a_d : RSP_C2D_RB;
  return ((size_t)rows * (rsp_c2d_row_floats(a_r) + 2 * RSP_C2D_SUMS) +
          3 * RSP_C2D_TD + (one ? 0 : (RSP_C2D_TD + 2) * RSP_C2D_OWN)) *
         sizeof(float);
}

// v[k0 + k] = the sum of x(t) over t in [b + k0 + k, b + k0 + k + w), C
// windows at a time (k < C <= w), by adds only: the cells all C windows hold
// once, the left edges as a running sum downwards and the right edges
// upwards (`rsp_run_sums` for one window). kClip: only t in [t_lo, t_hi) is
// read and summed.
template <int C, bool kClip, typename X>
static __device__ __forceinline__ void rsp_window_runs_of(const X& x, int b,
                                                          int w, int t_lo,
                                                          int t_hi,
                                                          float (&v)[16]) {
#pragma unroll
  for (int k0 = 0; k0 < 16; k0 += C) {
    const int b0 = b + k0;
    float mid = 0.0f;
    const int m1 = kClip ? min(b0 + w, t_hi) : b0 + w;
#pragma unroll 4
    for (int t = kClip ? max(b0 + C - 1, t_lo) : b0 + C - 1; t < m1; ++t)
      mid += x(t);
    float e = 0.0f;
    v[k0 + C - 1] = mid;
#pragma unroll
    for (int k = C - 2; k >= 0; --k) {
      const int t = b0 + k;
      if (!kClip || (t >= t_lo && t < t_hi)) e += x(t);
      v[k0 + k] = e + mid;
    }
    e = 0.0f;
#pragma unroll
    for (int k = 1; k < C; ++k) {
      const int t = b0 + w - 1 + k;
      if (!kClip || (t >= t_lo && t < t_hi)) e += x(t);
      v[k0 + k] += e;
    }
  }
}

// v[k] = the sum of x(t) over t in [b + k, b + k + w) for k < 16, with t in
// [t_lo, t_hi) only for kClip; C = min(16, the largest power of two <= w)
// windows at a time, about w + 15 reads for the 16 when w >= 16.
template <bool kClip, typename X>
static __device__ __forceinline__ void rsp_window_runs(const X& x, int b,
                                                       int w, int t_lo,
                                                       int t_hi,
                                                       float (&v)[16]) {
  if (w >= 16)
    rsp_window_runs_of<16, kClip>(x, b, w, t_lo, t_hi, v);
  else if (w >= 8)
    rsp_window_runs_of<8, kClip>(x, b, w, t_lo, t_hi, v);
  else if (w >= 4)
    rsp_window_runs_of<4, kClip>(x, b, w, t_lo, t_hi, v);
  else if (w >= 2)
    rsp_window_runs_of<2, kClip>(x, b, w, t_lo, t_hi, v);
  else
    rsp_window_runs_of<1, kClip>(x, b, w, t_lo, t_hi, v);
}

// The cells of a staged row, and a column of a range-sum plane, as the
// x(t) of rsp_window_runs.
struct RspStagedRow {
  const float* row;
  __device__ __forceinline__ float operator()(int t) const { return row[t]; }
};
struct RspSumColumn {
  const float* column;
  __device__ __forceinline__ float operator()(int t) const {
    return column[t * RSP_C2D_SUMS];
  }
};

// An asynchronous copy of 4 bytes from device to shared memory (cp.async),
// zeros where !valid (src is then not read, but must be a device address).
static __device__ __forceinline__ void rsp_copy_async(float* dst,
                                                      const float* src,
                                                      bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(__cvta_generic_to_global(src)), "r"(valid ? 4 : 0));
}

static __device__ __forceinline__ void rsp_copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Stage map rows s0 .. s0 + nr - 1 of `src`, cells c0 .. c0 + cols - 1, into
// `plane` (a row every row_floats floats), zeros outside the map's p rows
// and the active range [lo, hi): a warp a row, every copy of the chunk in
// flight at once (rsp_copy_async; rsp_copy_async_wait before the first
// read).
static __device__ __forceinline__ void rsp_c2d_stage(
    float* plane, int row_floats, const float* src, int p, int n, int s0,
    int nr, int c0, int cols, int lo, int hi) {
  const int lane = threadIdx.x & 31;
  for (int jj = threadIdx.x >> 5; jj < nr; jj += RSP_C2D_THREADS / 32) {
    const int s = s0 + jj;
    const bool in_map = s >= 0 && s < p;
    const float* row = src + (size_t)(in_map ? s : 0) * n;
    float* dst = plane + jj * row_floats;
    for (int cc = lane; cc < cols; cc += 32) {
      const int g = c0 + cc;
      const bool valid = in_map && g >= lo && g < hi;
      rsp_copy_async(dst + cc, valid ? row + g : src, valid);
    }
  }
}

// Blocks an SM in the detector's launch bounds: 80 registers a thread.
#define RSP_C2D_BLOCKS 3

// mag, thr: float32 [batch, p, n]; peaks: uint8 [batch, p, n]; n a multiple
// of RSP_C2D_TR; 0 <= active_lo <= active_hi <= n; 2 (g_r + w_r) + 2 <=
// RSP_PAD. Grid (batch * n / RSP_C2D_TR, ceil(p / RSP_C2D_TD)),
// RSP_C2D_THREADS threads, rsp_c2d_smem(g_r + w_r, g_d + w_d) bytes of
// shared memory; kOne = rsp_c2d_one(g_d + w_d).
//
// kOne, the one-chunk route: the tile's windows reach at most RSP_C2D_RB1
// rows, staged at once with zero rows outside the map, so the Doppler run
// sums read no row outside the staged ones and the peak test reads the
// staged rows. Else the chunked route: RSP_C2D_RB rows at a time inside the
// map, the next chunk in flight while a chunk's Doppler sums run, those
// sums clipped to the chunk, the tile's cells and their ring kept in `own`.
template <bool kOne>
static __global__ void __launch_bounds__(RSP_C2D_THREADS, RSP_C2D_BLOCKS)
rsp_cfar2d_kernel(const float* __restrict__ mag, float* __restrict__ thr,
                  uint8_t* __restrict__ peaks, int p, int n, RspCfar2dRegs r) {
  extern __shared__ float smem[];
  const int a_r = r.g_r + r.w_r, a_d = r.g_d + r.w_d;
  const int row_floats = rsp_c2d_row_floats(a_r);
  const int rows = kOne ? RSP_C2D_TD + 2 * a_d : RSP_C2D_RB;
  float* plane = smem;  // [rows][row_floats]: the staged rows
  float* s_out = plane + rows * row_floats;  // [rows][SUMS]: range sums
  float* s_in = s_out + rows * RSP_C2D_SUMS;
  float* counts = s_in + rows * RSP_C2D_SUMS;  // [3][TD]
  float* own = counts + 3 * RSP_C2D_TD;        // [TD + 2][OWN], chunked
  const int cols = RSP_C2D_TR + 2 * a_r;
  const int tiles_r = n / RSP_C2D_TR;
  const int r0 = (blockIdx.x % tiles_r) * RSP_C2D_TR;
  const int d0 = blockIdx.y * RSP_C2D_TD;
  const size_t base = (size_t)(blockIdx.x / tiles_r) * p * n;
  const float* map = mag + base;
  const int lo = r.active_lo, hi = r.active_hi;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the Doppler sums' run: tile column c, map rows dr .. dr + 15
  const int c = threadIdx.x % RSP_C2D_TR;
  const int dr = d0 + 16 * (threadIdx.x / RSP_C2D_TR);

  const int s_lo = kOne ? d0 - a_d : max(d0 - a_d, 0);
  const int s_hi = kOne ? d0 + RSP_C2D_TD - 1 + a_d
                        : min(d0 + RSP_C2D_TD - 1 + a_d, p - 1);
  rsp_c2d_stage(plane, row_floats, map, p, n, s_lo,
                min(rows, s_hi - s_lo + 1), r0 - a_r, cols, lo, hi);
  if (!kOne) {
    for (int i = threadIdx.x; i < (RSP_C2D_TD + 2) * RSP_C2D_OWN;
         i += RSP_C2D_THREADS)
      own[i] = -CUDART_INF_F;
  }
  // each tile row's Doppler interval counts, outer and inner, and the
  // reciprocal of its training count in a column whose windows the active
  // range holds whole
  if (threadIdx.x < RSP_C2D_TD) {
    const int d = d0 + threadIdx.x;
    const float co = rsp_interval_count(d, a_d, 0, p);
    const float ci = rsp_interval_count(d, r.g_d, 0, p);
    counts[threadIdx.x] = co;
    counts[RSP_C2D_TD + threadIdx.x] = ci;
    counts[2 * RSP_C2D_TD + threadIdx.x] =
        1.0f / fmaxf((2 * a_r + 1) * co - (2 * r.g_r + 1) * ci, 1.0f);
  }
  // acc[k]: the annulus sum of row dr + k, the outer windows' sums less the
  // inner windows', chunk by chunk
  float acc[16], v[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) acc[k] = 0.0f;

  for (int s0 = s_lo; s0 <= s_hi; s0 += rows) {
    const int nr = min(rows, s_hi - s0 + 1);
    rsp_copy_async_wait();
    __syncthreads();  // the chunk is staged; the last one's sums are read
    if (!kOne) {
      // own: the chunk's rows of the tile and its ring, -inf outside the
      // active range (map cell r0 - 1 + oc is staged cell oc + a_r - 1)
      for (int s = max(d0 - 1, s0) + warp;
           s <= min(d0 + RSP_C2D_TD, s0 + nr - 1);
           s += RSP_C2D_THREADS / 32) {
        const float* row = plane + (s - s0) * row_floats;
        for (int oc = lane; oc < RSP_C2D_OWN; oc += 32) {
          const int g = r0 - 1 + oc;
          own[(s - d0 + 1) * RSP_C2D_OWN + oc] =
              g >= lo && g < hi ? row[oc + a_r - 1] : -CUDART_INF_F;
        }
      }
    }
    // the range sums of each staged row, a lane a row and a warp a 16-cell
    // run (tile cells 16 warp ..; tile cell i is staged cell i + a_r)
    for (int j = lane; j < nr; j += 32) {
      const RspStagedRow x{plane + j * row_floats + 16 * warp};
      float* so = s_out + j * RSP_C2D_SUMS + 16 * warp;
      float* si = s_in + j * RSP_C2D_SUMS + 16 * warp;
      rsp_window_runs<false>(x, 0, 2 * a_r + 1, 0, 0, v);
#pragma unroll
      for (int k = 0; k < 16; ++k) so[k] = v[k];
      rsp_window_runs<false>(x, a_r - r.g_r, 2 * r.g_r + 1, 0, 0, v);
#pragma unroll
      for (int k = 0; k < 16; ++k) si[k] = v[k];
    }
    __syncthreads();  // the staged rows are summed
    // the Doppler sums of this thread's run over the chunk's rows (the
    // chunked route: the next chunk in flight meanwhile)
    const int b = dr - s0;
    if (kOne) {
      if (dr < p) {
        rsp_window_runs<false>(RspSumColumn{s_out + c}, b - a_d, 2 * a_d + 1,
                               0, 0, v);
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[k] += v[k];
        rsp_window_runs<false>(RspSumColumn{s_in + c}, b - r.g_d,
                               2 * r.g_d + 1, 0, 0, v);
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[k] -= v[k];
      }
    } else {
      if (s0 + rows <= s_hi)
        rsp_c2d_stage(plane, row_floats, map, p, n, s0 + rows,
                      min(rows, s_hi - s0 - rows + 1), r0 - a_r, cols, lo,
                      hi);
      if (dr < p && b - a_d < nr && b + 15 + a_d >= 0) {
        rsp_window_runs<true>(RspSumColumn{s_out + c}, b - a_d, 2 * a_d + 1,
                              0, nr, v);
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[k] += v[k];
        rsp_window_runs<true>(RspSumColumn{s_in + c}, b - r.g_d,
                              2 * r.g_d + 1, 0, nr, v);
#pragma unroll
        for (int k = 0; k < 16; ++k) acc[k] -= v[k];
      }
    }
  }

  const int rc = r0 + c;
  const bool active = rc >= lo && rc < hi;
  const float n_out = rsp_interval_count(rc, a_r, lo, hi);
  const float n_in = rsp_interval_count(rc, r.g_r, lo, hi);
  const bool whole = rc - a_r >= lo && rc + a_r < hi;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int d = dr + k;
    if (d < p) {
      const size_t at = base + (size_t)d * n + rc;
      float t = 0.0f;
      bool pk = false;
      if (active) {
        const int i = d - d0;
        const float noise =
            whole ? acc[k] * counts[2 * RSP_C2D_TD + i]
                  : acc[k] / fmaxf(n_out * counts[i] -
                                       n_in * counts[RSP_C2D_TD + i],
                                   1.0f);
        t = rsp_threshold(noise, r.log_or_linear, r.scaler);
        // the cell and its 8 neighbours: a neighbour outside the map or the
        // active range does not count (own holds -inf there)
        const int stride = kOne ? row_floats : RSP_C2D_OWN;
        const float* cell = kOne ? plane + (d - s_lo) * row_floats + a_r + c
                                 : own + (i + 1) * RSP_C2D_OWN + c + 1;
        const float m = cell[0];
        pk = m > t;
        if (pk && r.peak_grouping == 1) {
#pragma unroll
          for (int dd = -1; dd <= 1; ++dd)
#pragma unroll
            for (int dc = -1; dc <= 1; ++dc)
              if ((dd || dc) &&
                  (!kOne || (d + dd >= 0 && d + dd < p && rc + dc >= lo &&
                             rc + dc < hi)))
                pk = pk && m >= cell[dd * stride + dc];
        }
      }
      thr[at] = t;
      peaks[at] = pk ? 1 : 0;
    }
  }
}
