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
// VMEM. Here one block takes a tile of RSP_C2D_TD Doppler rows by
// RSP_C2D_TR range cells and walks the map rows its Doppler window reaches,
// [d0 - a_d, d0 + RSP_C2D_TD - 1 + a_d] inside the map, RSP_C2D_RB rows at a
// time: it stages each row with range halos of a_r cells (zero outside the
// active range) in shared memory, takes the row's range sums over [-a_r, a_r]
// and [-g_r, g_r], and adds them to the Doppler sums each thread keeps in
// registers for its column and its RSP_C2D_TD / 2 rows. Shared memory is a
// fixed 32 KB whatever the Doppler reach, so every elaboration of the
// Doppler axis runs here; the sums are fp32 and direct (no prefix sum whose
// cancellation could grow with the map), added in ascending row order.
#pragma once

#include <cstdint>

#include "ca_cfar.cuh"

#define RSP_C2D_TD 16   // Doppler rows of a tile
#define RSP_C2D_TR 128  // range cells of a tile
#define RSP_C2D_RB 16   // map rows staged in shared memory at a time
// A staged row: the tile and its range halos, a_r <= RSP_PAD / 2 - 1 (the
// wrapper checks the range reach 2 * a_r + 2 <= RSP_PAD).
#define RSP_C2D_ROW (RSP_C2D_TR + RSP_PAD)
#define RSP_C2D_ROWS_PER_THREAD (RSP_C2D_TD * RSP_C2D_TR / RSP_THREADS)

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

// mag, thr: float32 [batch, p, n]; peaks: uint8 [batch, p, n]; n a multiple
// of RSP_C2D_TR; 0 <= active_lo <= active_hi <= n. Grid
// (batch * n / RSP_C2D_TR, ceil(p / RSP_C2D_TD)), RSP_THREADS threads.
static __global__ void __launch_bounds__(RSP_THREADS)
rsp_cfar2d_kernel(const float* __restrict__ mag, float* __restrict__ thr,
                  uint8_t* __restrict__ peaks, int p, int n, RspCfar2dRegs r) {
  __shared__ float plane[RSP_C2D_RB][RSP_C2D_ROW];  // staged rows, masked
  __shared__ float s_out[RSP_C2D_RB][RSP_C2D_TR];   // range sums, a_r
  __shared__ float s_in[RSP_C2D_RB][RSP_C2D_TR];    // range sums, g_r
  const int a_r = r.g_r + r.w_r, a_d = r.g_d + r.w_d;
  const int cols = RSP_C2D_TR + 2 * a_r;
  const int tiles_r = n / RSP_C2D_TR;
  const int r0 = (blockIdx.x % tiles_r) * RSP_C2D_TR;
  const int d0 = blockIdx.y * RSP_C2D_TD;
  const size_t base = (size_t)(blockIdx.x / tiles_r) * p * n;
  const int lo = r.active_lo, hi = r.active_hi;
  // this thread's column and its rows d0 + dl0 + k, k < ROWS_PER_THREAD
  const int c = threadIdx.x % RSP_C2D_TR;
  const int dl0 = (threadIdx.x / RSP_C2D_TR) * RSP_C2D_ROWS_PER_THREAD;

  float outer[RSP_C2D_ROWS_PER_THREAD], inner[RSP_C2D_ROWS_PER_THREAD];
#pragma unroll
  for (int k = 0; k < RSP_C2D_ROWS_PER_THREAD; ++k) outer[k] = inner[k] = 0.0f;

  const int s_lo = max(d0 - a_d, 0);
  const int s_hi = min(d0 + RSP_C2D_TD - 1 + a_d, p - 1);
  for (int s0 = s_lo; s0 <= s_hi; s0 += RSP_C2D_RB) {
    const int nr = min(RSP_C2D_RB, s_hi - s0 + 1);
    __syncthreads();  // the previous rows are summed
    for (int idx = threadIdx.x; idx < nr * cols; idx += blockDim.x) {
      const int j = idx / cols, cc = r0 - a_r + idx % cols;
      plane[j][idx % cols] =
          cc >= lo && cc < hi ? mag[base + (size_t)(s0 + j) * n + cc] : 0.0f;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nr * RSP_C2D_TR; idx += blockDim.x) {
      const int j = idx / RSP_C2D_TR, cc = idx % RSP_C2D_TR;
      const float* q = &plane[j][cc + a_r];
      float so = 0.0f, si = 0.0f;
      for (int k = -a_r; k <= a_r; ++k) so += q[k];
      for (int k = -r.g_r; k <= r.g_r; ++k) si += q[k];
      s_out[j][cc] = so;
      s_in[j][cc] = si;
    }
    __syncthreads();
    // each of this thread's rows takes the staged rows inside its windows
#pragma unroll
    for (int k = 0; k < RSP_C2D_ROWS_PER_THREAD; ++k) {
      const int d = d0 + dl0 + k - s0;
      float o = outer[k], i = inner[k];
      for (int j = max(d - a_d, 0); j <= min(d + a_d, nr - 1); ++j)
        o += s_out[j][c];
      for (int j = max(d - r.g_d, 0); j <= min(d + r.g_d, nr - 1); ++j)
        i += s_in[j][c];
      outer[k] = o;
      inner[k] = i;
    }
  }

  const int rr = r0 + c;
#pragma unroll
  for (int k = 0; k < RSP_C2D_ROWS_PER_THREAD; ++k) {
    const int d = d0 + dl0 + k;
    if (d >= p) continue;
    const size_t o = base + (size_t)d * n + rr;
    if (rr < lo || rr >= hi) {
      thr[o] = 0.0f;
      peaks[o] = 0;
      continue;
    }
    const float cnt =
        rsp_interval_count(rr, a_r, lo, hi) * rsp_interval_count(d, a_d, 0, p) -
        rsp_interval_count(rr, r.g_r, lo, hi) *
            rsp_interval_count(d, r.g_d, 0, p);
    const float t = rsp_threshold((outer[k] - inner[k]) / fmaxf(cnt, 1.0f),
                                  r.log_or_linear, r.scaler);
    const float m = mag[o];
    bool pk = m > t;
    if (pk && r.peak_grouping == 1) {
      for (int dd = -1; dd <= 1; ++dd) {
        for (int dr = -1; dr <= 1; ++dr) {
          const int nd = d + dd, nc = rr + dr;
          if ((dd || dr) && nd >= 0 && nd < p && nc >= lo && nc < hi &&
              !(m >= mag[base + (size_t)nd * n + nc]))
            pk = false;
        }
      }
    }
    thr[o] = t;
    peaks[o] = pk ? 1 : 0;
  }
}
