// Shared device functions of the GOSCA kernels (C: mag_gos_cfar.cu, D:
// chain_gos.cu): the GOS / GOSCA / CASH CFAR tail over one range tile of a
// frame's magnitude row in shared memory.
//
// Replaces, in rsp_chains_tpu/kernels/cfar_pallas.py, the v3 GOS body
// `_gos_rows_init` (:1232) + `_gos_tail` (:1317). The TPU builds every
// window's sorted list with a sliding odd-even merge ladder of lane rotations
// because Mosaic allows no unaligned lane slices or per-lane gathers. On the
// GPU a thread reads its window straight from shared memory, so only the
// result is kept, in the semantics of the JAX package's plain `ops.cfar.cfar_op`:
//
// * rank statistic of a side: over the window's cells that lie inside
//   [active_lo, active_hi) (cells outside are EXCLUDED, not zeros), nv of
//   them, the min(rank, nv-1)-th smallest; 0 when nv = 0;
// * CASH statistic of a side: the least sum of sub_w consecutive cells that
//   lie wholly inside the active range and the reference window, divided by
//   sub_w; 0 when none fits (so 0 when sub_w > w); the sides combine by max;
// * CA sums with PARTIAL edges (cells outside the active range are zeros),
//   divided by 2^divSum;
// * the CA/GO/SO mode over the selected side statistics, the scaler, the
//   active-range mask and peak grouping of ca_cfar.cuh.
//
// Work sharing: the lag window of cell i starts at i-g-w and the lead window
// at i+g+1, so each statistic is computed once per window START and read by
// both sides; one pass of the selection finds both ranks.
//
// Bound on the H100: the selection. A rank is found by counting, for each
// candidate cell, the cells below and equal to it: up to w^2 shared-memory
// compares per window start (4096 at w = 64), against 13 bytes of device
// traffic per cell. This is the simple, exact form; a sliding sorted window
// would cut it to O(w) per start.
#pragma once

#include "ca_cfar.cuh"

// Kernel C's range tile: a block takes RSP_GOS_TILE cells of one frame and a
// RSP_PAD margin of magnitudes on each side.
#define RSP_GOS_TILE 256

// The register file in the order of the JAX package's `fused_mag_gos_cfar`
// scalars (cfar_pallas.py:1663-1677) plus the scaler, after the host clamps
// and resolves the elaboration (see kernels/cfar.py, `gos_registers`).
struct RspGosRegs {
  int log2w;          // log2 of the reference window (<= 6)
  int guard;          // guard cells per side
  int div_sum;        // CA divider shift
  int cfar_mode;      // 0 CA, 1 GO, 2 SO, 3 CASH (3 only where elaborated)
  int log_or_linear;  // 1 linear (scaler multiplies), else log (adds)
  int peak_grouping;  // 1: peaks must be local maxima
  int active_hi;      // active cells [active_lo, active_hi)
  int mag_mode;       // 0 abs, 1 sqr, 2 JPL, 3 log2(JPL); clipped on the host
  int algorithm;      // 1: side statistics are order statistics, 0: CA sums
  int rank_lagg;      // ranks, clamped to [0, max_ref_window)
  int rank_lead;
  int sub_w;          // CASH sub-window, clamped to [min_sub_window, wmax]
  int active_lo;
  float scaler;
};

// The k0-th and k1-th smallest of x[0 .. nv), 0 <= k0, k1 < nv, for float
// magnitudes (Kernels C, D) and int32 ones (Kernel G, chain_int_gos.cu).
// Value v is the k-th smallest exactly when (cells below v) <= k < (cells
// below v) + (cells equal to v).
template <typename T>
static __device__ __forceinline__ void rsp_select2(const T* x, int nv, int k0,
                                                   int k1, T& v0, T& v1) {
  bool f0 = false, f1 = false;
  v0 = v1 = x[0];
  for (int j = 0; j < nv && !(f0 && f1); ++j) {
    const T v = x[j];
    int below = 0, equal = 0;
    for (int m = 0; m < nv; ++m) {
      const T u = x[m];
      below += u < v;
      equal += u == v;
    }
    if (!f0 && below <= k0 && k0 < below + equal) {
      v0 = v;
      f0 = true;
    }
    if (!f1 && below <= k1 && k1 < below + equal) {
      v1 = v;
      f1 = true;
    }
  }
}

// `row`: shared memory [RSP_PAD | T | RSP_PAD] holding the magnitude of cells
// ts - RSP_PAD .. ts + T + RSP_PAD - 1, zero outside the active range (and
// outside the frame). `st0`, `st1`: shared scratch of T + 2*RSP_PAD floats
// each, indexed like `row` by window start. The caller has synchronised
// after filling the row. Writes threshold and peaks of cells ts .. ts+T-1 to
// thr[0 .. T) and peaks[0 .. T).
static __device__ __forceinline__ void rsp_gos_tail(
    const float* __restrict__ row, float* st0, float* st1, int ts, int T,
    const RspGosRegs& r, float* __restrict__ thr,
    uint8_t* __restrict__ peaks) {
  const int w = 1 << r.log2w, g = r.guard;
  const int lo = r.active_lo, hi = r.active_hi;
  const int base = ts - RSP_PAD;  // cell index of row[0]
  // the window starts the tile's cells read: lag windows from ts - g - w,
  // lead windows up to ts + T - 1 + g + 1
  const int s_lo = RSP_PAD - g - w, s_hi = RSP_PAD + T + g + 1;

  if (r.cfar_mode == 3) {
    const int sw = r.sub_w;
    if (sw <= w) {
      // st0[s]: sum of the sw cells from start s; +inf unless wholly active
      for (int s = s_lo + threadIdx.x; s < s_hi + w - sw; s += blockDim.x) {
        float sum = 0.0f;
        for (int k = 0; k < sw; ++k) sum += row[s + k];
        const int q = base + s;
        st0[s] = q >= lo && q + sw <= hi ? sum : CUDART_INF_F;
      }
      __syncthreads();
    }
    // st1[s]: least sub-window mean inside the window [s, s + w)
    for (int s = s_lo + threadIdx.x; s < s_hi; s += blockDim.x) {
      float m = CUDART_INF_F;
      for (int t = 0; t <= w - sw; ++t) m = fminf(m, st0[s + t]);
      st1[s] = m < CUDART_INF_F ? m / (float)max(sw, 1) : 0.0f;
    }
  } else if (r.algorithm == 1) {
    // st0[s] / st1[s]: the lag / lead rank statistic of the window [s, s + w)
    for (int s = s_lo + threadIdx.x; s < s_hi; s += blockDim.x) {
      const int a = max(base + s, lo), b = min(base + s + w, hi);
      const int nv = b - a;
      float v0 = 0.0f, v1 = 0.0f;
      if (nv > 0)
        rsp_select2(row + (a - base), nv, min(r.rank_lagg, nv - 1),
                    min(r.rank_lead, nv - 1), v0, v1);
      st0[s] = v0;
      st1[s] = v1;
    }
  }
  __syncthreads();

  const float inv_div = ldexpf(1.0f, -r.div_sum);
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    const int i = ts + j;
    if (i < lo || i >= hi) {
      thr[j] = 0.0f;
      peaks[j] = 0;
      continue;
    }
    const int s = RSP_PAD + j;
    const float* c = row + s;
    float noise;
    if (r.cfar_mode == 3) {
      noise = fmaxf(st1[s - g - w], st1[s + g + 1]);
    } else {
      float s_lag, s_lead;
      if (r.algorithm == 1) {
        s_lag = st0[s - g - w];
        s_lead = st1[s + g + 1];
      } else {
        float lag, lead;
        rsp_ca_sums(c, g, w, lag, lead);
        s_lag = lag * inv_div;
        s_lead = lead * inv_div;
      }
      noise = rsp_combine(r.cfar_mode, s_lag, s_lead);
    }
    const float t = rsp_threshold(noise, r.log_or_linear, r.scaler);
    thr[j] = t;
    peaks[j] = rsp_peak(c, i, t, r.peak_grouping, lo, hi);
  }
}
