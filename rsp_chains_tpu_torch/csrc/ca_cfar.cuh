// Shared device functions of the CA-family chain kernels: the magnitude mux
// and the CA/GO/SO CFAR tail over one frame's magnitude row in shared memory.
//
// Replaces, in rsp_chains_tpu/kernels/cfar_pallas.py: `_magnitude` (:112) and
// the CA tails `_ca_cfar_body` (:153), `_ca_cfar_into` (:228) and
// `_ca_cfar_into_lean` (:310). Those build window sums from dyadic box sums
// and bit-decomposed lane rotations because Mosaic allows no unaligned lane
// slices; on the GPU a thread reads its window straight from shared memory,
// so only their result is kept: PARTIAL edges (cells outside the active range
// count as zero, the divider stays 2^divSum), CA = mean of the two sides, GO =
// max, SO = min, threshold = noise*scaler (linear) or noise+scaler (log),
// peaks = mag > thr inside the active range, optionally local maxima only.
#pragma once

#include <cstdint>
#include <math_constants.h>

// Zero margin on each side of the row: the wrappers check
// max_ref + max_guard + 1 <= RSP_PAD, so no window reaches past it.
#define RSP_PAD 128
#define RSP_THREADS 256

// The register file after the host clamps (see kernels/cfar.py,
// `ca_registers`), passed by value at launch: a register write never
// rebuilds or re-specialises the kernel.
struct RspCaRegs {
  int log2w;          // log2 of the reference window (<= 6)
  int guard;          // guard cells per side
  int div_sum;        // CA divider shift
  int cfar_mode;      // 1 GO, 2 SO, anything else CA
  int log_or_linear;  // 1 linear (scaler multiplies), else log (adds)
  int peak_grouping;  // 1: peaks must be local maxima
  int active_lo;      // active cells [active_lo, active_hi)
  int active_hi;
  int mag_mode;       // 0 abs, 1 sqr, 2 JPL, 3 log2(JPL); clipped on the host
  float scaler;
};

static __device__ __forceinline__ float rsp_magnitude(float re, float im,
                                                      int mode) {
  if (mode == 0) return sqrtf(re * re + im * im);
  if (mode == 1) return re * re + im * im;
  float ar = fabsf(re), ai = fabsf(im);
  float u = fmaxf(ar, ai), v = fminf(ar, ai);
  float jpl = fmaxf(u + v * 0.125f, u * 0.875f + v * 0.5f);
  if (mode == 2) return jpl;
  return log2f(fmaxf(jpl, 1e-30f));
}

// `row` points at shared memory holding [RSP_PAD zeros | mag[0..n) | RSP_PAD
// zeros], with mag already zeroed outside the active range. Every thread of
// the block takes cells tid, tid + blockDim.x, ...; the caller has
// synchronised after filling the row. Writes one frame of threshold and peaks.
static __device__ __forceinline__ void rsp_ca_tail(
    const float* __restrict__ row, int n, const RspCaRegs& r,
    float* __restrict__ thr, uint8_t* __restrict__ peaks) {
  const int w = 1 << r.log2w;
  const float inv_div = ldexpf(1.0f, -r.div_sum);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (i < r.active_lo || i >= r.active_hi) {
      thr[i] = 0.0f;
      peaks[i] = 0;
      continue;
    }
    const float* c = row + RSP_PAD + i;
    float lag = 0.0f, lead = 0.0f;
    for (int k = 1; k <= w; ++k) {
      lag += c[-r.guard - k];
      lead += c[r.guard + k];
    }
    const float s_lag = lag * inv_div, s_lead = lead * inv_div;
    float noise;
    if (r.cfar_mode == 1) noise = fmaxf(s_lag, s_lead);
    else if (r.cfar_mode == 2) noise = fminf(s_lag, s_lead);
    else noise = 0.5f * (s_lag + s_lead);
    const float t = r.log_or_linear == 1 ? noise * r.scaler : noise + r.scaler;
    const float m = c[0];
    bool pk = m > t;
    if (pk && r.peak_grouping == 1) {
      const float left = i - 1 >= r.active_lo ? c[-1] : -CUDART_INF_F;
      const float right = i + 1 < r.active_hi ? c[1] : -CUDART_INF_F;
      pk = m >= left && m >= right;
    }
    thr[i] = t;
    peaks[i] = pk ? 1 : 0;
  }
}
