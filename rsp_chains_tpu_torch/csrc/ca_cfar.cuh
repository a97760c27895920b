// Shared device functions of the chain kernels: the magnitude mux and the
// CFAR epilogue pieces (window sums, mode, scaler, peak test) of the GOSCA
// kernels' tails (gos_cfar.cuh); the run-sum CA tail of Kernels A, B, E, H
// and I is row_fft.cuh's.
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

// Lets `kernel` take `smem` bytes of dynamic shared memory, opting in above
// the 48 KB default.
template <typename K>
static inline cudaError_t rsp_opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

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

// Window sums around the cell at `c`: lag = c[-guard-w .. -guard-1], lead =
// c[guard+1 .. guard+w].
static __device__ __forceinline__ void rsp_ca_sums(const float* c, int guard,
                                                   int w, float& lag,
                                                   float& lead) {
  lag = 0.0f;
  lead = 0.0f;
  for (int k = 1; k <= w; ++k) {
    lag += c[-guard - k];
    lead += c[guard + k];
  }
}

// The noise of two side statistics under the mode register: 1 GO, 2 SO,
// anything else CA.
static __device__ __forceinline__ float rsp_combine(int mode, float s_lag,
                                                    float s_lead) {
  if (mode == 1) return fmaxf(s_lag, s_lead);
  if (mode == 2) return fminf(s_lag, s_lead);
  return 0.5f * (s_lag + s_lead);
}

static __device__ __forceinline__ float rsp_threshold(float noise,
                                                      int log_or_linear,
                                                      float scaler) {
  return log_or_linear == 1 ? noise * scaler : noise + scaler;
}

// Whether the active cell i, at `c` in the row, is a peak against threshold
// t; with grouping it must also be a local maximum, a neighbour outside the
// active range counting as -inf.
static __device__ __forceinline__ uint8_t rsp_peak(const float* c, int i,
                                                   float t, int grouping,
                                                   int lo, int hi) {
  const float m = c[0];
  bool pk = m > t;
  if (pk && grouping == 1) {
    const float left = i - 1 >= lo ? c[-1] : -CUDART_INF_F;
    const float right = i + 1 < hi ? c[1] : -CUDART_INF_F;
    pk = m >= left && m >= right;
  }
  return pk ? 1 : 0;
}
