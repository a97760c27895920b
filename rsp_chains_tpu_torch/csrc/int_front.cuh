// Shared device functions of the bit-true integer kernels (F and G on every
// route: the row plan of int_rows.cuh for N = 256-1024, int_mid.cu for
// 2048-16384, int_split.cu beyond): the register struct, the integer FFT
// butterfly, the integer magnitude, and the per-cell mode, threshold and
// peak test.
//
// Replaces, in rsp_chains_tpu/kernels/int_chain_pallas.py, `_int_front`
// (:131) and `_int_thr_peaks_tail` (:207), and the CA rows of
// `_int_chain_kernel` (:241). The arithmetic is the contract of
// rsp_chains_tpu/ops/bit_true.py, operation for operation:
//
// * FFT: radix-2 DIF over the natural-order frame, stage s on blocks of
//   m = n >> s: sum and difference of x[j] and x[j + m/2]; on a
//   non-expanding stage the RoundHalfUp halving (v + 1) >> 1, or on a keepLSB
//   stage the 16-bit wraparound trim; then the 1.15 twiddle (unity on the sum
//   side) rounded (p + 2^14) >> 15, in the 8-bit split form once a stage has
//   expanded; a keepLSB stage wraps the product too. The twiddle table tw
//   (kernels/int_chain.py `_int_twiddles`): row h + j holds the 1.15
//   (cos, sin) of W_{2h}^j, j < h, for every stage's half-block h. The
//   bins come out bit-reversed and each kernel stores bin __brev(cell).
// * magnitude 0: exact floor(sqrt) of the saturating square sum (a float seed
//   and integer corrections; sqrtf is IEEE, never built with fast math);
//   1: the square sum, saturated to INT32_MAX where it wraps; 2: JPL
//   shift-add.
// * CA: window sums (the run sums of row_fft.cuh `rsp_run_sums`, wrapping
//   uint32_t), `>> divSum` (arithmetic), the mode, the threshold
//   (noise * scaler_q + 32) >> 6 or noise + scaler_add, active masking and
//   peak grouping on raw magnitudes.
//
// XLA's int32 wraps and C++'s signed overflow is undefined, so every sum,
// difference and product that can wrap is done on uint32_t and converted
// back (rsp_wadd / rsp_wsub / rsp_wmul); right shifts of negative values are
// arithmetic in nvcc, as in XLA. The host passes the registers clamped
// (kernels/int_chain.py, `int_registers`): divSum in [0, 31] (XLA fills with
// the sign bit beyond), the scaler rounded half to even, the magnitude mode
// in 0..2.
#pragma once

#include <cstdint>

#include "ca_cfar.cuh"

#define RSP_PEAK_EDGE (-(1 << 30))  // a missing neighbour in peak grouping

// The register file of Kernels F and G, in the order of the JAX kernels'
// scalars (int_chain_pallas.py:482-494, :593-608), passed by value.
struct RspIntRegs {
  int log2w;          // log2 of the reference window (<= 6)
  int guard;          // guard cells per side
  int div_sum;        // CA divider shift, 0..31
  int cfar_mode;      // 1 GO, 2 SO, anything else CA (raw register)
  int log_or_linear;  // 1 linear (scaler_q multiplies), else log (adds)
  int peak_grouping;  // 1: peaks must be local maxima
  int n_active;       // active cells [0, n_active)
  int mag_mode;       // 0 abs, 1 sqr, 2 JPL
  int scaler_q;       // round(scaler * 64)
  int scaler_add;     // round(scaler)
  int algorithm;      // 1: side statistics are order statistics (Kernel G)
  int rank_lagg;      // ranks, clamped to [0, max_ref_window)
  int rank_lead;
};

static __device__ __forceinline__ int rsp_wadd(int a, int b) {
  return (int)((uint32_t)a + (uint32_t)b);
}
static __device__ __forceinline__ int rsp_wsub(int a, int b) {
  return (int)((uint32_t)a - (uint32_t)b);
}
static __device__ __forceinline__ int rsp_wmul(int a, int b) {
  return (int)((uint32_t)a * (uint32_t)b);
}

// ((v + 32768) & 0xFFFF) - 32768: the low 16 bits, sign-extended.
static __device__ __forceinline__ int rsp_wrap16(int v) {
  const int l = (int)((uint32_t)v & 0xFFFFu);
  return l >= 32768 ? l - 65536 : l;
}

// rhu(a*wa + b*wb, 15): direct, or in the 8-bit split form of
// ops.bit_true._rhu15_wide once the data has grown past 16 bits.
static __device__ __forceinline__ int rsp_rhu15_dot(int a, int b, int wa,
                                                    int wb, bool wide) {
  if (!wide)
    return rsp_wadd(rsp_wadd(rsp_wmul(a, wa), rsp_wmul(b, wb)), 1 << 14) >> 15;
  const int al = a & 255, ah = rsp_wsub(a, al) >> 8;
  const int bl = b & 255, bh = rsp_wsub(b, bl) >> 8;
  const int h = rsp_wadd(rsp_wmul(ah, wa), rsp_wmul(bh, wb));
  const int t = rsp_wadd(rsp_wadd(rsp_wmul(al, wa), rsp_wmul(bl, wb)), 1 << 14);
  return rsp_wadd(h, t >> 8) >> 7;
}

// One radix-2 DIF butterfly of the integer FFT on (a, b), in place: the
// wrapping sum and difference; on a non-expanding stage the RoundHalfUp
// halving, or on a keepLSB stage the 16-bit trim; the 1.15 twiddle w on the
// difference and unity on the sum, in the split form once the data has
// grown (an earlier or this stage expanded); a keepLSB stage trims again.
static __device__ __forceinline__ void rsp_int_butterfly(
    int& ar, int& ai, int& br, int& bi, int2 w, bool expanding, bool lsb,
    bool grown) {
  int sr = rsp_wadd(ar, br), si = rsp_wadd(ai, bi);
  int dr = rsp_wsub(ar, br), di = rsp_wsub(ai, bi);
  if (lsb) {
    sr = rsp_wrap16(sr);
    si = rsp_wrap16(si);
    dr = rsp_wrap16(dr);
    di = rsp_wrap16(di);
  } else if (!expanding) {
    sr = rsp_wadd(sr, 1) >> 1;
    si = rsp_wadd(si, 1) >> 1;
    dr = rsp_wadd(dr, 1) >> 1;
    di = rsp_wadd(di, 1) >> 1;
  }
  // the sum side's twiddle is unity, (32768, 0), multiplied all the same
  int yr0 = rsp_rhu15_dot(sr, si, 32768, 0, grown);
  int yi0 = rsp_rhu15_dot(sr, si, 0, 32768, grown);
  int yr1 = rsp_rhu15_dot(dr, di, w.x, rsp_wsub(0, w.y), grown);
  int yi1 = rsp_rhu15_dot(dr, di, w.y, w.x, grown);
  if (lsb) {
    yr0 = rsp_wrap16(yr0);
    yi0 = rsp_wrap16(yi0);
    yr1 = rsp_wrap16(yr1);
    yi1 = rsp_wrap16(yi1);
  }
  ar = yr0;
  ai = yi0;
  br = yr1;
  bi = yi1;
}

// |v| with INT32_MIN staying INT32_MIN, as jnp.abs does.
static __device__ __forceinline__ int rsp_iabs(int v) {
  return v < 0 ? rsp_wsub(0, v) : v;
}

// floor(sqrt(x)) for x >= 0: the float seed floor(sqrtf(x)) is within one of
// the root and <= 46340 for every int32, so s*s never overflows.
static __device__ __forceinline__ int rsp_isqrt(int x) {
  if (x <= 0) return 0;
  int s = (int)floorf(sqrtf((float)x));
  s = min(max(s, 1), 46340);
  for (int k = 0; k < 2; ++k) {
    if (s * s > x) s -= 1;
    s = max(s, 1);
  }
  for (int k = 0; k < 2; ++k) {
    const int nxt = s + 1;
    if (nxt <= 46340 && nxt * nxt <= x) s = nxt;
  }
  return s;
}

static __device__ __forceinline__ int rsp_int_magnitude(int re, int im,
                                                        int mode) {
  if (mode == 2) {
    const int ar = rsp_iabs(re), ai = rsp_iabs(im);
    const int u = max(ar, ai), v = min(ar, ai);
    return max(rsp_wadd(u, v >> 3), rsp_wadd(rsp_wsub(u, u >> 3), v >> 1));
  }
  int sq = rsp_wadd(rsp_wmul(re, re), rsp_wmul(im, im));
  if (sq < 0) sq = 0x7FFFFFFF;
  return mode == 1 ? sq : rsp_isqrt(sq);
}

// The noise of two side statistics: 1 GO, 2 SO, anything else the
// truncating mean (wrapping sum).
static __device__ __forceinline__ int rsp_int_combine(int mode, int s_lag,
                                                      int s_lead) {
  if (mode == 1) return max(s_lag, s_lead);
  if (mode == 2) return min(s_lag, s_lead);
  return rsp_wadd(s_lag, s_lead) >> 1;
}

// The threshold of a noise statistic: (noise * scaler_q + 32) >> 6
// (linear) or noise + scaler_add (log), wrapping.
static __device__ __forceinline__ int rsp_int_threshold(int noise,
                                                        const RspIntRegs& r) {
  return r.log_or_linear == 1
             ? rsp_wadd(rsp_wmul(noise, r.scaler_q), 1 << 5) >> 6
             : rsp_wadd(noise, r.scaler_add);
}

// Threshold and peak flag of the active cell i at `c` in the row (raw
// magnitudes; its left neighbour is active whenever it exists, its right one
// only below n_active).
static __device__ __forceinline__ void rsp_int_thr_peak(const int* c, int i,
                                                        int noise,
                                                        const RspIntRegs& r,
                                                        int& thr,
                                                        uint8_t& peak) {
  const int t = rsp_int_threshold(noise, r);
  const int m = c[0];
  bool pk = m > t;
  if (pk && r.peak_grouping == 1) {
    const int left = i >= 1 ? c[-1] : RSP_PEAK_EDGE;
    const int right = i + 1 < r.n_active ? c[1] : RSP_PEAK_EDGE;
    pk = m >= left && m >= right;
  }
  thr = t;
  peak = pk ? 1 : 0;
}
