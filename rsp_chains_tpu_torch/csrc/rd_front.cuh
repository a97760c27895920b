// The range-Doppler front of Kernels H (rd_ca.cu) and J (rd_2d.cu): the
// Doppler transform over the pulses of each CPI, then, per Doppler row, the
// circular matched filter along range.
//
// Replaces the front of rsp_chains_tpu/kernels/rd_pallas.py (`_rd_front`
// :251, with `_mf_rows` :230, `_dot_left` :199 and the host constants
// `_h_block` :126 and `_doppler_triple` :163). The TPU kernel holds one
// channel's whole CPI [P, N] in VMEM, runs the matched filter along range
// first and the Doppler DFT as one [P, P] matmul. A CPI at P = 256,
// N = 1024 is 2 MiB of complex fp32, far past one block's 227 KB of shared
// memory, so this front splits it into two launches. The matched filter
// (along range) and the Doppler transform (along pulses) are linear maps on
// different axes, so they commute: the Doppler transform goes first, and the
// range launch can then end in the magnitude and the CFAR.
//
// * rsp_rd_doppler_kernel, the column plan (RspColPlan) over P = 8 ... 512
//   pulses: each thread holds 16 pulses (8 at P = 8) of one range column in
//   registers, and the lanes of a warp are 32 consecutive columns, so every
//   pulse's read and write is one coalesced 128-byte line per plane. The
//   window multiplies on the load. The transform runs as the row plan's
//   passes (row_fft.cuh: `rsp_dft`, `rsp_twiddle`, the float64-rounded pass
//   twiddles of kernels/chain.py `row_twiddles` at n = P) over the radices
//   8; 16; 16 x 2; 16 x 4; 16 x 8; 16 x 16; 16 x 16 x 2, with only a
//   transpose through shared memory between passes (P / 16 warps a column
//   strip, [P][32] floats a plane, no bank conflicts): no barrier at P <= 16,
//   one up to 256, two at 512. The output is digit-reversed in the
//   registers, so each slot is stored straight to its bin's row (fftshift
//   and the DIV_N / SQRT_N scale folded into that store), still coalesced
//   across the lanes: no bit or digit reversal anywhere.
//   Bound: device memory, 16 bytes a sample in and out (~0.08 ms at
//   64 x 256 x 1024). The scratch round trip goes once a channel's CPI
//   stays on chip (ROADMAP queue 2).
// * rsp_rd_rows_kernel, the row plan of row_fft.cuh (N / 16 threads a
//   Doppler row of N = 256, 512, 1024, 16 cells a thread): the forward
//   transform (`rsp_row_forward`) leaves the spectrum digit-reversed; it is
//   multiplied by H in that same order (the host permutes H once,
//   kernels/chain.py `row_order`, kernels/rd.py `h_rows`); the inverse is the
//   adjoint of each pass in reverse order (conjugate twiddles, then conjugate
//   DFTs), digit-reversed order in and natural order out, times 1/N. No bit
//   reversal anywhere. The last forward pass and the first inverse one share
//   their cells, so H's product stays in registers: 2 barriers a row pair at
//   N = 256, 4 at 512 and 1024, against 20 radix-2 stages before. The row
//   ends in the CA tail (Kernel H, `rsp_ca_row`), the complex row
//   (emit='map') or the magnitude (Kernel J). Every cell of a row is read
//   before a barrier that comes before any write of it, so the map and
//   magnitude outputs may overwrite their input.
//   Bound: device memory, 8 bytes a sample in and 5 (CA), 8 (map) or 4
//   (magnitude) out; the two FFTs' ~1.7e9 flops at 64 x 256 x 1024 take
//   ~0.025 ms at the fp32 rate.
#pragma once

#include <cuda_runtime.h>

#include "row_fft.cuh"

#define RSP_RD_OUT_CFAR 0
#define RSP_RD_OUT_MAP 1
#define RSP_RD_OUT_MAG 2

// ---- Launch 1: the Doppler columns ----

// The column plan of kP pulses: kT threads a column (one warp each, the
// lanes 32 consecutive columns), kL pulses a thread; pass 1 is radix kL at
// stride kT, then (kT > 1) radix 16 at stride kM2 inside blocks of kT cells
// (kM2 > 1: P = 512 only) and radix kLast over contiguous groups: the row
// plan's passes (row_fft.cuh) with the cells down a column. kStrips strips
// of 32 columns a block, kThreads threads, at most 64 registers a thread
// (1024 threads an SM).
template <int kP>
struct RspColPlan {
  static_assert(kP >= 8 && kP <= 512 && (kP & (kP - 1)) == 0,
                "the column plan takes P = 8 ... 512");
  static constexpr int kT = kP >= 16 ? kP / 16 : 1;
  static constexpr int kL = kP >= 16 ? 16 : kP;
  static constexpr int kM2 = kT > 16 ? kT / 16 : 1;
  static constexpr int kLast = kM2 > 1 ? kM2 : kT;  // the last pass's radix
  static constexpr int kStrips = kT >= 8 ? 1 : 8 / kT;
  static constexpr int kThreads = 32 * kT * kStrips;
  static constexpr int kBlocks = 1024 / kThreads;
  static constexpr int kCols = 32 * kStrips;
  // floats of shared memory: two [kP][32] planes a strip, none at kT = 1
  static constexpr int kSmem = kT > 1 ? kStrips * 2 * kP * 32 : 0;
};

// Launch 1: the windowed Doppler DFT of the range columns of one channel,
// 32 columns a strip, kStrips strips a block. Grid (channels, N / kCols).
// tw: `row_twiddles(P)` (W_P^(m k) at [k kT + m], then at P = 512 W_32^(m k)
// at [P + 2 k + m]); win: [P]. Static, as every kernel of this header: each
// source that includes it gets its own copy.
template <int kP>
static __global__ void __launch_bounds__(RspColPlan<kP>::kThreads,
                                         RspColPlan<kP>::kBlocks)
rsp_rd_doppler_kernel(const float* __restrict__ re,
                      const float* __restrict__ im,
                      const float2* __restrict__ tw,
                      const float* __restrict__ win, float* __restrict__ yre,
                      float* __restrict__ yim, int n, float scale,
                      int fft_shift) {
  using P = RspColPlan<kP>;
  constexpr int T = P::kT, L = P::kL, M2 = P::kM2;
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m = warp % T, strip = warp / T;
  const size_t col = (size_t)blockIdx.x * kP * n +
                     (size_t)blockIdx.y * P::kCols + strip * 32 + lane;
  float xr[16], xi[16];
  // pass 1: pulses m + T j, windowed on the load
  const float* pr = re + col + (size_t)m * n;
  const float* pi = im + col + (size_t)m * n;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const float w = __ldg(win + m + T * j);
    xr[j] = __ldg(pr + (size_t)T * j * n) * w;
    xi[j] = __ldg(pi + (size_t)T * j * n) * w;
  }
  rsp_dft<L, false>(xr, xi);
  if constexpr (T > 1) {
    // slot k: cell m + T k; a strip's planes [kP][32], a cell a row
    float* sr = smem + strip * 2 * kP * 32 + lane;
    float* si = sr + kP * 32;
    rsp_twiddle<false>(xr, xi, tw + m, T);
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      sr[(m + T * k) * 32] = xr[k];
      si[(m + T * k) * 32] = xi[k];
    }
    __syncthreads();
    if constexpr (M2 > 1) {
      // pass 2: radix 16 at stride M2 inside a block of T cells
      const int m2 = m % M2, b2 = T * (m / M2) + m2;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        xr[k] = sr[(b2 + M2 * k) * 32];
        xi[k] = si[(b2 + M2 * k) * 32];
      }
      rsp_dft<16, false>(xr, xi);
      rsp_twiddle<false>(xr, xi, tw + kP + m2, M2);
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        sr[(b2 + M2 * k) * 32] = xr[k];
        si[(b2 + M2 * k) * 32] = xi[k];
      }
      __syncthreads();
    }
    // the last pass: radix kLast over the contiguous groups of 16 m ..
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      xr[k] = sr[(16 * m + k) * 32];
      xi[k] = si[(16 * m + k) * 32];
    }
#pragma unroll
    for (int j = 0; j < 16; j += P::kLast)
      rsp_dft<P::kLast, false>(xr + j, xi + j);
  }
  // slot j: cell p = 16 m + j (j at T = 1), which holds bin
  // p / T + 16 (p % T / M2) + 256 (p % M2); stored at its row, shifted
  const int p0 = T > 1 ? 16 * m : 0;
  const int half = fft_shift ? kP / 2 : 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const int p = p0 + j;
    const int bin = p / T + 16 * (p % T / M2) + 256 * (p % M2);
    const size_t o = col + (size_t)((bin + half) & (kP - 1)) * n;
    yre[o] = xr[j] * scale;
    yim[o] = xi[j] * scale;
  }
}

// ---- Launch 2: the range rows ----

// Launch 2: the matched filter along each Doppler row of kN cells, then per
// kOut the CA tail (thr = o0, peaks = o1), the complex row (o0 = re,
// o1 = im) or the magnitude (o0). `tw`: the pass twiddles of `row_twiddles`
// (kernels/chain.py); `h`: H's [2, kN] planes in the forward output's
// digit-reversed order. yre/yim may alias o0/o1. Grid ceil(rows / kRows).
// Two blocks an SM: unbounded, the unrolled passes take ~170 registers a
// thread and one block an SM; at 128 a few slots spill and the launch runs
// faster for the second block's overlap.
template <int kN, int kOut>
static __global__ void __launch_bounds__(RSP_THREADS, 2)
rsp_rd_rows_kernel(const float* yre, const float* yim,
                   const float2* __restrict__ tw, const float* __restrict__ h,
                   float* o0, void* o1, int rows, RspCaRegs r) {
  using P = RspRowPlan<kN>;
  constexpr int T = P::kT, M2 = P::kM2;
  extern __shared__ float smem[];
  const int q = threadIdx.x / T, m = threadIdx.x % T;
  const int row = blockIdx.x * P::kRows + q;
  const bool live = row < rows;
  const size_t base = (size_t)row * kN;
  float* pr = smem + q * P::kS;  // this row's planes of the FFT buffer
  float* pi = pr + P::kRows * P::kS;
  float xr[16], xi[16];

  rsp_row_forward<kN>(yre, yim, base, live, m, tw, pr, pi, xr, xi);
  const int m2 = m % M2, b2 = T * (m / M2) + m2;
  // slot j holds the spectrum's cell 16 m + j: times H in the same order
  const float4* hr = reinterpret_cast<const float4*>(h + 16 * m);
  const float4* hi = reinterpret_cast<const float4*>(h + kN + 16 * m);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 a = __ldg(hr + j), b = __ldg(hi + j);
    rsp_cmul<false>(xr[4 * j], xi[4 * j], make_float2(a.x, b.x));
    rsp_cmul<false>(xr[4 * j + 1], xi[4 * j + 1], make_float2(a.y, b.y));
    rsp_cmul<false>(xr[4 * j + 2], xi[4 * j + 2], make_float2(a.z, b.z));
    rsp_cmul<false>(xr[4 * j + 3], xi[4 * j + 3], make_float2(a.w, b.w));
  }
  // the inverse: the passes' adjoints in reverse order
  if constexpr (M2 > 1) {
#pragma unroll
    for (int j = 0; j < 16; j += M2) rsp_dft<M2, true>(xr + j, xi + j);
    rsp_put(pr, pi, 16 * m, 1, xr, xi);
    __syncthreads();
    rsp_get(pr, pi, b2, M2, xr, xi);
    rsp_twiddle<true>(xr, xi, tw + kN + m2, M2);
  }
  rsp_dft<16, true>(xr, xi);
  rsp_put(pr, pi, b2, M2, xr, xi);
  __syncthreads();
  rsp_get(pr, pi, m, T, xr, xi);
  rsp_twiddle<true>(xr, xi, tw + m, T);
  rsp_dft<16, true>(xr, xi);
  // slot j: cell m + T j of the filtered row, times 1/N
  const float inv_n = 1.0f / kN;
  if constexpr (kOut == RSP_RD_OUT_CFAR) {
    float* rw = smem + 2 * P::kRows * P::kS + q * P::kMagS;
    for (int j = m; j < RSP_PAD; j += T) {
      rw[rsp_mag_slot(j)] = 0.0f;
      rw[rsp_mag_slot(RSP_PAD + kN + j)] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = m + T * j;
      const bool active = i >= r.active_lo && i < r.active_hi;
      rw[rsp_mag_slot(RSP_PAD + i)] =
          active ? rsp_magnitude(xr[j] * inv_n, xi[j] * inv_n, r.mag_mode)
                 : 0.0f;
    }
    __syncthreads();
    if (!live) return;
    rsp_ca_row(rw, m, r, o0 + base, static_cast<uint8_t*>(o1) + base);
    return;
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const size_t i = base + m + T * j;
    if (kOut == RSP_RD_OUT_MAP) {
      o0[i] = xr[j] * inv_n;
      static_cast<float*>(o1)[i] = xi[j] * inv_n;
    } else {
      o0[i] = rsp_magnitude(xr[j] * inv_n, xi[j] * inv_n, r.mag_mode);
    }
  }
}

// Launch 1 at kP pulses over rows of n cells.
template <int kP>
static inline cudaError_t rsp_rd_doppler(const float* re, const float* im,
                                         float* yre, float* yim, int batch,
                                         int n, cudaStream_t stream,
                                         const float* tw, const float* win,
                                         float scale, int fft_shift) {
  using P = RspColPlan<kP>;
  const size_t smem = (size_t)P::kSmem * sizeof(float);
  cudaError_t e = rsp_opt_in(rsp_rd_doppler_kernel<kP>, smem);
  if (e != cudaSuccess) return e;
  rsp_rd_doppler_kernel<kP><<<dim3(batch, n / P::kCols), P::kThreads, smem,
                              stream>>>(
      re, im, reinterpret_cast<const float2*>(tw), win, yre, yim, n, scale,
      fft_shift);
  return cudaGetLastError();
}

// Shared memory of the range-row launch.
template <int kN, int kOut>
static inline size_t rsp_rd_rows_smem() {
  using P = RspRowPlan<kN>;
  return (size_t)P::kRows *
         (2 * P::kS + (kOut == RSP_RD_OUT_CFAR ? P::kMagS : 0)) *
         sizeof(float);
}

// Launch 2 for a row of kN cells over `rows` rows.
template <int kN, int kOut>
static inline cudaError_t rsp_rd_rows(const float* yre, const float* yim,
                                      const float* tw, const float* h,
                                      float* o0, void* o1, int rows,
                                      cudaStream_t stream, RspCaRegs r) {
  const size_t smem = rsp_rd_rows_smem<kN, kOut>();
  cudaError_t e = rsp_opt_in(rsp_rd_rows_kernel<kN, kOut>, smem);
  if (e != cudaSuccess) return e;
  constexpr int kRows = RspRowPlan<kN>::kRows;
  rsp_rd_rows_kernel<kN, kOut><<<(rows + kRows - 1) / kRows, RSP_THREADS,
                                 smem, stream>>>(
      yre, yim, reinterpret_cast<const float2*>(tw), h, o0, o1, rows, r);
  return cudaGetLastError();
}

// Launch 1 into (yre, yim), then launch 2 with output kOut. tw_p: the
// column plan's pass twiddles (`row_twiddles(P)`); tw_n: the range pass
// twiddles; h: H in the forward output's order (kernels/rd.py). Returns the
// first CUDA error.
template <int kOut>
static inline int rsp_rd_launch(const float* re, const float* im, float* yre,
                                float* yim, float* o0, void* o1, int batch,
                                cudaStream_t stream, const float* tw_p,
                                const float* win, const float* tw_n,
                                const float* h, int log2p, int log2n,
                                float dop_scale, int fft_shift, RspCaRegs r) {
  using Doppler = cudaError_t (*)(const float*, const float*, float*, float*,
                                  int, int, cudaStream_t, const float*,
                                  const float*, float, int);
  static constexpr Doppler kDoppler[] = {
      rsp_rd_doppler<8>,   rsp_rd_doppler<16>,  rsp_rd_doppler<32>,
      rsp_rd_doppler<64>,  rsp_rd_doppler<128>, rsp_rd_doppler<256>,
      rsp_rd_doppler<512>};
  if (log2p < 3 || log2p > 9) return (int)cudaErrorInvalidValue;
  cudaError_t e = kDoppler[log2p - 3](re, im, yre, yim, batch, 1 << log2n,
                                      stream, tw_p, win, dop_scale,
                                      fft_shift);
  if (e != cudaSuccess) return (int)e;
  const int rows = batch << log2p;
  switch (log2n) {
    case 8:
      return (int)rsp_rd_rows<256, kOut>(yre, yim, tw_n, h, o0, o1, rows,
                                         stream, r);
    case 9:
      return (int)rsp_rd_rows<512, kOut>(yre, yim, tw_n, h, o0, o1, rows,
                                         stream, r);
    case 10:
      return (int)rsp_rd_rows<1024, kOut>(yre, yim, tw_n, h, o0, o1, rows,
                                          stream, r);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
