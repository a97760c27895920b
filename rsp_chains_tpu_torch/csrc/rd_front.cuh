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
// * rsp_rd_doppler_kernel, one block per channel and RSP_RD_COLS range
//   columns: each pulse's 32 columns are one coalesced 128-byte read per
//   plane. The window multiplies the pulses, a radix-2 DIT over P runs in
//   shared memory (P x 32 x 8 bytes, 128 KB at P = 512) with the 32 columns
//   of a butterfly in the 32 lanes of a warp, and the store writes row k as
//   the centred bin k - P/2 under fftshift, the DIV_N / SQRT_N scale folded.
//   Bound: device memory, 16 bytes a sample in and out (~0.08 ms at
//   64 x 256 x 1024); it runs at about three times that, its log2 P stages
//   each ending in a barrier. It and the scratch round trip go together
//   once a channel's CPI stays on chip (ROADMAP queue 2).
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

#define RSP_RD_COLS 32
#define RSP_RD_OUT_CFAR 0
#define RSP_RD_OUT_MAP 1
#define RSP_RD_OUT_MAG 2

// Launch 1: the windowed Doppler DFT of RSP_RD_COLS range columns of one
// channel. Grid (channels, N / RSP_RD_COLS). Static, as every kernel of
// this header: each source that includes it gets its own copy.
static __global__ void __launch_bounds__(RSP_THREADS)
rsp_rd_doppler_kernel(const float* __restrict__ re,
                      const float* __restrict__ im,
                      const float2* __restrict__ twp,
                      const float* __restrict__ win, float* __restrict__ yre,
                      float* __restrict__ yim, int log2p, int log2n,
                      float scale, int fft_shift) {
  extern __shared__ float smem[];
  const int p = 1 << log2p;
  const int n = 1 << log2n;
  float* xr = smem;                    // [p][RSP_RD_COLS], bit-reversed rows
  float* xi = smem + p * RSP_RD_COLS;
  const size_t base = (size_t)blockIdx.x * p * n + blockIdx.y * RSP_RD_COLS;

  for (int idx = threadIdx.x; idx < p * RSP_RD_COLS; idx += blockDim.x) {
    const int q = idx / RSP_RD_COLS, c = idx % RSP_RD_COLS;
    const int j = __brev(q) >> (32 - log2p);
    const size_t g = base + (size_t)q * n + c;
    const float wq = win[q];
    xr[j * RSP_RD_COLS + c] = re[g] * wq;
    xi[j * RSP_RD_COLS + c] = im[g] * wq;
  }
  __syncthreads();
  for (int s = 1; s <= log2p; ++s) {
    const int half = 1 << (s - 1);
    for (int idx = threadIdx.x; idx < (p / 2) * RSP_RD_COLS;
         idx += blockDim.x) {
      const int b = idx / RSP_RD_COLS, c = idx % RSP_RD_COLS;
      const int pos = b & (half - 1);
      const int i0 = (((b >> (s - 1)) << s) + pos) * RSP_RD_COLS + c;
      const int i1 = i0 + half * RSP_RD_COLS;
      const float2 w = twp[pos << (log2p - s)];
      const float br = xr[i1], bi = xi[i1];
      const float tr = fmaf(w.x, br, -w.y * bi);
      const float ti = fmaf(w.x, bi, w.y * br);
      const float ar = xr[i0], ai = xi[i0];
      xr[i0] = ar + tr;
      xi[i0] = ai + ti;
      xr[i1] = ar - tr;
      xi[i1] = ai - ti;
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < p * RSP_RD_COLS; idx += blockDim.x) {
    const int k = idx / RSP_RD_COLS, c = idx % RSP_RD_COLS;
    const int src = fft_shift ? (k + p / 2) & (p - 1) : k;
    const size_t g = base + (size_t)k * n + c;
    yre[g] = xr[src * RSP_RD_COLS + c] * scale;
    yim[g] = xi[src * RSP_RD_COLS + c] * scale;
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

// Shared memory of the two launches.
static inline size_t rsp_rd_doppler_smem(int log2p) {
  return (size_t)2 * (1 << log2p) * RSP_RD_COLS * sizeof(float);
}

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

// Launch 1 into (yre, yim), then launch 2 with output kOut. tw_n: the range
// pass twiddles; h: H in the forward output's order (kernels/rd.py). Returns
// the first CUDA error.
template <int kOut>
static inline int rsp_rd_launch(const float* re, const float* im, float* yre,
                                float* yim, float* o0, void* o1, int batch,
                                cudaStream_t stream, const float* tw_p,
                                const float* win, const float* tw_n,
                                const float* h, int log2p, int log2n,
                                float dop_scale, int fft_shift, RspCaRegs r) {
  const size_t s1 = rsp_rd_doppler_smem(log2p);
  cudaError_t e = rsp_opt_in(rsp_rd_doppler_kernel, s1);
  if (e != cudaSuccess) return (int)e;
  rsp_rd_doppler_kernel<<<dim3(batch, (1 << log2n) / RSP_RD_COLS),
                          RSP_THREADS, s1, stream>>>(
      re, im, reinterpret_cast<const float2*>(tw_p), win, yre, yim, log2p,
      log2n, dop_scale, fft_shift);
  e = cudaGetLastError();
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
