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
// * rsp_rd_rows_kernel, one block per Doppler row of N: the forward FFT of
//   fft_radix2.cuh (bit-reversed load, natural spectrum), times H in
//   natural order, then the inverse by the conjugate trick through a DIF
//   (natural in, bit-reversed out, read back with __brev), scaled by 1/N.
//   It ends in the CA tail (Kernel H), the complex row (emit='map') or the
//   magnitude (Kernel J). A row is read whole into shared memory before it
//   is written, so the map and magnitude outputs may overwrite their input.
//
// Cost against the TPU kernel: the Doppler output makes one round trip
// through device memory, 16 bytes a sample, before the range launch reads
// it back. Every sum stays fp32 FMA (no tensor cores, no low precision): a
// single low-precision pass missed the accuracy bar on the TPU.
#pragma once

#include <cuda_runtime.h>

#include "ca_cfar.cuh"
#include "fft_radix2.cuh"

#define RSP_RD_COLS 32
#define RSP_RD_OUT_CFAR 0
#define RSP_RD_OUT_MAP 1
#define RSP_RD_OUT_MAG 2

// Radix-2 decimation-in-frequency stages over one frame in shared memory:
// natural order in, bit-reversed order out, xr/xi 2^log2n floats each.
// Every thread of the block takes part; starts and ends with
// __syncthreads().
static __device__ __forceinline__ void rsp_fft_dif_stages(
    const float2* __restrict__ tw, float* xr, float* xi, int log2n) {
  const int n = 1 << log2n;
  __syncthreads();
  for (int s = log2n; s >= 1; --s) {
    const int half = 1 << (s - 1);
    for (int b = threadIdx.x; b < n / 2; b += blockDim.x) {
      const int pos = b & (half - 1);
      const int i0 = ((b >> (s - 1)) << s) + pos;
      const int i1 = i0 + half;
      const float2 w = tw[pos << (log2n - s)];
      const float ar = xr[i0], ai = xi[i0];
      const float br = xr[i1], bi = xi[i1];
      const float dr = ar - br, di = ai - bi;
      xr[i0] = ar + br;
      xi[i0] = ai + bi;
      xr[i1] = fmaf(w.x, dr, -w.y * di);
      xi[i1] = fmaf(w.x, di, w.y * dr);
    }
    __syncthreads();
  }
}

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

// Launch 2: the matched filter along one Doppler row, then per kOut the CA
// tail (thr, peaks), the complex row (o0 = re, o1 = im) or the magnitude
// (o0). yre/yim may alias o0/o1. Grid (channels * P).
template <int kOut>
static __global__ void __launch_bounds__(RSP_THREADS)
rsp_rd_rows_kernel(const float* yre, const float* yim,
                   const float2* __restrict__ twn, const float* __restrict__ h,
                   float* o0, void* o1, int log2n, RspCaRegs r) {
  extern __shared__ float smem[];
  const int n = 1 << log2n;
  float* xr = smem;
  float* xi = smem + n;
  float* row = smem + 2 * n;  // [RSP_PAD | n | RSP_PAD], CA tail only
  const size_t base = (size_t)blockIdx.x * n;

  if (kOut == RSP_RD_OUT_CFAR) {
    for (int j = threadIdx.x; j < RSP_PAD; j += blockDim.x) {
      row[j] = 0.0f;
      row[RSP_PAD + n + j] = 0.0f;
    }
  }
  rsp_fft_radix2(yre + base, yim + base, twn, xr, xi, log2n);
  // conj(S * H): the inverse FFT as conj(FFT(conj(.))) / N
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float sr = xr[i], si = xi[i];
    const float hr = h[i], hi = h[n + i];
    xr[i] = fmaf(sr, hr, -si * hi);
    xi[i] = -fmaf(sr, hi, si * hr);
  }
  rsp_fft_dif_stages(twn, xr, xi, log2n);
  const float inv_n = ldexpf(1.0f, -log2n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = __brev(i) >> (32 - log2n);
    const float vr = xr[j] * inv_n, vi = -xi[j] * inv_n;
    if (kOut == RSP_RD_OUT_MAP) {
      o0[base + i] = vr;
      static_cast<float*>(o1)[base + i] = vi;
    } else if (kOut == RSP_RD_OUT_MAG) {
      o0[base + i] = rsp_magnitude(vr, vi, r.mag_mode);
    } else {
      const bool active = i >= r.active_lo && i < r.active_hi;
      row[RSP_PAD + i] = active ? rsp_magnitude(vr, vi, r.mag_mode) : 0.0f;
    }
  }
  if (kOut == RSP_RD_OUT_CFAR) {
    __syncthreads();
    rsp_ca_tail(row, n, r, o0 + base, static_cast<uint8_t*>(o1) + base);
  }
}

// Shared memory of the two launches.
static inline size_t rsp_rd_doppler_smem(int log2p) {
  return (size_t)2 * (1 << log2p) * RSP_RD_COLS * sizeof(float);
}

static inline size_t rsp_rd_rows_smem(int log2n) {
  return (size_t)(3 * (1 << log2n) + 2 * RSP_PAD) * sizeof(float);
}

// Launch 1 into (yre, yim), then launch 2 with output kOut. Returns the
// first CUDA error.
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
  const size_t s2 = rsp_rd_rows_smem(log2n);
  e = rsp_opt_in(rsp_rd_rows_kernel<kOut>, s2);
  if (e != cudaSuccess) return (int)e;
  rsp_rd_rows_kernel<kOut><<<batch * (1 << log2p), RSP_THREADS, s2, stream>>>(
      yre, yim, reinterpret_cast<const float2*>(tw_n), h, o0, o1, log2n, r);
  return (int)cudaGetLastError();
}
