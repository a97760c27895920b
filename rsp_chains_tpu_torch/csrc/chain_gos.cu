// Kernel D: the whole GOSCA chain, FFT -> scale -> magnitude -> GOS / GOSCA /
// CASH CFAR, over frames of N = 256, 512 or 1024.
//
// Replaces rsp_chains_tpu/kernels/chain_pallas.py::fused_chain_gos (:1221,
// pallas_call :1306; body `_chain_gos_kernel` :1172). The spectrum, the
// magnitude row and the statistics never leave shared memory: one read of
// the IQ pair, one write of threshold and peaks, 13 bytes a sample.
//
// Bound on the H100: device memory for the function (0.065 ms at 64 x 256
// frames of 1024); the kernel is held by the rank selection's pipe to shared
// memory and shuffles (gos_rows.cuh): 0.31 of its 0.44 ms at w = 32.
//
// Design (rsp_chain_gos_rows_kernel<N>): Kernel A's front on the row plan of
// row_fft.cuh, N / 16 threads a frame, 256 / (N / 16) frames a block, the
// forward transform in radix-16 passes in registers with 1 or 2 barriers,
// each thread's 16 bins scaled and their magnitudes scattered to their
// natural bins of the frame's padded row (`rsp_row_bin`); pass 1 reads device
// memory coalesced. Then, by the registers:
//
// * GOS (algorithm 1): the warp-resident sliding sorted window of
//   gos_cfar.cuh over the block's frames (gos_rows.cuh): the ranks are kept
//   by cell in the frame's two FFT planes; each thread reads the two ranks
//   of its cells m + (N / 16) k and writes their thresholds and peaks, a
//   warp's stores coalesced.
// * CASH (mode 3): each thread sums the sub_w cells from each of its cells
//   (+inf unless wholly active) into the frame's first plane, in the order
//   of the frame-per-block kernel; then each cell takes the least of the
//   sums whose sub-windows lie in its lag and its lead window.
// * CA sums (algorithm 0, which the chain sends to Kernel A, and
//   chip_smoke.py times against GOS to see the selection alone): Kernel A's
//   run-sum tail (`rsp_ca_row`).
//
// Shared memory: the FFT planes and the magnitude rows, as Kernel A but for
// 16 floats between rows (RspGosRows), 55,552 bytes a block at N = 1024;
// three blocks an SM (RSP_ROWS_BLOCKS, chip_smoke.py `row_blocks` times 1
// to 4). No thread returns before the selection's last barrier: a dead
// frame's threads work for the live ones. After its tail a warp counts the
// peaks its live lanes stored (rsp_count_cells).
#include <cuda_runtime.h>

#include "gos_rows.cuh"

// The thresholds and peaks of a frame's cells m + kT j (j < 16), one
// thread's, from their noise statistics noise(cell): the scaler, the active
// mask and peak grouping on the magnitude row rw (rsp_mag_slot).
template <int kT, typename Noise>
static __device__ __forceinline__ void rsp_gos_cells(const float* rw, int m,
                                                     const RspGosRegs& r,
                                                     const Noise& noise,
                                                     float* __restrict__ thr,
                                                     uint8_t* __restrict__ pk) {
  const int lo = r.active_lo, hi = r.active_hi;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int i = m + kT * j;
    const float th = rsp_threshold(noise(i), r.log_or_linear, r.scaler);
    const float v = rw[rsp_mag_slot(RSP_PAD + i)];
    bool p = v > th;
    if (p && r.peak_grouping == 1) {
      const float left = i - 1 >= lo ? rw[rsp_mag_slot(RSP_PAD + i - 1)]
                                     : -CUDART_INF_F;
      const float right = i + 1 < hi ? rw[rsp_mag_slot(RSP_PAD + i + 1)]
                                     : -CUDART_INF_F;
      p = v >= left && v >= right;
    }
    const bool active = i >= lo && i < hi;
    thr[i] = active ? th : 0.0f;
    pk[i] = active && p ? 1 : 0;
  }
}

// Kernel D over `frames` frames of kN cells. tw: the pass twiddles of
// kernels/chain.py `row_twiddles(kN)`; count: the counter the frames' peaks
// are added to, or null. Grid ceil(frames / kRows).
template <int kN>
__global__ void __launch_bounds__(RSP_THREADS, RSP_ROWS_BLOCKS)
rsp_chain_gos_rows_kernel(const float* __restrict__ re,
                          const float* __restrict__ im,
                          const float2* __restrict__ tw,
                          float* __restrict__ thr, uint8_t* __restrict__ peaks,
                          int frames, float scale, RspGosRegs r,
                          unsigned long long* count) {
  using P = RspRowPlan<kN>;
  constexpr int T = P::kT;
  extern __shared__ float smem[];
  const int q = threadIdx.x / T, m = threadIdx.x % T;
  const int row = blockIdx.x * P::kRows + q;
  const bool live = row < frames;
  const size_t base = (size_t)row * kN;
  float* pr = smem + q * P::kS;  // this frame's planes of the FFT buffer
  float* pi = pr + P::kRows * P::kS;
  float* rw = smem + 2 * P::kRows * P::kS + q * RspGosRows<kN>::kMag;
  float xr[16], xi[16];

  rsp_row_forward<kN>(re, im, base, live, m, tw, pr, pi, xr, xi);
  for (int j = m; j < RSP_PAD; j += T) {
    rw[rsp_mag_slot(j)] = 0.0f;
    rw[rsp_mag_slot(RSP_PAD + kN + j)] = 0.0f;
  }
  const int lo = r.active_lo, hi = r.active_hi;
  // slot j holds the cell 16 m + j of the digit-reversed spectrum
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int k = rsp_row_bin<kN>(16 * m + j);
    rw[rsp_mag_slot(RSP_PAD + k)] =
        k >= lo && k < hi
            ? rsp_magnitude(xr[j] * scale, xi[j] * scale, r.mag_mode)
            : 0.0f;
  }
  __syncthreads();  // the magnitude rows are whole; the planes are dead

  const int w = 1 << r.log2w, g = r.guard;
  float* out = thr + base;
  uint8_t* pk = peaks + base;
  if (r.cfar_mode == 3) {
    // pr[u]: the sum of the sw cells from cell u, +inf unless they all lie
    // in the active range
    const int sw = r.sub_w;
    if (live) {
      for (int u = m; u < kN; u += T) {
        float sum = CUDART_INF_F;
        if (u >= lo && u + sw <= hi) {
          sum = 0.0f;
          for (int k = 0; k < sw; ++k)
            sum += rw[rsp_mag_slot(RSP_PAD + u + k)];
        }
        pr[u] = sum;
      }
    }
    __syncthreads();
    if (!live) return;
    // the least mean of a wholly active sub-window inside the window of w
    // cells from cell u0; 0 where none fits
    const auto cash = [&](int u0) {
      float mn = CUDART_INF_F;
      const int t1 = min(w - sw, hi - sw - u0);
      for (int t = max(0, lo - u0); t <= t1; ++t) mn = fminf(mn, pr[u0 + t]);
      return mn < CUDART_INF_F ? mn / (float)max(sw, 1) : 0.0f;
    };
    rsp_gos_cells<T>(rw, m, r, [&](int i) {
      return fmaxf(cash(i - g - w), cash(i + g + 1));
    }, out, pk);
    rsp_count_cells<T>(count, pk, m, rsp_live_lanes<T, P::kRows>(frames));
  } else if (r.algorithm == 1) {
    const int rows = min(P::kRows, frames - (int)blockIdx.x * P::kRows);
    rsp_gos_rows_stats<kN>(smem, rows, w, g, lo, hi, r.rank_lagg,
                           r.rank_lead);
    __syncthreads();
    if (!live) return;
    rsp_gos_cells<T>(rw, m, r, [&](int i) {
      return rsp_combine(r.cfar_mode, pr[i], pi[i]);
    }, out, pk);
    rsp_count_cells<T>(count, pk, m, rsp_live_lanes<T, P::kRows>(frames));
  } else {
    if (!live) return;
    const RspCaRegs ca{r.log2w,         r.guard,         r.div_sum,
                       r.cfar_mode,     r.log_or_linear, r.peak_grouping,
                       r.active_lo,     r.active_hi,     r.mag_mode,
                       r.scaler};
    rsp_ca_row(rw, m, ca, out, pk);
    rsp_count_cells<16>(count, pk, m, rsp_live_lanes<T, P::kRows>(frames));
  }
}

template <int kN>
static int rsp_chain_gos_rows(const float* re, const float* im, float* thr,
                              uint8_t* peaks, int frames, cudaStream_t stream,
                              const float* tw, float scale, RspGosRegs regs,
                              unsigned long long* count) {
  using P = RspRowPlan<kN>;
  const size_t smem = (size_t)RspGosRows<kN>::kFloats * sizeof(float);
  const cudaError_t e = rsp_opt_in(rsp_chain_gos_rows_kernel<kN>, smem);
  if (e != cudaSuccess) return (int)e;
  rsp_chain_gos_rows_kernel<kN><<<(frames + P::kRows - 1) / P::kRows,
                                  RSP_THREADS, smem, stream>>>(
      re, im, reinterpret_cast<const float2*>(tw), thr, peaks, frames, scale,
      regs, count);
  return (int)cudaGetLastError();
}

// re, im, thr: float32 [frames, 2^log2n]; peaks: uint8 [frames, 2^log2n];
// tw: float32 [2^log2n + 16 * 2^(log2n-8), 2] (cos, sin), the pass twiddles
// of kernels/chain.py `row_twiddles`; all contiguous on the current device,
// 8 <= log2n <= 10. count: null, or a 64-bit counter on the device, zeroed
// on `stream` before the launch, which then holds the number of peaks.
// Launches on `stream`; returns the memset's error or cudaGetLastError().
extern "C" int rsp_chain_gos(const float* re, const float* im, float* thr,
                             uint8_t* peaks, int frames, cudaStream_t stream,
                             const float* tw, int log2n, float scale,
                             RspGosRegs regs, unsigned long long* count) {
  if (count != nullptr) {
    const cudaError_t e = cudaMemsetAsync(count, 0, sizeof *count, stream);
    if (e != cudaSuccess) return (int)e;
  }
  switch (log2n) {
    case 8:
      return rsp_chain_gos_rows<256>(re, im, thr, peaks, frames, stream, tw,
                                     scale, regs, count);
    case 9:
      return rsp_chain_gos_rows<512>(re, im, thr, peaks, frames, stream, tw,
                                     scale, regs, count);
    case 10:
      return rsp_chain_gos_rows<1024>(re, im, thr, peaks, frames, stream, tw,
                                      scale, regs, count);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
