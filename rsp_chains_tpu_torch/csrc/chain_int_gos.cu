// Kernel G: the bit-true integer GOSCA chain, integer FFT -> magnitude ->
// CA / GOS CFAR muxed by the algorithm register.
//
// Replaces rsp_chains_tpu/kernels/int_chain_pallas.py::fused_chain_int_gos
// (:552, pallas_call :622; body `_int_gos_kernel` :302-438). Kernel F's front
// (int_front.cuh), then the statistic of each side: with algorithm 1 the
// min(rank, nv - 1)-th smallest of the nv cells of the window that lie inside
// [0, n_active), 0 when nv is 0 (ops/bit_true.py, `_int_gos_side`); otherwise
// the CA sums `>> divSum`. CASH is not in this kernel, as in the JAX package:
// the host sends the CASH mode register to the integer ops.
//
// The TPU sorts every window with a sliding odd-even merge ladder of lane
// rotations. Here the selection is the warp-resident sliding sorted window
// of Kernels C and D (gos_cfar.cuh) on int32: each warp (half-warp at w <=
// 32) keeps its window's active cells sorted in registers, INT32_MAX under
// signed compares past the nv active ones (the order and padding of the integer
// ops, which sort an invalid cell as int32 max), and the lane holding each
// rank stores it once per window start into shared memory, read by the lag
// side of one cell and the lead side of another. Compares only: the result
// is the integer pipeline's bit for bit, ties and square sums saturated to
// INT32_MAX included.
//
// Bound on the H100: device memory for the function (13 bytes a cell, 0.065
// ms at 64 x 256 frames of 1024); the kernel is held, as C and D, by the
// selection's pipe to shared memory and shuffles (gos_cfar.cuh,
// gos_rows.cuh). This file holds the route of N = 256, 512, 1024
// (rsp_chain_int_gos_rows_kernel<N>, entry rsp_chain_int_gos_rows): Kernel
// F's row plan, N / 16 threads a frame and 256 / (N / 16) frames a block,
// each stage's butterflies in registers, 1 or 2 exchanges through shared
// memory and the magnitude stored at its natural bin
// (`rsp_int_front_rows`, int_rows.cuh); then the selection over the
// block's frames with the ranks kept by cell in the dead FFT planes
// (gos_rows.cuh), and a tail whose thread takes the cells m + (N / 16) k, a
// warp's stores coalesced; with algorithm 0 F's run-sum CA tail
// (`rsp_int_ca_runs`). 55,552 bytes of shared memory a block at N = 1024
// (RspGosRows), three blocks an SM (RSP_ROWS_BLOCKS). After the tail a
// warp counts the peaks its live lanes stored (rsp_count_cells). The host
// (kernels/int_chain.py) picks the route by N alone: frames of 2048-16384
// take int_mid.cu (one launch, the selection of gos_cfar.cuh over rows in
// shared memory), longer ones int_split.cu.
#include <cuda_runtime.h>

#include "gos_rows.cuh"
#include "int_rows.cuh"

// The thresholds and peaks of a frame's cells m + kT j (j < 16), one
// thread's, from their lag and lead rank statistics st0 / st1[cell]: the
// mode, the threshold, peak grouping on the raw magnitudes of rw
// (rsp_mag_slot) and the active mask of `rsp_int_thr_peak`.
template <int kT>
static __device__ __forceinline__ void rsp_int_gos_cells(
    const int* rw, const int* st0, const int* st1, int m, const RspIntRegs& r,
    int* __restrict__ thr, uint8_t* __restrict__ pk) {
  const int hi = r.n_active;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int i = m + kT * j;
    const int th = rsp_int_threshold(
        rsp_int_combine(r.cfar_mode, st0[i], st1[i]), r);
    const int v = rw[rsp_mag_slot(RSP_PAD + i)];
    bool p = v > th;
    if (p && r.peak_grouping == 1) {
      const int left = i >= 1 ? rw[rsp_mag_slot(RSP_PAD + i - 1)]
                              : RSP_PEAK_EDGE;
      const int right = i + 1 < hi ? rw[rsp_mag_slot(RSP_PAD + i + 1)]
                                   : RSP_PEAK_EDGE;
      p = v >= left && v >= right;
    }
    const bool active = i < hi;
    thr[i] = active ? th : 0;
    pk[i] = active && p ? 1 : 0;
  }
}

// Kernel G over `frames` frames of kN cells; count: the counter the frames'
// peaks are added to, or null. Grid ceil(frames / kRows).
template <int kN>
__global__ void __launch_bounds__(RSP_THREADS, RSP_ROWS_BLOCKS)
rsp_chain_int_gos_rows_kernel(const int* __restrict__ re,
                              const int* __restrict__ im,
                              const int2* __restrict__ tw,
                              int* __restrict__ thr,
                              uint8_t* __restrict__ peaks, int frames,
                              unsigned expand_mask, unsigned lsb_mask,
                              RspIntRegs r, unsigned long long* count) {
  using P = RspRowPlan<kN>;
  constexpr int T = P::kT;
  extern __shared__ int ismem[];
  const int q = threadIdx.x / T, m = threadIdx.x % T;
  const int row = blockIdx.x * P::kRows + q;
  const bool live = row < frames;
  const size_t base = (size_t)row * kN;
  int* pr = ismem + q * P::kS;  // this frame's planes of the FFT buffer
  int* pi = pr + P::kRows * P::kS;
  int* rw = ismem + 2 * P::kRows * P::kS + q * RspGosRows<kN>::kMag;

  // ends with a barrier: the magnitude rows are whole, the planes dead
  rsp_int_front_rows<kN>(re, im, base, live, m, tw, pr, pi, rw, expand_mask,
                         lsb_mask, r);
  int* t = thr + base;
  uint8_t* pk = peaks + base;
  if (r.algorithm == 1) {
    const int rows = min(P::kRows, frames - (int)blockIdx.x * P::kRows);
    rsp_gos_rows_stats<kN>(ismem, rows, 1 << r.log2w, r.guard, 0, r.n_active,
                           r.rank_lagg, r.rank_lead);
    __syncthreads();
    if (!live) return;
    rsp_int_gos_cells<T>(rw, pr, pi, m, r, t, pk);
    rsp_count_cells<T>(count, pk, m, rsp_live_lanes<T, P::kRows>(frames));
    return;
  }
  if (!live) return;
  switch (r.log2w) {
    case 0: rsp_int_ca_runs<1>(rw, 16 * m, r, t, pk); break;
    case 1: rsp_int_ca_runs<2>(rw, 16 * m, r, t, pk); break;
    case 2: rsp_int_ca_runs<4>(rw, 16 * m, r, t, pk); break;
    case 3: rsp_int_ca_runs<8>(rw, 16 * m, r, t, pk); break;
    default: rsp_int_ca_runs<16>(rw, 16 * m, r, t, pk); break;
  }
  rsp_count_cells<16>(count, pk, m, rsp_live_lanes<T, P::kRows>(frames));
}

template <int kN>
static int rsp_chain_int_gos_rows_launch(const int* re, const int* im,
                                         int* thr, uint8_t* peaks, int frames,
                                         cudaStream_t stream, const int* tw,
                                         unsigned expand_mask,
                                         unsigned lsb_mask, RspIntRegs regs,
                                         unsigned long long* count) {
  using P = RspRowPlan<kN>;
  const size_t smem = (size_t)RspGosRows<kN>::kFloats * sizeof(int);
  const cudaError_t e = rsp_opt_in(rsp_chain_int_gos_rows_kernel<kN>, smem);
  if (e != cudaSuccess) return (int)e;
  rsp_chain_int_gos_rows_kernel<kN><<<(frames + P::kRows - 1) / P::kRows,
                                      RSP_THREADS, smem, stream>>>(
      re, im, reinterpret_cast<const int2*>(tw), thr, peaks, frames,
      expand_mask, lsb_mask, regs, count);
  return (int)cudaGetLastError();
}

// re, im, thr: int32 [frames, 2^log2n]; peaks: uint8 [frames, 2^log2n];
// tw: int32 [2^log2n, 2] (int_front.cuh); all contiguous on the current
// device, 8 <= log2n <= 10. count: null, or a 64-bit counter on the
// device, zeroed on `stream` before the launch, which then holds the number
// of peaks. Launches on `stream`; returns the memset's error or
// cudaGetLastError().
extern "C" int rsp_chain_int_gos_rows(const int* re, const int* im, int* thr,
                                      uint8_t* peaks, int frames,
                                      cudaStream_t stream, const int* tw,
                                      int log2n, int expand_mask,
                                      int lsb_mask, RspIntRegs regs,
                                      unsigned long long* count) {
  if (count != nullptr) {
    const cudaError_t e = cudaMemsetAsync(count, 0, sizeof *count, stream);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned em = (unsigned)expand_mask, lm = (unsigned)lsb_mask;
  switch (log2n) {
    case 8:
      return rsp_chain_int_gos_rows_launch<256>(re, im, thr, peaks, frames,
                                                stream, tw, em, lm, regs,
                                                count);
    case 9:
      return rsp_chain_int_gos_rows_launch<512>(re, im, thr, peaks, frames,
                                                stream, tw, em, lm, regs,
                                                count);
    case 10:
      return rsp_chain_int_gos_rows_launch<1024>(re, im, thr, peaks, frames,
                                                 stream, tw, em, lm, regs,
                                                 count);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
