// Kernel G: the bit-true integer GOSCA chain, integer FFT -> magnitude ->
// CA / GOS CFAR muxed by the algorithm register, one thread block per frame.
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
// of Kernels C and D (gos_cfar.cuh, `rsp_gos_stats`) on int32: each warp
// keeps its window's active cells sorted in registers, INT32_MAX under signed
// compares past the nv active ones (the order and padding of the integer
// ops, which sort an invalid cell as int32 max), and the lane holding each
// rank stores it once per window start into shared memory, read by the lag
// side of one cell and the lead side of another. Compares only: the result
// is the integer pipeline's bit for bit, ties and square sums saturated to
// INT32_MAX included.
//
// Bound on the H100: device memory for the function (13 bytes a cell); the
// kernel is held by Kernel F's integer FFT front (shared-memory radix-2
// stages) and, as in C and D, the selection's pipe to shared memory and
// shuffles, about 6 SM clocks a window start at w = 32. Shared memory: the
// magnitude row and the frame, whose space the two statistic rows take once
// the front is done (3 * (N + 2*RSP_PAD) ints): 13,824 bytes at N = 1024,
// 199,680 at N = 16384.
#include <cuda_runtime.h>

#include "gos_cfar.cuh"
#include "int_front.cuh"

__global__ void __launch_bounds__(RSP_THREADS)
rsp_chain_int_gos_kernel(const int* __restrict__ re,
                         const int* __restrict__ im,
                         const int2* __restrict__ tw, int* __restrict__ thr,
                         uint8_t* __restrict__ peaks, int log2n,
                         unsigned expand_mask, unsigned lsb_mask,
                         RspIntRegs r) {
  extern __shared__ int ismem[];
  const int n = 1 << log2n;
  int* row = ismem;                   // [RSP_PAD | n | RSP_PAD]
  int* xr = row + n + 2 * RSP_PAD;
  int* xi = xr + n;
  // by window start, like `row`; over the frame, which the front has read
  int* st0 = xr;
  int* st1 = st0 + n + 2 * RSP_PAD;
  const size_t base = (size_t)blockIdx.x * n;

  rsp_int_front(re + base, im + base, tw, xr, xi, row, log2n, expand_mask,
                lsb_mask, r);

  const int w = 1 << r.log2w, g = r.guard, hi = r.n_active;
  if (r.algorithm == 1) {
    // st0[s] / st1[s]: the lag / lead rank statistic of the window of cells
    // s - RSP_PAD .. s - RSP_PAD + w - 1 over the active cells [0, hi)
    rsp_gos_stats(row, st0, st1, RSP_PAD - g - w, RSP_PAD + n + g + 1, w,
                  RSP_PAD, RSP_PAD + hi, r.rank_lagg, r.rank_lead);
    __syncthreads();
  }

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (i >= hi) {
      thr[base + i] = 0;
      peaks[base + i] = 0;
      continue;
    }
    const int s = RSP_PAD + i;
    const int* c = row + s;
    int s_lag, s_lead;
    if (r.algorithm == 1) {
      s_lag = st0[s - g - w];
      s_lead = st1[s + g + 1];
    } else {
      int lag, lead;
      rsp_int_ca_sums(c, g, w, lag, lead);
      s_lag = lag >> r.div_sum;
      s_lead = lead >> r.div_sum;
    }
    int t;
    uint8_t pk;
    rsp_int_thr_peak(c, i, rsp_int_combine(r.cfar_mode, s_lag, s_lead), r, t,
                     pk);
    thr[base + i] = t;
    peaks[base + i] = pk;
  }
}

// re, im, thr: int32 [frames, 2^log2n]; peaks: uint8 [frames, 2^log2n];
// tw: int32 [2^log2n, 2] (see rsp_int_fft); all contiguous on the current
// device, 8 <= log2n <= 14. Launches on `stream`; returns cudaGetLastError().
extern "C" int rsp_chain_int_gos(const int* re, const int* im, int* thr,
                                 uint8_t* peaks, int frames,
                                 cudaStream_t stream, const int* tw, int log2n,
                                 int expand_mask, int lsb_mask,
                                 RspIntRegs regs) {
  const int n = 1 << log2n;
  const size_t smem = (size_t)3 * (n + 2 * RSP_PAD) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rsp_chain_int_gos_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rsp_chain_int_gos_kernel<<<frames, RSP_THREADS, smem, stream>>>(
      re, im, reinterpret_cast<const int2*>(tw), thr, peaks, log2n,
      (unsigned)expand_mask, (unsigned)lsb_mask, regs);
  return (int)cudaGetLastError();
}
