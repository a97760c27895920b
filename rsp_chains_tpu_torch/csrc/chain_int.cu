// Kernel F: the bit-true integer CA chain, integer FFT -> magnitude ->
// CA/GO/SO CFAR, one thread block per frame.
//
// Replaces rsp_chains_tpu/kernels/int_chain_pallas.py::fused_chain_int (:441,
// pallas_call :512; body `_int_chain_kernel` :241 with `_int_front` :131 and
// `_int_thr_peaks_tail` :207). Exact: the arithmetic is ops/bit_true.py's,
// operation for operation (int_front.cuh).
//
// Bound on the H100: device memory, as for Kernel A. A sample costs 13 bytes
// (two int32 planes in, an int32 threshold and a peak byte out) against about
// 40 integer operations per butterfly and log2 N butterflies per pair of
// samples. The TPU computes the butterflies with lane rotations and the bit
// reversal with log2(N)/2 transposition steps because Mosaic has no per-lane
// gather; here a butterfly reads its two cells from shared memory and the
// magnitude reads bin k from __brev(k), so the frame, its spectrum and the
// magnitude row (2 N + N + 2*RSP_PAD ints, 13 KB at N = 1024, 197,632 bytes
// at N = 16384) never leave shared memory.
#include <cuda_runtime.h>

#include "int_front.cuh"

__global__ void __launch_bounds__(RSP_THREADS)
rsp_chain_int_kernel(const int* __restrict__ re, const int* __restrict__ im,
                     const int2* __restrict__ tw, int* __restrict__ thr,
                     uint8_t* __restrict__ peaks, int log2n,
                     unsigned expand_mask, unsigned lsb_mask, RspIntRegs r) {
  extern __shared__ int ismem[];
  const int n = 1 << log2n;
  int* xr = ismem;
  int* xi = ismem + n;
  int* row = ismem + 2 * n;  // [RSP_PAD | n | RSP_PAD]
  const size_t base = (size_t)blockIdx.x * n;

  rsp_int_front(re + base, im + base, tw, xr, xi, row, log2n, expand_mask,
                lsb_mask, r);

  const int w = 1 << r.log2w;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (i >= r.n_active) {
      thr[base + i] = 0;
      peaks[base + i] = 0;
      continue;
    }
    const int* c = row + RSP_PAD + i;
    int lag, lead;
    rsp_int_ca_sums(c, r.guard, w, lag, lead);
    const int noise =
        rsp_int_combine(r.cfar_mode, lag >> r.div_sum, lead >> r.div_sum);
    int t;
    uint8_t pk;
    rsp_int_thr_peak(c, i, noise, r, t, pk);
    thr[base + i] = t;
    peaks[base + i] = pk;
  }
}

// re, im, thr: int32 [frames, 2^log2n]; peaks: uint8 [frames, 2^log2n];
// tw: int32 [2^log2n, 2] (see rsp_int_fft); all contiguous on the current
// device, 8 <= log2n <= 14. Launches on `stream`; returns cudaGetLastError().
extern "C" int rsp_chain_int(const int* re, const int* im, int* thr,
                             uint8_t* peaks, int frames, cudaStream_t stream,
                             const int* tw, int log2n, int expand_mask,
                             int lsb_mask, RspIntRegs regs) {
  const int n = 1 << log2n;
  const size_t smem = (size_t)(3 * n + 2 * RSP_PAD) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rsp_chain_int_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rsp_chain_int_kernel<<<frames, RSP_THREADS, smem, stream>>>(
      re, im, reinterpret_cast<const int2*>(tw), thr, peaks, log2n,
      (unsigned)expand_mask, (unsigned)lsb_mask, regs);
  return (int)cudaGetLastError();
}
