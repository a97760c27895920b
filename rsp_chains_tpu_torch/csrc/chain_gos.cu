// Kernel D: the whole GOSCA chain, FFT -> scale -> magnitude -> GOS / GOSCA /
// CASH CFAR, one thread block per frame.
//
// Replaces rsp_chains_tpu/kernels/chain_pallas.py::fused_chain_gos (:1221,
// pallas_call :1306; body `_chain_gos_kernel` :1172). It is Kernel A's front
// (`rsp_fft_radix2`, fft_radix2.cuh) in front of Kernel C's tail
// (`rsp_gos_tail`, gos_cfar.cuh) with the tile set to the whole frame, so the
// spectrum and the magnitude row never leave shared memory: one read of the
// IQ pair, one write of threshold and peaks.
//
// Bound on the H100: the FFT front, as in Kernel A, then the warp-resident
// rank selection of gos_cfar.cuh: each of the block's 8 warps slides a sorted
// window in registers over an eighth of the frame's window starts (133 at
// N = 1024, w = 32), so the selection adds no shared memory and no divergent
// loop to the front. Shared memory: the frame (2 N floats),
// the magnitude row and two statistic rows (3 * (N + 2*RSP_PAD) floats),
// 23,552 bytes at N = 1024.
#include <cuda_runtime.h>

#include "fft_radix2.cuh"
#include "gos_cfar.cuh"

__global__ void __launch_bounds__(RSP_THREADS)
rsp_chain_gos_kernel(const float* __restrict__ re,
                     const float* __restrict__ im,
                     const float2* __restrict__ tw, float* __restrict__ thr,
                     uint8_t* __restrict__ peaks, int log2n, float scale,
                     RspGosRegs r) {
  extern __shared__ float smem[];
  const int n = 1 << log2n;
  float* xr = smem;
  float* xi = smem + n;
  float* row = smem + 2 * n;          // [RSP_PAD | n | RSP_PAD]
  float* st0 = row + n + 2 * RSP_PAD;
  float* st1 = st0 + n + 2 * RSP_PAD;
  const size_t base = (size_t)blockIdx.x * n;

  for (int j = threadIdx.x; j < RSP_PAD; j += blockDim.x) {
    row[j] = 0.0f;
    row[RSP_PAD + n + j] = 0.0f;
  }
  rsp_fft_radix2(re + base, im + base, tw, xr, xi, log2n);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool active = i >= r.active_lo && i < r.active_hi;
    row[RSP_PAD + i] =
        active ? rsp_magnitude(xr[i] * scale, xi[i] * scale, r.mag_mode) : 0.0f;
  }
  __syncthreads();
  rsp_gos_tail(row, st0, st1, 0, n, r, thr + base, peaks + base);
}

// re, im, thr: float32 [frames, 2^log2n]; peaks: uint8 [frames, 2^log2n];
// tw: float32 [2^(log2n-1), 2] (cos, sin); all contiguous on the current
// device, log2n <= 10. Launches on `stream`; returns cudaGetLastError().
extern "C" int rsp_chain_gos(const float* re, const float* im, float* thr,
                             uint8_t* peaks, int frames, cudaStream_t stream,
                             const float* tw, int log2n, float scale,
                             RspGosRegs regs) {
  const int n = 1 << log2n;
  const size_t smem = (size_t)(2 * n + 3 * (n + 2 * RSP_PAD)) * sizeof(float);
  rsp_chain_gos_kernel<<<frames, RSP_THREADS, smem, stream>>>(
      re, im, reinterpret_cast<const float2*>(tw), thr, peaks, log2n, scale,
      regs);
  return (int)cudaGetLastError();
}
