// Kernel B: magnitude + CA/GO/SO CFAR on a spectrum, one thread block per
// frame.
//
// Replaces rsp_chains_tpu/kernels/cfar_pallas.py::fused_mag_cfar (:489,
// pallas_call :555, body `_kernel` :460). The chain takes it for a shrunken
// FFT-size register, on the spectrum of the unfused FFT
// (chain_pallas.py:1422-1424).
//
// Bound on the H100: device memory. Each complex sample costs 13 bytes (8 read
// as two float32 planes, 4 + 1 written as threshold and peak) against a few
// dozen flops, far below the card's flop-per-byte balance. The design reads
// each sample once and writes each output once; the magnitude row and every
// window read stay in shared memory, (N + 2*RSP_PAD) floats per block. Window
// sums are direct (<= 2*64 shared-memory reads a cell), the simple form;
// a prefix sum would cut them.
#include <cuda_runtime.h>

#include "ca_cfar.cuh"

__global__ void __launch_bounds__(RSP_THREADS)
rsp_mag_cfar_kernel(const float* __restrict__ re, const float* __restrict__ im,
                    float* __restrict__ thr, uint8_t* __restrict__ peaks,
                    int n, RspCaRegs r) {
  extern __shared__ float row[];  // [RSP_PAD | n | RSP_PAD]
  const size_t base = (size_t)blockIdx.x * n;
  for (int j = threadIdx.x; j < RSP_PAD; j += blockDim.x) {
    row[j] = 0.0f;
    row[RSP_PAD + n + j] = 0.0f;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool active = i >= r.active_lo && i < r.active_hi;
    row[RSP_PAD + i] =
        active ? rsp_magnitude(re[base + i], im[base + i], r.mag_mode) : 0.0f;
  }
  __syncthreads();
  rsp_ca_tail(row, n, r, thr + base, peaks + base);
}

// re, im, thr: float32 [frames, n]; peaks: uint8 [frames, n]; all contiguous
// on the current device. Launches on `stream` and returns cudaGetLastError().
extern "C" int rsp_mag_cfar(const float* re, const float* im, float* thr,
                            uint8_t* peaks, int frames, int n, RspCaRegs regs,
                            cudaStream_t stream) {
  const size_t smem = (size_t)(n + 2 * RSP_PAD) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        rsp_mag_cfar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  rsp_mag_cfar_kernel<<<frames, RSP_THREADS, smem, stream>>>(re, im, thr,
                                                             peaks, n, regs);
  return (int)cudaGetLastError();
}
