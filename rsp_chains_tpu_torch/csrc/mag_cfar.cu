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
//
// `kGiven` is the range-sharded tail's "magnitude given" input (the TPU
// kernel's MAG_PASSTHROUGH code, cfar_pallas.py:106): `re` already holds the
// magnitude row that Kernel L (halo.cu) extended, and `im` is not read. It is
// an argument of the entry, never a register value.
#include <cuda_runtime.h>

#include "ca_cfar.cuh"

template <bool kGiven>
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
    float m = 0.0f;
    if (active)
      m = kGiven ? re[base + i]
                 : rsp_magnitude(re[base + i], im[base + i], r.mag_mode);
    row[RSP_PAD + i] = m;
  }
  __syncthreads();
  rsp_ca_tail(row, n, r, thr + base, peaks + base);
}

template <bool kGiven>
static int rsp_mag_cfar_launch(const float* re, const float* im, float* thr,
                               uint8_t* peaks, int frames, cudaStream_t stream,
                               int n, RspCaRegs regs) {
  const size_t smem = (size_t)(n + 2 * RSP_PAD) * sizeof(float);
  cudaError_t e = rsp_opt_in(rsp_mag_cfar_kernel<kGiven>, smem);
  if (e != cudaSuccess) return (int)e;
  rsp_mag_cfar_kernel<kGiven><<<frames, RSP_THREADS, smem, stream>>>(
      re, im, thr, peaks, n, regs);
  return (int)cudaGetLastError();
}

// re, im, thr: float32 [frames, n]; peaks: uint8 [frames, n]; all contiguous
// on the current device. With `mag_given` nonzero, re holds the magnitude and
// im may be null. Launches on `stream` and returns cudaGetLastError().
extern "C" int rsp_mag_cfar(const float* re, const float* im, float* thr,
                            uint8_t* peaks, int frames, cudaStream_t stream,
                            int n, RspCaRegs regs, int mag_given) {
  return mag_given ? rsp_mag_cfar_launch<true>(re, im, thr, peaks, frames,
                                               stream, n, regs)
                   : rsp_mag_cfar_launch<false>(re, im, thr, peaks, frames,
                                                stream, n, regs);
}
