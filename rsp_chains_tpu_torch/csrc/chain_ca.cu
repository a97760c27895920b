// Kernel A: the whole CA chain, FFT -> scale -> magnitude -> CA/GO/SO CFAR,
// one thread block per frame.
//
// Replaces rsp_chains_tpu/kernels/chain_pallas.py::fused_chain_ca (:841,
// pallas_call :1013; body `_chain_kernel` :688 -> `_chain_core` :541, scale
// `_fft_scale` :803, registers `_chain_scalars` :817).
//
// Bound on the H100: device memory, as for Kernel B. The traffic is 13 bytes
// per complex sample (8 in, 4 + 1 out); a frame's FFT is 5 N log2 N flops,
// about 4 flops per byte moved at N = 1024, against the card's ~20 fp32
// flops per byte of bandwidth. The spectrum never leaves shared memory: the
// frame (2 N floats, 8 KB at N = 1024) and its magnitude row (N + 2*RSP_PAD
// floats) sit there, so the butterflies and the window sums load shared
// memory, not device memory. The FFT is `rsp_fft_radix2` (fft_radix2.cuh).
#include <cuda_runtime.h>

#include "ca_cfar.cuh"
#include "fft_radix2.cuh"

__global__ void __launch_bounds__(RSP_THREADS)
rsp_chain_ca_kernel(const float* __restrict__ re, const float* __restrict__ im,
                    const float2* __restrict__ tw, float* __restrict__ thr,
                    uint8_t* __restrict__ peaks, int log2n, float scale,
                    RspCaRegs r) {
  extern __shared__ float smem[];
  const int n = 1 << log2n;
  float* xr = smem;
  float* xi = smem + n;
  float* row = smem + 2 * n;  // [RSP_PAD | n | RSP_PAD]
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
  rsp_ca_tail(row, n, r, thr + base, peaks + base);
}

// re, im, thr: float32 [frames, 2^log2n]; peaks: uint8 [frames, 2^log2n];
// tw: float32 [2^(log2n-1), 2] (cos, sin); all contiguous on the current
// device, log2n <= 10. Launches on `stream`; returns cudaGetLastError().
extern "C" int rsp_chain_ca(const float* re, const float* im, float* thr,
                            uint8_t* peaks, int frames, cudaStream_t stream,
                            const float* tw, int log2n, float scale,
                            RspCaRegs regs) {
  const int n = 1 << log2n;
  const size_t smem = (size_t)(3 * n + 2 * RSP_PAD) * sizeof(float);
  rsp_chain_ca_kernel<<<frames, RSP_THREADS, smem, stream>>>(
      re, im, reinterpret_cast<const float2*>(tw), thr, peaks, log2n, scale,
      regs);
  return (int)cudaGetLastError();
}
