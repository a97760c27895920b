// Kernel A: the whole CA chain, FFT -> scale -> magnitude -> CA/GO/SO CFAR,
// one thread block per frame; and Kernel I, the same chain with the matched
// filter's reference spectrum H multiplied in before the magnitude.
//
// Kernel A replaces rsp_chains_tpu/kernels/chain_pallas.py::fused_chain_ca
// (:841, pallas_call :1013; body `_chain_kernel` :688 -> `_chain_core` :541,
// scale `_fft_scale` :803, registers `_chain_scalars` :817).
//
// Kernel I replaces the `h_block` variant of that function (the operand at
// :997-1006, the product at :608-611): a circular matched filter followed by
// the range FFT collapses to FFT(x) * H, with H = conj(FFT(pad(taps)))
// [/ ||taps||], for frames up to N = 4096. H is read in natural bin order (the
// TPU kernel permuted it into its four-step block order, a layout detail the
// radix-2 FFT front does not have). It has its own entry, rsp_pc_ca, so its
// launches and times stay apart from Kernel A's.
//
// Bound on the H100: device memory, as for Kernel B. The traffic is 13 bytes
// per complex sample (8 in, 4 + 1 out; H is 8 bytes a bin, read from L2 by
// every frame); a frame's FFT is 5 N log2 N flops, about 4 flops per byte
// moved at N = 1024, against the card's ~20 fp32 flops per byte of
// bandwidth. The spectrum never leaves shared memory: the frame (2 N floats)
// and its magnitude row (N + 2*RSP_PAD floats) sit there, 50,176 bytes at
// N = 4096, above the 48 KB default, so that launch opts in. The butterflies
// and the window sums load shared memory, not device memory. The FFT is
// `rsp_fft_radix2` (fft_radix2.cuh).
#include <cuda_runtime.h>

#include "ca_cfar.cuh"
#include "fft_radix2.cuh"

// kH: multiply the scaled spectrum by h ([2, n], re and im planes).
template <bool kH>
__global__ void __launch_bounds__(RSP_THREADS)
rsp_chain_ca_kernel(const float* __restrict__ re, const float* __restrict__ im,
                    const float2* __restrict__ tw, const float* __restrict__ h,
                    float* __restrict__ thr, uint8_t* __restrict__ peaks,
                    int log2n, float scale, RspCaRegs r) {
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
    float m = 0.0f;
    if (i >= r.active_lo && i < r.active_hi) {
      const float sr = xr[i] * scale, si = xi[i] * scale;
      if (kH) {
        const float hr = h[i], hi = h[n + i];
        m = rsp_magnitude(fmaf(sr, hr, -si * hi), fmaf(sr, hi, si * hr),
                          r.mag_mode);
      } else {
        m = rsp_magnitude(sr, si, r.mag_mode);
      }
    }
    row[RSP_PAD + i] = m;
  }
  __syncthreads();
  rsp_ca_tail(row, n, r, thr + base, peaks + base);
}

template <bool kH>
static int rsp_chain_ca_launch(const float* re, const float* im, float* thr,
                               uint8_t* peaks, int frames, cudaStream_t stream,
                               const float* tw, const float* h, int log2n,
                               float scale, RspCaRegs regs) {
  const size_t smem = (size_t)(3 * (1 << log2n) + 2 * RSP_PAD) * sizeof(float);
  const cudaError_t e = rsp_opt_in(rsp_chain_ca_kernel<kH>, smem);
  if (e != cudaSuccess) return (int)e;
  rsp_chain_ca_kernel<kH><<<frames, RSP_THREADS, smem, stream>>>(
      re, im, reinterpret_cast<const float2*>(tw), h, thr, peaks, log2n, scale,
      regs);
  return (int)cudaGetLastError();
}

// re, im, thr: float32 [frames, 2^log2n]; peaks: uint8 [frames, 2^log2n];
// tw: float32 [2^(log2n-1), 2] (cos, sin); all contiguous on the current
// device, log2n <= 10. Launches on `stream`; returns cudaGetLastError().
extern "C" int rsp_chain_ca(const float* re, const float* im, float* thr,
                            uint8_t* peaks, int frames, cudaStream_t stream,
                            const float* tw, int log2n, float scale,
                            RspCaRegs regs) {
  return rsp_chain_ca_launch<false>(re, im, thr, peaks, frames, stream, tw,
                                    nullptr, log2n, scale, regs);
}

// As rsp_chain_ca, with h: float32 [2, 2^log2n] (re, im planes) and
// 8 <= log2n <= 12.
extern "C" int rsp_pc_ca(const float* re, const float* im, float* thr,
                         uint8_t* peaks, int frames, cudaStream_t stream,
                         const float* tw, const float* h, int log2n,
                         float scale, RspCaRegs regs) {
  return rsp_chain_ca_launch<true>(re, im, thr, peaks, frames, stream, tw, h,
                                   log2n, scale, regs);
}
