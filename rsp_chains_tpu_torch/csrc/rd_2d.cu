// Kernel J: the range-Doppler chain with the 2-D map detector, Doppler DFT ->
// matched filter -> magnitude map -> 2-D annulus CA CFAR, over a CPI batch.
//
// Replaces rsp_chains_tpu/kernels/rd_pallas.py::fused_rd_2d_chain (:442,
// pallas_call :515; body `_rd_kernel_2d` :419 = `_rd_front` +
// `_cfar2d_into`). Three launches: the two of the range-Doppler front
// (rd_front.cuh: the register column plan over the pulses, then Kernel H's
// register row plan along range), the second writing the magnitude over the
// Doppler output in place, then the run-sum 2-D CFAR of cfar_2d.cuh over
// 32 x 128 tiles of that map.
//
// Bound on the H100: device memory, 13 bytes a sample (8 in, 4 + 1 out) for
// the function. The split adds the 16-byte round trip of the Doppler output
// and a 4-byte magnitude map written and read again (about 24 bytes a
// sample on top of the 13: 37 bytes a sample for the three launches, 16 +
// 12 + 9); the TPU kernel kept both in VMEM.
#include <cuda_runtime.h>

#include "cfar_2d.cuh"
#include "rd_front.cuh"

// re, im: float32 [batch, 2^log2p, 2^log2n]; thr: float32 and peaks: uint8
// of that shape; yre, yim: float32 scratch of that shape (yre then holds the
// magnitude map); tw_p, win, tw_n, h as for rsp_rd_ca; all contiguous on the
// current device, 3 <= log2p <= 9, 8 <= log2n <= 10; regs clamped on the
// host, with 2 (g_r + w_r) + 2 <= RSP_PAD. Launches on `stream`; returns the
// first CUDA error.
extern "C" int rsp_rd_2d(const float* re, const float* im, float* thr,
                         uint8_t* peaks, int batch, cudaStream_t stream,
                         float* yre, float* yim, const float* tw_p,
                         const float* win, const float* tw_n, const float* h,
                         int log2p, int log2n, float dop_scale, int fft_shift,
                         RspCfar2dRegs regs) {
  RspCaRegs front = {};
  front.mag_mode = regs.mag_mode;
  int rc = rsp_rd_launch<RSP_RD_OUT_MAG>(re, im, yre, yim, yre, nullptr,
                                         batch, stream, tw_p, win, tw_n, h,
                                         log2p, log2n, dop_scale, fft_shift,
                                         front);
  if (rc != 0) return rc;
  const int p = 1 << log2p, n = 1 << log2n;
  const int a_d = regs.g_d + regs.w_d;
  const size_t smem = rsp_c2d_smem(regs.g_r + regs.w_r, a_d);
  const auto kernel = rsp_c2d_one(a_d) ? rsp_cfar2d_kernel<true>
                                       : rsp_cfar2d_kernel<false>;
  const cudaError_t e = rsp_opt_in(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(batch * (n / RSP_C2D_TR), (p + RSP_C2D_TD - 1) / RSP_C2D_TD);
  kernel<<<grid, RSP_C2D_THREADS, smem, stream>>>(yre, thr, peaks, p, n, regs);
  return (int)cudaGetLastError();
}
