// Kernel H: the whole range-Doppler chain of a CPI batch, Doppler DFT ->
// matched filter -> magnitude -> CA/GO/SO CFAR along range per Doppler bin
// (rsp_rd_ca), or the front alone, emitting the complex range-Doppler map
// (rsp_rd_map, emit='map').
//
// Replaces rsp_chains_tpu/kernels/rd_pallas.py::fused_rd_chain (:565,
// pallas_call :632; body `_rd_kernel` :277 -> `_rd_front` :251 and the CA
// tail `_ca_cfar_into_lean`; registers `_chain_scalars` :613). The front is
// rd_front.cuh (two launches, Doppler first); the tail is Kernel A's
// (ca_cfar.cuh).
//
// Bound on the H100: device memory. The function moves 13 bytes a sample
// (8 in, 4 + 1 out; 16 for the map, 8 in and 8 out); the two FFTs along range
// and the one along pulses are 5 N log2 N + 5 P log2 P flops a row pair,
// about 9 flops a byte at P = 256, N = 1024, below the card's ~20 fp32 flops
// a byte. The split front adds a 16-byte round trip of the Doppler output
// (8 written, 8 read) that the TPU kernel does not pay. The Doppler launch
// keeps 16 pulses of a range column a thread in registers, radix-16 passes
// with one transpose through shared memory between them (two at P = 512),
// and stores each bin straight to its row; the range-row launch keeps its
// FFT pair in registers, radix-16 passes with two to four barriers a row
// instead of twenty radix-2 stages, and sums the CA windows of 16
// contiguous cells a thread at once (rd_front.cuh). The round trip is what
// is left above the byte bound, and goes once a channel's CPI stays on chip.
#include <cuda_runtime.h>

#include "rd_front.cuh"

// re, im: float32 [batch, 2^log2p, 2^log2n] (one CPI per channel); thr:
// float32 and peaks: uint8 of that shape; yre, yim: float32 scratch of that
// shape; tw_p: the Doppler passes' twiddles, float32 [2^log2p + 16 *
// (2^log2p / 256), 2] (cos, sin; `row_twiddles(P)`, empty at P = 8); tw_n: the
// range passes' twiddles, float32 [2^log2n + 16 * 2^(log2n-8), 2]
// (kernels/chain.py, `row_twiddles`); win: float32 [2^log2p]; h: float32
// [2, 2^log2n], H in the forward pass's digit-reversed order (`h_rows`); all
// contiguous on the current device, 3 <= log2p <= 9, 8 <= log2n <= 10.
// Launches on `stream`; returns the first CUDA error.
extern "C" int rsp_rd_ca(const float* re, const float* im, float* thr,
                         uint8_t* peaks, int batch, cudaStream_t stream,
                         float* yre, float* yim, const float* tw_p,
                         const float* win, const float* tw_n, const float* h,
                         int log2p, int log2n, float dop_scale, int fft_shift,
                         RspCaRegs regs) {
  return rsp_rd_launch<RSP_RD_OUT_CFAR>(re, im, yre, yim, thr, peaks, batch,
                                        stream, tw_p, win, tw_n, h, log2p,
                                        log2n, dop_scale, fft_shift, regs);
}

// As rsp_rd_ca, writing the complex map into (map_re, map_im), which also
// serve as the scratch. mag_mode and the CFAR registers are not read.
extern "C" int rsp_rd_map(const float* re, const float* im, float* map_re,
                          float* map_im, int batch, cudaStream_t stream,
                          const float* tw_p, const float* win,
                          const float* tw_n, const float* h, int log2p,
                          int log2n, float dop_scale, int fft_shift) {
  RspCaRegs none = {};
  return rsp_rd_launch<RSP_RD_OUT_MAP>(re, im, map_re, map_im, map_re, map_im,
                                       batch, stream, tw_p, win, tw_n, h,
                                       log2p, log2n, dop_scale, fft_shift,
                                       none);
}
