// Kernel A: the whole CA chain, FFT -> scale -> magnitude -> CA/GO/SO CFAR,
// over frames of N = 256, 512 or 1024. Kernel I (pc_ca.cu) is this kernel
// with the matched filter's reference spectrum multiplied in.
//
// Replaces rsp_chains_tpu/kernels/chain_pallas.py::fused_chain_ca (:841,
// pallas_call :1013; body `_chain_kernel` :688 -> `_chain_core` :541, scale
// `_fft_scale` :803, registers `_chain_scalars` :817).
//
// Bound on the H100: device memory. The traffic is 13 bytes per complex
// sample (8 in, 4 + 1 out); a frame's FFT is 5 N log2 N flops, about 4 flops
// per byte moved at N = 1024, against the card's ~20 fp32 flops per byte of
// bandwidth. The spectrum never leaves the chip.
//
// Design (rsp_chain_ca_rows_kernel<N>): the row plan of row_fft.cuh, N / 16
// threads a frame, 256 / (N / 16) frames a block, 16 cells a thread, the
// forward transform in radix-16 passes in registers with 1 or 2 barriers
// (`rsp_row_forward`). The spectrum comes out digit-reversed: each thread
// scales its 16 bins, takes their magnitude and scatters it to its natural
// bin of the frame's padded magnitude row (`rsp_row_bin`; 2-way bank
// conflicts at most, a store a cell), and the CA tail sums the windows of 16
// contiguous cells a thread by runs (`rsp_ca_row`), about w + 16 shared reads
// a side a run against 2w a cell. Shared memory: the FFT planes and the
// magnitude rows, 55,296 bytes a block at N = 1024 (above the 48 KB default,
// so it opts in). Three blocks an SM (RSP_ROWS_BLOCKS; 80 registers, no
// spills): of 1, 2, 3 and 4 it ran fastest (chip_smoke.py `row_blocks`).
#include <cuda_runtime.h>

#include "ca_cfar.cuh"
#include "row_fft.cuh"

// Kernel A over `frames` frames of kN cells. tw: the pass twiddles of
// kernels/chain.py `row_twiddles(kN)`. Grid ceil(frames / kRows).
template <int kN>
__global__ void __launch_bounds__(RSP_THREADS, RSP_ROWS_BLOCKS)
rsp_chain_ca_rows_kernel(const float* __restrict__ re,
                         const float* __restrict__ im,
                         const float2* __restrict__ tw,
                         float* __restrict__ thr, uint8_t* __restrict__ peaks,
                         int frames, float scale, RspCaRegs r) {
  using P = RspRowPlan<kN>;
  constexpr int T = P::kT;
  extern __shared__ float smem[];
  const int q = threadIdx.x / T, m = threadIdx.x % T;
  const int row = blockIdx.x * P::kRows + q;
  const bool live = row < frames;
  const size_t base = (size_t)row * kN;
  float* pr = smem + q * P::kS;  // this frame's planes of the FFT buffer
  float* pi = pr + P::kRows * P::kS;
  float* rw = smem + 2 * P::kRows * P::kS + q * P::kMagS;
  float xr[16], xi[16];

  rsp_row_forward<kN>(re, im, base, live, m, tw, pr, pi, xr, xi);
  for (int j = m; j < RSP_PAD; j += T) {
    rw[rsp_mag_slot(j)] = 0.0f;
    rw[rsp_mag_slot(RSP_PAD + kN + j)] = 0.0f;
  }
  // slot j holds the cell 16 m + j of the digit-reversed spectrum
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int k = rsp_row_bin<kN>(16 * m + j);
    const bool active = k >= r.active_lo && k < r.active_hi;
    rw[rsp_mag_slot(RSP_PAD + k)] =
        active ? rsp_magnitude(xr[j] * scale, xi[j] * scale, r.mag_mode)
               : 0.0f;
  }
  __syncthreads();
  if (!live) return;
  rsp_ca_row(rw, m, r, thr + base, peaks + base);
}

template <int kN>
static int rsp_chain_ca_rows(const float* re, const float* im, float* thr,
                             uint8_t* peaks, int frames, cudaStream_t stream,
                             const float* tw, float scale, RspCaRegs regs) {
  using P = RspRowPlan<kN>;
  const size_t smem = (size_t)P::kRows * (2 * P::kS + P::kMagS) * sizeof(float);
  const cudaError_t e = rsp_opt_in(rsp_chain_ca_rows_kernel<kN>, smem);
  if (e != cudaSuccess) return (int)e;
  rsp_chain_ca_rows_kernel<kN><<<(frames + P::kRows - 1) / P::kRows,
                                 RSP_THREADS, smem, stream>>>(
      re, im, reinterpret_cast<const float2*>(tw), thr, peaks, frames, scale,
      regs);
  return (int)cudaGetLastError();
}

// re, im, thr: float32 [frames, 2^log2n]; peaks: uint8 [frames, 2^log2n];
// tw: float32 [2^log2n + 16 * 2^(log2n-8), 2] (cos, sin), the pass twiddles
// of kernels/chain.py `row_twiddles`; all contiguous on the current device,
// 8 <= log2n <= 10. Launches on `stream`; returns cudaGetLastError().
extern "C" int rsp_chain_ca(const float* re, const float* im, float* thr,
                            uint8_t* peaks, int frames, cudaStream_t stream,
                            const float* tw, int log2n, float scale,
                            RspCaRegs regs) {
  switch (log2n) {
    case 8:
      return rsp_chain_ca_rows<256>(re, im, thr, peaks, frames, stream, tw,
                                    scale, regs);
    case 9:
      return rsp_chain_ca_rows<512>(re, im, thr, peaks, frames, stream, tw,
                                    scale, regs);
    case 10:
      return rsp_chain_ca_rows<1024>(re, im, thr, peaks, frames, stream, tw,
                                     scale, regs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
