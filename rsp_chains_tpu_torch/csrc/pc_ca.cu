// Kernel I: the collapsed pulse-compression chain over frames of N = 256 ...
// 4096: FFT -> scale -> product with the matched filter's reference spectrum
// H -> magnitude -> CA/GO/SO CFAR.
//
// Replaces the `h_block` variant of
// rsp_chains_tpu/kernels/chain_pallas.py::fused_chain_ca (:863; the operand at
// :997-1006, the product at :608-611, pallas_call :1013): a circular matched
// filter followed by the range FFT collapses to FFT(x) * H, with H =
// conj(FFT(pad(taps))) [/ ||taps||]. It has its own entry, rsp_pc_ca, so its
// launches and times stay apart from Kernel A's.
//
// Bound on the H100: device memory. The traffic is 13 bytes per complex
// sample (8 in, 4 + 1 out; H is 8 bytes a bin, read from L2 by every frame);
// a frame's FFT is 5 N log2 N flops, about 5 flops per byte moved at
// N = 4096, against the card's ~20 fp32 flops per byte of bandwidth. The
// spectrum never leaves the chip.
//
// Design: Kernel A's row plan (row_fft.cuh), extended to N = 2048 (passes of
// radix 16, 16, 8) and 4096 (16, 16, 16). N / 16 threads a frame, 256 /
// (N / 16) frames a block (one at 4096), 16 cells a thread; the forward
// transform in registers with 1 or 2 barriers (`rsp_row_forward`) leaves the
// spectrum digit-reversed. H comes in that order (kernels/chain.py
// `_permuted`, once per H tensor), so thread m reads its 16 values as four
// float4 a plane. Each thread scales its 16 bins, multiplies them by H,
// takes their magnitude and scatters it to its natural bin of the frame's
// padded magnitude row (`rsp_row_bin`; 2-way bank conflicts at most), and
// the CA tail sums the windows of 16 contiguous cells a thread by runs
// (`rsp_ca_row`). Shared memory: the FFT planes and the magnitude rows,
// 51,456 bytes a block at N = 4096 (above the 48 KB default, so it opts in).
// Three blocks an SM (RSP_ROWS_BLOCKS, as Kernel A; 80 registers, no
// spills): of 1 to 4 it ran fastest at N = 4096 (chip_smoke.py
// `row_blocks`).
#include <cuda_runtime.h>

#include "ca_cfar.cuh"
#include "row_fft.cuh"

// Kernel I over `frames` frames of kN cells. tw: the pass twiddles of
// kernels/chain.py `row_twiddles(kN)`; h: [2, kN] (re, im planes) in
// `row_order`. Grid ceil(frames / kRows).
template <int kN>
__global__ void __launch_bounds__(RSP_THREADS, RSP_ROWS_BLOCKS)
rsp_pc_ca_rows_kernel(const float* __restrict__ re,
                      const float* __restrict__ im,
                      const float2* __restrict__ tw,
                      const float* __restrict__ h, float* __restrict__ thr,
                      uint8_t* __restrict__ peaks, int frames, float scale,
                      RspCaRegs r) {
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
  // slot j holds the cell 16 m + j of the digit-reversed spectrum, and H
  // at that cell's bin
  const float4* hr4 = reinterpret_cast<const float4*>(h + 16 * m);
  const float4* hi4 = reinterpret_cast<const float4*>(h + kN + 16 * m);
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    const float4 a = __ldg(hr4 + g), b = __ldg(hi4 + g);
    const float hr[4] = {a.x, a.y, a.z, a.w}, hi[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int j = 4 * g + e;
      const int k = rsp_row_bin<kN>(16 * m + j);
      const bool active = k >= r.active_lo && k < r.active_hi;
      const float sr = xr[j] * scale, si = xi[j] * scale;
      rw[rsp_mag_slot(RSP_PAD + k)] =
          active ? rsp_magnitude(fmaf(sr, hr[e], -si * hi[e]),
                                 fmaf(sr, hi[e], si * hr[e]), r.mag_mode)
                 : 0.0f;
    }
  }
  __syncthreads();
  if (!live) return;
  rsp_ca_row(rw, m, r, thr + base, peaks + base);
}

template <int kN>
static int rsp_pc_ca_rows(const float* re, const float* im, float* thr,
                          uint8_t* peaks, int frames, cudaStream_t stream,
                          const float* tw, const float* h, float scale,
                          RspCaRegs regs) {
  using P = RspRowPlan<kN>;
  const size_t smem = (size_t)P::kRows * (2 * P::kS + P::kMagS) * sizeof(float);
  const cudaError_t e = rsp_opt_in(rsp_pc_ca_rows_kernel<kN>, smem);
  if (e != cudaSuccess) return (int)e;
  rsp_pc_ca_rows_kernel<kN><<<(frames + P::kRows - 1) / P::kRows, RSP_THREADS,
                              smem, stream>>>(
      re, im, reinterpret_cast<const float2*>(tw), h, thr, peaks, frames,
      scale, regs);
  return (int)cudaGetLastError();
}

// re, im, thr: float32 [frames, 2^log2n]; peaks: uint8 [frames, 2^log2n];
// tw: float32 [2^log2n + 16 * 2^(log2n-8), 2] (cos, sin), the pass twiddles
// of kernels/chain.py `row_twiddles`; h: float32 [2, 2^log2n] (re, im
// planes) in `row_order`; all contiguous on the current device, h 16-byte
// aligned, 8 <= log2n <= 12. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int rsp_pc_ca(const float* re, const float* im, float* thr,
                         uint8_t* peaks, int frames, cudaStream_t stream,
                         const float* tw, const float* h, int log2n,
                         float scale, RspCaRegs regs) {
  switch (log2n) {
    case 8:
      return rsp_pc_ca_rows<256>(re, im, thr, peaks, frames, stream, tw, h,
                                 scale, regs);
    case 9:
      return rsp_pc_ca_rows<512>(re, im, thr, peaks, frames, stream, tw, h,
                                 scale, regs);
    case 10:
      return rsp_pc_ca_rows<1024>(re, im, thr, peaks, frames, stream, tw, h,
                                  scale, regs);
    case 11:
      return rsp_pc_ca_rows<2048>(re, im, thr, peaks, frames, stream, tw, h,
                                  scale, regs);
    case 12:
      return rsp_pc_ca_rows<4096>(re, im, thr, peaks, frames, stream, tw, h,
                                  scale, regs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
