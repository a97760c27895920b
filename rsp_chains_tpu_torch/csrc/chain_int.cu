// Kernel F: the bit-true integer CA chain, integer FFT -> magnitude ->
// CA/GO/SO CFAR.
//
// Replaces rsp_chains_tpu/kernels/int_chain_pallas.py::fused_chain_int (:441,
// pallas_call :512; body `_int_chain_kernel` :241 with `_int_front` :131 and
// `_int_thr_peaks_tail` :207). Exact: the arithmetic is ops/bit_true.py's,
// operation for operation (int_front.cuh).
//
// Bound on the H100: a sample costs 13 bytes (two int32 planes in, an int32
// threshold and a peak byte out); the bit-true butterfly (int_front.cuh
// `rsp_int_butterfly`) folds to 17 integer operations at the bench's stage
// flags (no expanding or keepLSB stage; the sum side's unity twiddle is a
// sign extension), N/2 log2 N of them a frame, so at N = 1024 the bytes
// (0.065 ms at 64 x 256 frames) outweigh the operations (0.043 ms). The TPU
// computes the butterflies with lane rotations and the bit reversal with
// log2(N)/2 transposition steps because Mosaic has no per-lane gather. This
// file holds the route of N = 256, 512, 1024 (rsp_chain_int_rows_kernel<N>,
// entry rsp_chain_int_rows): the row plan of row_fft.cuh, N / 16 threads a
// frame and 256 / (N / 16) frames a block, each stage's butterflies in
// registers, 1 or 2 exchanges through shared memory (int_rows.cuh), the
// magnitude stored at its natural bin (__brev) and the integer run-sum CA
// tail; 55,296 bytes of shared memory a block at N = 1024; three blocks an
// SM (RSP_ROWS_BLOCKS; 80 registers, no spills), the fastest of 1 to 4
// (chip_smoke.py `row_blocks`). The host (kernels/int_chain.py) picks the
// route by N alone: frames of 2048-16384 take int_mid.cu (one launch, 8192
// cells a block in registers), longer ones int_split.cu.
#include <cuda_runtime.h>

#include "int_rows.cuh"

// Kernel F over `frames` frames of kN cells. Grid ceil(frames / kRows).
template <int kN>
__global__ void __launch_bounds__(RSP_THREADS, RSP_ROWS_BLOCKS)
rsp_chain_int_rows_kernel(const int* __restrict__ re,
                          const int* __restrict__ im,
                          const int2* __restrict__ tw, int* __restrict__ thr,
                          uint8_t* __restrict__ peaks, int frames,
                          unsigned expand_mask, unsigned lsb_mask,
                          RspIntRegs r) {
  using P = RspRowPlan<kN>;
  constexpr int T = P::kT;
  extern __shared__ int ismem[];
  const int q = threadIdx.x / T, m = threadIdx.x % T;
  const int row = blockIdx.x * P::kRows + q;
  const bool live = row < frames;
  const size_t base = (size_t)row * kN;
  int* pr = ismem + q * P::kS;  // this frame's planes of the FFT buffer
  int* pi = pr + P::kRows * P::kS;
  int* rw = ismem + 2 * P::kRows * P::kS + q * P::kMagS;

  rsp_int_front_rows<kN>(re, im, base, live, m, tw, pr, pi, rw, expand_mask,
                         lsb_mask, r);
  if (!live) return;
  int* t = thr + base;
  uint8_t* pk = peaks + base;
  switch (r.log2w) {
    case 0: rsp_int_ca_runs<1>(rw, 16 * m, r, t, pk); break;
    case 1: rsp_int_ca_runs<2>(rw, 16 * m, r, t, pk); break;
    case 2: rsp_int_ca_runs<4>(rw, 16 * m, r, t, pk); break;
    case 3: rsp_int_ca_runs<8>(rw, 16 * m, r, t, pk); break;
    default: rsp_int_ca_runs<16>(rw, 16 * m, r, t, pk); break;
  }
}

template <int kN>
static int rsp_chain_int_rows_launch(const int* re, const int* im, int* thr,
                                     uint8_t* peaks, int frames,
                                     cudaStream_t stream, const int* tw,
                                     unsigned expand_mask, unsigned lsb_mask,
                                     RspIntRegs regs) {
  using P = RspRowPlan<kN>;
  const size_t smem = (size_t)P::kRows * (2 * P::kS + P::kMagS) * sizeof(int);
  const cudaError_t e = rsp_opt_in(rsp_chain_int_rows_kernel<kN>, smem);
  if (e != cudaSuccess) return (int)e;
  rsp_chain_int_rows_kernel<kN><<<(frames + P::kRows - 1) / P::kRows,
                                  RSP_THREADS, smem, stream>>>(
      re, im, reinterpret_cast<const int2*>(tw), thr, peaks, frames,
      expand_mask, lsb_mask, regs);
  return (int)cudaGetLastError();
}

// re, im, thr: int32 [frames, 2^log2n]; peaks: uint8 [frames, 2^log2n];
// tw: int32 [2^log2n, 2] (int_front.cuh); all contiguous on the current
// device, 8 <= log2n <= 10. Launches on `stream`; returns
// cudaGetLastError().
extern "C" int rsp_chain_int_rows(const int* re, const int* im, int* thr,
                                  uint8_t* peaks, int frames,
                                  cudaStream_t stream, const int* tw,
                                  int log2n, int expand_mask, int lsb_mask,
                                  RspIntRegs regs) {
  const unsigned em = (unsigned)expand_mask, lm = (unsigned)lsb_mask;
  switch (log2n) {
    case 8:
      return rsp_chain_int_rows_launch<256>(re, im, thr, peaks, frames,
                                            stream, tw, em, lm, regs);
    case 9:
      return rsp_chain_int_rows_launch<512>(re, im, thr, peaks, frames,
                                            stream, tw, em, lm, regs);
    case 10:
      return rsp_chain_int_rows_launch<1024>(re, im, thr, peaks, frames,
                                             stream, tw, em, lm, regs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
