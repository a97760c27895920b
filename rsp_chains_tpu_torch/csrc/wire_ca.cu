// Kernel E: the wire top's whole CA chain, packed IQ beat words in, packed
// {threshold | bin | peak} words out, over frames of N = 256, 512 or 1024.
//
// Replaces rsp_chains_tpu/kernels/chain_pallas.py::fused_chain_ca_packed
// (:1042, pallas_call :1122; body `_chain_kernel_packed` :742-800). It is
// Kernel A (chain_ca.cu) with another load and another store: each word
// holds the real part in bits [31:16] and the imaginary part in [15:0], each
// sign-extended; each cell's output word holds the threshold clipped to
// [0, 2^(31 - log2n) - 1] and truncated in bits [31:log2n+1], the natural
// bin in [log2n:1] and the peak in bit 0.
//
// Bound on the H100: device memory. A sample costs 8 bytes (a 4-byte word in,
// a 4-byte word out) against Kernel A's 13, for the same FFT, magnitude and
// CA work (5 N log2 N flops a frame, about 6 flops a byte at N = 1024).
//
// Design (rsp_wire_ca_rows_kernel<N>): A's row plan of row_fft.cuh, N / 16
// threads a frame, 256 / (N / 16) frames a block, 16 cells a thread. Pass 1
// of the forward transform (`rsp_row_forward_with`) loads words[m + T j]: one
// coalesced 4-byte load a cell, unpacked in registers, so the words never
// pass through shared memory. The scale, the magnitude and its scatter to
// the natural bin (`rsp_row_bin`) are A's, and so is the run-sum CA tail
// (`rsp_ca_row_with`); its store (RspWireStore) packs the 16 thresholds,
// bins and peaks of a run into 16 words, four uint4 stores. The bins are the
// tail's cells, so a wrong scatter shows in the bin field too. Shared memory
// as A: 55,296 bytes a block at N = 1024. Four blocks an SM (RSP_E_BLOCKS;
// 64 registers, no spills): of 1 to 4 it ran fastest at four, 2 % ahead of
// three, where A is fastest at three (chip_smoke.py `row_blocks`).
#include <cuda_runtime.h>

#include "ca_cfar.cuh"
#include "row_fft.cuh"

#ifndef RSP_E_BLOCKS
#define RSP_E_BLOCKS 4
#endif

// The store of a 16-cell run as packed CFAR words (frames of 2^kLog2N
// cells): the threshold clipped to [0, 2^(31 - kLog2N) - 1] and truncated,
// the bin, the peak bit; out + i0 16-byte aligned.
template <int kLog2N>
struct RspWireStore {
  uint32_t* out;
  __device__ __forceinline__ void operator()(int i0, const float (&t)[16],
                                             const uint32_t (&pk)[4]) const {
    const float thr_max = (float)((1u << (31 - kLog2N)) - 1u);
    uint32_t v[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const uint32_t ti = (uint32_t)fminf(fmaxf(t[j], 0.0f), thr_max);
      v[j] = (ti << (kLog2N + 1)) | ((uint32_t)(i0 + j) << 1)
             | ((pk[j >> 2] >> (8 * (j & 3))) & 1u);
    }
    uint4* o4 = reinterpret_cast<uint4*>(out + i0);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      o4[q] = make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  }
};

// Kernel E over `frames` frames of kN words. tw: the pass twiddles of
// kernels/chain.py `row_twiddles(kN)`. Grid ceil(frames / kRows).
template <int kN>
__global__ void __launch_bounds__(RSP_THREADS, RSP_E_BLOCKS)
rsp_wire_ca_rows_kernel(const uint32_t* __restrict__ words,
                        const float2* __restrict__ tw,
                        uint32_t* __restrict__ out, int frames, float scale,
                        RspCaRegs r) {
  using P = RspRowPlan<kN>;
  constexpr int T = P::kT;
  constexpr int kLog2N = kN == 256 ? 8 : kN == 512 ? 9 : 10;
  extern __shared__ float smem[];
  const int q = threadIdx.x / T, m = threadIdx.x % T;
  const int row = blockIdx.x * P::kRows + q;
  const bool live = row < frames;
  const size_t base = (size_t)row * kN;
  float* pr = smem + q * P::kS;  // this frame's planes of the FFT buffer
  float* pi = pr + P::kRows * P::kS;
  float* rw = smem + 2 * P::kRows * P::kS + q * P::kMagS;
  float xr[16], xi[16];

  // sign-extend each half on unsigned values: a left shift of a negative
  // int is undefined in C++17
  rsp_row_forward_with<kN>(
      [&](int j, float& re, float& im) {
        const uint32_t w = live ? words[base + m + T * j] : 0u;
        re = (float)(int16_t)(uint16_t)(w >> 16);
        im = (float)(int16_t)(uint16_t)(w & 0xFFFFu);
      },
      m, tw, pr, pi, xr, xi);
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
  rsp_ca_row_with(rw, m, r, RspWireStore<kLog2N>{out + base});
}

template <int kN>
static int rsp_wire_ca_rows(const uint32_t* words, uint32_t* out, int frames,
                            cudaStream_t stream, const float* tw, float scale,
                            RspCaRegs regs) {
  using P = RspRowPlan<kN>;
  const size_t smem = (size_t)P::kRows * (2 * P::kS + P::kMagS) * sizeof(float);
  const cudaError_t e = rsp_opt_in(rsp_wire_ca_rows_kernel<kN>, smem);
  if (e != cudaSuccess) return (int)e;
  rsp_wire_ca_rows_kernel<kN><<<(frames + P::kRows - 1) / P::kRows,
                                RSP_THREADS, smem, stream>>>(
      words, reinterpret_cast<const float2*>(tw), out, frames, scale, regs);
  return (int)cudaGetLastError();
}

// words, out: uint32 [frames, 2^log2n] (the int32 view of the same bits is
// passed by the wrapper); tw: float32 [2^log2n + 16 * 2^(log2n-8), 2]
// (cos, sin), the pass twiddles of kernels/chain.py `row_twiddles`; all
// contiguous on the current device, 8 <= log2n <= 10. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int rsp_wire_ca(const uint32_t* words, uint32_t* out, int frames,
                           cudaStream_t stream, const float* tw, int log2n,
                           float scale, RspCaRegs regs) {
  switch (log2n) {
    case 8:
      return rsp_wire_ca_rows<256>(words, out, frames, stream, tw, scale,
                                   regs);
    case 9:
      return rsp_wire_ca_rows<512>(words, out, frames, stream, tw, scale,
                                   regs);
    case 10:
      return rsp_wire_ca_rows<1024>(words, out, frames, stream, tw, scale,
                                    regs);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
