// Kernel B: magnitude + CA/GO/SO CFAR on a spectrum, 16 contiguous cells a
// thread, by the run-sum tail of row_fft.cuh.
//
// Replaces rsp_chains_tpu/kernels/cfar_pallas.py::fused_mag_cfar (:489,
// pallas_call :555, body `_kernel` :460). The chain takes it for a shrunken
// FFT-size register, on the spectrum of the unfused FFT
// (chain_pallas.py:1422-1424); it is also the CA tail of the GOSCA
// elaborations' CA-like registers, of the range-Doppler map, of pulse
// compression's shrunken size and of the range-sharded chains.
//
// Bound on the H100: device memory. Each complex sample costs 13 bytes (8 read
// as two float32 planes, 4 + 1 written as threshold and peak) against a few
// dozen flops, far below the card's flop-per-byte balance. Summing each
// cell's two windows straight from shared memory (2w reads a cell, about
// 1.1e9 a call at w = 32 and 64 x 256 x 1024) took 0.17 ms there, 2.6x the
// bytes' 0.065; the design reads each sample once, writes each output once,
// and keeps the shared-memory reads near w + 16 a side for 16 cells, so the
// kernel runs near its bytes (chip_smoke.py `tail_times`). A call from
// Python then costs about as much host time (the wrapper) as card time:
//
// * A row of N <= 4096 cells is N / 16 threads, 16 contiguous cells a
//   thread, and a block holds 256 / (N / 16) rows (32 at N = 128, one at
//   4096). A thread loads its cells as four float4 a plane, takes their
//   magnitude and stores it to the row's padded magnitude row
//   (`rsp_mag_slot`, one float in 16: the 16-cell runs of a warp's lanes
//   fall in distinct banks); the CA tail is `rsp_ca_row` of row_fft.cuh
//   (`rsp_ca_runs`: the cells every window of a run holds summed once, the
//   edges as running sums; float4 / uint4 stores).
// * A longer row is cut into tiles of RSP_B_TILE cells, one a block of 256
//   threads; a tile reads RSP_PAD cells on either side from device memory
//   (the magnitude of the neighbouring cells inside the frame and the
//   active range, zero elsewhere), so its windows and its neighbours for
//   peak grouping are those of the whole row. Any N % 128 == 0 runs.
//
// The active range [active_lo, active_hi) is in frame coordinates; a tile
// takes it shifted to its own. Relative to summing each window directly,
// only the order of the fp32 additions changes.
//
// `kGiven` is the range-sharded tail's "magnitude given" input (the TPU
// kernel's MAG_PASSTHROUGH code, cfar_pallas.py:106): `re` already holds the
// magnitude row that Kernel L (halo.cu) extended, and `im` is not read. It is
// an argument of the entry, never a register value.
#include <cuda_runtime.h>

#include "ca_cfar.cuh"
#include "row_fft.cuh"

// Cells of a tile of a row longer than this (a multiple of 128).
#define RSP_B_TILE 4096

// Blocks an SM in the launch bounds (64 registers at 4, no spills); of 1 to
// 4 it ran fastest at 4 (chip_smoke.py `row_blocks`).
#ifndef RSP_B_BLOCKS
#define RSP_B_BLOCKS 4
#endif

// The magnitude of the sample at index c of the planes re, im, or with
// kGiven the value of re there.
template <bool kGiven>
static __device__ __forceinline__ float rsp_b_mag(const float* re,
                                                  const float* im, size_t c,
                                                  int mode) {
  return kGiven ? __ldg(re + c) : rsp_magnitude(__ldg(re + c), __ldg(im + c),
                                                mode);
}

// v[0 .. 16) = p[0 .. 16), p 16-byte aligned, as four float4.
static __device__ __forceinline__ void rsp_load16(const float* p, float* v) {
  const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 a = __ldg(p4 + k);
    v[4 * k] = a.x;
    v[4 * k + 1] = a.y;
    v[4 * k + 2] = a.z;
    v[4 * k + 3] = a.w;
  }
}

// Frames of n cells; `len` cells a tile (n, or RSP_B_TILE when n is longer),
// `rows` tiles a block of rows * len / 16 threads. Grid: ceil(frames / rows)
// blocks, or frames * ceil(n / len) when n > len (rows = 1).
template <bool kGiven>
__global__ void __launch_bounds__(RSP_THREADS, RSP_B_BLOCKS)
rsp_mag_cfar_kernel(const float* __restrict__ re, const float* __restrict__ im,
                    float* __restrict__ thr, uint8_t* __restrict__ peaks,
                    int frames, int n, int len, int rows, RspCaRegs r) {
  extern __shared__ float smem[];
  const int t = len / 16;  // threads a tile
  const int q = threadIdx.x / t, m = threadIdx.x % t;
  const int tiles = (n + len - 1) / len;
  const int row = rows > 1 ? blockIdx.x * rows + q : blockIdx.x / tiles;
  const int start = rows > 1 ? 0 : blockIdx.x % tiles * len;
  const int cells = min(len, n - start);  // this tile's cells
  const bool live = row < frames;
  const size_t base = (size_t)row * n + start;
  const int lo = r.active_lo - start, hi = r.active_hi - start;  // local
  float* rw = smem + q * rsp_mag_floats(len);

  // the margins: cells -RSP_PAD .. -1 and cells .. cells + RSP_PAD - 1
  for (int j = m; j < 2 * RSP_PAD; j += t) {
    const int c = j < RSP_PAD ? j - RSP_PAD : cells + j - RSP_PAD;
    const bool in = live && c >= lo && c < hi && start + c >= 0 &&
                    start + c < n;
    rw[rsp_mag_slot(RSP_PAD + c)] =
        in ? rsp_b_mag<kGiven>(re, im, base + c, r.mag_mode) : 0.0f;
  }
  // the thread's 16 cells, four float4 a plane
  const int i0 = 16 * m;
  const bool mine = live && i0 < cells;
  if (mine) {
    float v[16];
    rsp_load16(re + base + i0, v);
    if constexpr (!kGiven) {
      float vi[16];
      rsp_load16(im + base + i0, vi);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        v[j] = rsp_magnitude(v[j], vi[j], r.mag_mode);
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = i0 + j;
      rw[rsp_mag_slot(RSP_PAD + c)] = c >= lo && c < hi ? v[j] : 0.0f;
    }
  }
  __syncthreads();
  if (!mine) return;
  RspCaRegs rl = r;
  rl.active_lo = lo;
  rl.active_hi = hi;
  rsp_ca_row(rw, m, rl, thr + base, peaks + base);
}

template <bool kGiven>
static int rsp_mag_cfar_launch(const float* re, const float* im, float* thr,
                               uint8_t* peaks, int frames, cudaStream_t stream,
                               int n, RspCaRegs regs) {
  if (n <= 0 || n % 128) return (int)cudaErrorInvalidValue;
  const int len = n <= RSP_B_TILE ? n : RSP_B_TILE;
  const int rows = n <= RSP_B_TILE ? RSP_THREADS / (len / 16) : 1;
  const size_t blocks = n <= RSP_B_TILE
                            ? ((size_t)frames + rows - 1) / rows
                            : (size_t)frames * ((n + len - 1) / len);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)rows * rsp_mag_floats(len) * sizeof(float);
  const cudaError_t e = rsp_opt_in(rsp_mag_cfar_kernel<kGiven>, smem);
  if (e != cudaSuccess) return (int)e;
  rsp_mag_cfar_kernel<kGiven><<<(unsigned)blocks, rows * (len / 16), smem,
                                stream>>>(re, im, thr, peaks, frames, n, len,
                                          rows, regs);
  return (int)cudaGetLastError();
}

// re, im, thr: float32 [frames, n]; peaks: uint8 [frames, n]; all contiguous
// on the current device and 16-byte aligned; n a multiple of 128. With
// `mag_given` nonzero, re holds the magnitude and im may be null. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int rsp_mag_cfar(const float* re, const float* im, float* thr,
                            uint8_t* peaks, int frames, cudaStream_t stream,
                            int n, RspCaRegs regs, int mag_given) {
  return mag_given ? rsp_mag_cfar_launch<true>(re, im, thr, peaks, frames,
                                               stream, n, regs)
                   : rsp_mag_cfar_launch<false>(re, im, thr, peaks, frames,
                                                stream, n, regs);
}
