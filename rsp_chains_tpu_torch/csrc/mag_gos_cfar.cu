// Kernel C: magnitude + GOS / GOSCA / CASH CFAR on a spectrum, one thread
// block per range tile of two frames where the rank selection runs at w <=
// 32, else of one frame.
//
// Replaces rsp_chains_tpu/kernels/cfar_pallas.py::fused_mag_gos_cfar (:1593,
// pallas_call :1716; v3 body `_gos_kernel3` :1286 -> `_gos_rows_init` :1232 +
// `_gos_tail` :1317). The chain takes it for a shrunken FFT-size register
// under GOS or CASH registers, and as the tail of an FFT that does not fuse.
//
// Bound on the H100: the warp-resident rank selection of gos_cfar.cuh, not
// device memory. Each block reads its tile and a RSP_PAD margin on each side
// (the margins come again from L2 for the neighbouring tiles) and writes 5
// bytes a cell. The tile is the largest of 1024, 512 and 256 cells that
// divides the frame: a wide tile reads fewer margins again (1280 cells for
// 1024 at the tile of 1024, against 2048 at the tile of 256) and gives each
// warp a longer run of window starts to slide over after its sorted first
// window. At w <= 32 with the selection on, a block takes the same tile of
// two frames (frame pairs: a warp slides both frames' windows over the same
// starts, one a half-warp, so the two halves' branches and active ranges
// are one; an odd frame count leaves the last block's second frame dead,
// which stores nothing), in 6 rows of rsp_gos_stride(tile) floats, an odd
// multiple of 16 apart so the halves' words of one instruction lie in
// different banks: 31,104 bytes at the tile of 1024. The CA sums, CASH and
// w = 64 keep a block a frame (3 rows, 15,552 bytes), whose phases two
// frames would only lengthen. Every multiple of 256 runs, the
// halo-extended 1280 included.
//
// `kGiven`: the range-sharded tail's "magnitude given" input, as in
// mag_cfar.cu: `re` holds the magnitude, `im` is not read.
#include <cuda_runtime.h>

#include "gos_cfar.cuh"

// The stride of Kernel C's six shared rows for a tile: the tile and its
// margins (a multiple of 256 floats) and 16 more, an odd multiple of 16.
static __host__ __device__ constexpr int rsp_gos_stride(int tile) {
  return tile + 2 * RSP_PAD + 16;
}

template <bool kGiven, int kPair>
__global__ void __launch_bounds__(RSP_THREADS)
rsp_mag_gos_cfar_kernel(const float* __restrict__ re,
                        const float* __restrict__ im, float* __restrict__ thr,
                        uint8_t* __restrict__ peaks, int frames, int n,
                        int tile, RspGosRegs r) {
  extern __shared__ float smem[];
  const int slab = tile + 2 * RSP_PAD, stride = rsp_gos_stride(tile);
  const int tiles = n / tile;
  const int f0 = kPair * (int)(blockIdx.x / tiles);  // the block's first frame
  const int live = min(kPair, frames - f0);
  const size_t base = (size_t)f0 * n;
  const int ts = (int)(blockIdx.x % tiles) * tile;

  // the frames' magnitude rows; a dead second frame's zeros
  for (int j = threadIdx.x; j < kPair * slab; j += blockDim.x) {
    const int f = j < slab ? 0 : 1, k = j - f * slab;
    const int i = ts - RSP_PAD + k;
    const bool active = f < live && i >= r.active_lo && i < r.active_hi &&
                        i >= 0 && i < n;
    float m = 0.0f;
    if (active) {
      const size_t o = base + (size_t)f * n + i;
      m = kGiven ? re[o] : rsp_magnitude(re[o], im[o], r.mag_mode);
    }
    smem[f * stride + k] = m;
  }
  __syncthreads();
  rsp_gos_tail<kPair>(smem, stride, live, ts, tile, n, r, thr + base + ts,
                      peaks + base + ts);
}

template <bool kGiven, int kPair>
static int rsp_mag_gos_cfar_launch(const float* re, const float* im,
                                   float* thr, uint8_t* peaks, int frames,
                                   cudaStream_t stream, int n, int tile,
                                   RspGosRegs regs) {
  const long long blocks =
      (long long)((frames + kPair - 1) / kPair) * (n / tile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)3 * kPair * rsp_gos_stride(tile) * sizeof(float);
  rsp_mag_gos_cfar_kernel<kGiven, kPair><<<(unsigned)blocks, RSP_THREADS,
                                           smem, stream>>>(
      re, im, thr, peaks, frames, n, tile, regs);
  return (int)cudaGetLastError();
}

// re, im, thr: float32 [frames, n]; peaks: uint8 [frames, n]; all contiguous
// on the current device, n a multiple of RSP_GOS_TILE. With `mag_given`
// nonzero, re holds the magnitude and im may be null. Launches on `stream`
// and returns cudaGetLastError().
extern "C" int rsp_mag_gos_cfar(const float* re, const float* im, float* thr,
                                uint8_t* peaks, int frames,
                                cudaStream_t stream, int n, RspGosRegs regs,
                                int mag_given) {
  const int tile = n % (4 * RSP_GOS_TILE) == 0   ? 4 * RSP_GOS_TILE
                   : n % (2 * RSP_GOS_TILE) == 0 ? 2 * RSP_GOS_TILE
                                                 : RSP_GOS_TILE;
  // two frames a block where the rank selection runs at w <= 32 (frame
  // pairs), else one
  const bool pair =
      regs.algorithm == 1 && regs.cfar_mode != 3 && regs.log2w <= 5;
  if (mag_given)
    return pair ? rsp_mag_gos_cfar_launch<true, 2>(re, im, thr, peaks, frames,
                                                   stream, n, tile, regs)
                : rsp_mag_gos_cfar_launch<true, 1>(re, im, thr, peaks, frames,
                                                   stream, n, tile, regs);
  return pair ? rsp_mag_gos_cfar_launch<false, 2>(re, im, thr, peaks, frames,
                                                  stream, n, tile, regs)
              : rsp_mag_gos_cfar_launch<false, 1>(re, im, thr, peaks, frames,
                                                  stream, n, tile, regs);
}
