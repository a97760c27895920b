// Kernel C: magnitude + GOS / GOSCA / CASH CFAR on a spectrum, one thread
// block per range tile of one frame.
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
// window. Shared memory stays at 3 * (tile + 2*RSP_PAD) floats, 15,360 bytes
// at most, whatever the frame length, so every multiple of 256 runs, the
// halo-extended 1280 included.
//
// `kGiven`: the range-sharded tail's "magnitude given" input, as in
// mag_cfar.cu: `re` holds the magnitude, `im` is not read.
#include <cuda_runtime.h>

#include "gos_cfar.cuh"

template <bool kGiven>
__global__ void __launch_bounds__(RSP_THREADS)
rsp_mag_gos_cfar_kernel(const float* __restrict__ re,
                        const float* __restrict__ im, float* __restrict__ thr,
                        uint8_t* __restrict__ peaks, int n, int tile,
                        RspGosRegs r) {
  extern __shared__ float smem[];
  const int slab = tile + 2 * RSP_PAD;
  float* row = smem;
  float* st0 = row + slab;
  float* st1 = st0 + slab;
  const int tiles = n / tile;
  const size_t base = (size_t)(blockIdx.x / tiles) * n;
  const int ts = (int)(blockIdx.x % tiles) * tile;

  for (int j = threadIdx.x; j < slab; j += blockDim.x) {
    const int i = ts - RSP_PAD + j;
    const bool active = i >= r.active_lo && i < r.active_hi && i >= 0 && i < n;
    float m = 0.0f;
    if (active)
      m = kGiven ? re[base + i]
                 : rsp_magnitude(re[base + i], im[base + i], r.mag_mode);
    row[j] = m;
  }
  __syncthreads();
  rsp_gos_tail(row, st0, st1, ts, tile, r, thr + base + ts,
               peaks + base + ts);
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
  const long long blocks = (long long)frames * (n / tile);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)3 * (tile + 2 * RSP_PAD) * sizeof(float);
  if (mag_given)
    rsp_mag_gos_cfar_kernel<true><<<(unsigned)blocks, RSP_THREADS, smem,
                                    stream>>>(re, im, thr, peaks, n, tile,
                                              regs);
  else
    rsp_mag_gos_cfar_kernel<false><<<(unsigned)blocks, RSP_THREADS, smem,
                                     stream>>>(re, im, thr, peaks, n, tile,
                                               regs);
  return (int)cudaGetLastError();
}
