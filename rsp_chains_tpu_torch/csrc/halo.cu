// Kernels K and L: the halo of a range-sharded block, read from its ring
// neighbours' memory.
//
// Kernel K, rsp_halo_exchange: the left neighbour's last `halo` columns and
// the right neighbour's first `halo` columns of a [frames, n_loc] block.
// Replaces rsp_chains_tpu/kernels/pallas_halo.py::halo_exchange_rdma (:124,
// pallas_call :140, body `_exchange_kernel` :107).
//
// Kernel L, rsp_mag_extend: the extended magnitude row [halo | n_loc | halo]
// of a range-sharded spectrum block: the local magnitude and the neighbours'
// halo magnitudes. Replaces pallas_halo.py::mag_extend_rdma (:177,
// pallas_call :197, body `_mag_extend_kernel` :156).
//
// Pull, not push. The TPU kernels push each shard's edges into its
// neighbours' buffers by remote DMA and zero the received halos at the global
// frame ends afterwards (`_edge_zero` :115, :221-227). Here a shard's kernel
// reads its neighbours' blocks through device pointers that the wrapper
// (kernels/halo.py) passes: local ones for the virtual shards of one card,
// peer ones over NVLink for shards on other cards of the host (peer access
// enabled by rsp_enable_peer_access). An absent neighbour, at a global frame
// end, comes as a null pointer and its cells are written as zeros: the same
// result without a wrapped read.
//
// Overlap. The TPU kernel starts its halo DMAs and computes the local
// magnitude while they fly. Here every thread computes one extended cell:
// the warps over the halo bands issue their (possibly remote) loads beside
// the interior warps' local ones, and the card's many warps in flight hide
// the remote latency behind the interior's work.
//
// Ordering and lifetime take the place of the TPU kernel's neighbour barrier
// (`_start_halo_rdma` :72-80), on the host: before the launch the reader's
// stream waits on an event recorded on each neighbour's current stream (its
// producer), and after it each neighbour's current stream waits on an event
// recorded after the read, so the caching allocator cannot hand a
// neighbour's block to new work on its own stream before the read is done.
//
// Bound on the H100: device memory (or the peer link for remote halos).
// Kernel L reads 8 bytes a local and a halo cell and writes 4 bytes an
// extended cell, against at most a dozen flops a cell; Kernel K reads and
// writes 4 bytes a halo cell. Each cell is read once and written once, with
// neighbouring threads on neighbouring addresses.
#include <cuda_runtime.h>

#include "ca_cfar.cuh"

#define RSP_HALO_THREADS 256
// enough blocks to fill the card several times over; the rest is a
// grid-stride loop
#define RSP_HALO_MAX_BLOCKS (132 * 32)

static inline unsigned rsp_halo_blocks(long long cells) {
  long long b = (cells + RSP_HALO_THREADS - 1) / RSP_HALO_THREADS;
  if (b > RSP_HALO_MAX_BLOCKS) b = RSP_HALO_MAX_BLOCKS;
  return (unsigned)(b > 0 ? b : 1);
}

__global__ void __launch_bounds__(RSP_HALO_THREADS)
rsp_halo_exchange_kernel(const float* __restrict__ left_nb,
                         const float* __restrict__ right_nb,
                         float* __restrict__ left, float* __restrict__ right,
                         long long frames, int n_loc, int halo) {
  const long long cells = frames * halo;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < cells; t += (long long)gridDim.x * blockDim.x) {
    const long long f = t / halo;
    const int j = (int)(t - f * halo);
    const size_t row = (size_t)f * n_loc;
    left[t] = left_nb ? left_nb[row + n_loc - halo + j] : 0.0f;
    right[t] = right_nb ? right_nb[row + j] : 0.0f;
  }
}

__global__ void __launch_bounds__(RSP_HALO_THREADS)
rsp_mag_extend_kernel(const float* __restrict__ re,
                      const float* __restrict__ im,
                      const float* __restrict__ lre,
                      const float* __restrict__ lim,
                      const float* __restrict__ rre,
                      const float* __restrict__ rim, float* __restrict__ out,
                      long long frames, int n_loc, int halo, int mag_mode) {
  const int n_ext = n_loc + 2 * halo;
  const long long cells = frames * n_ext;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < cells; t += (long long)gridDim.x * blockDim.x) {
    const long long f = t / n_ext;
    const int c = (int)(t - f * n_ext);
    const float* pr;
    const float* pi;
    int col;
    if (c < halo) {  // the left neighbour's last halo columns
      pr = lre;
      pi = lim;
      col = n_loc - halo + c;
    } else if (c < halo + n_loc) {  // the local block
      pr = re;
      pi = im;
      col = c - halo;
    } else {  // the right neighbour's first halo columns
      pr = rre;
      pi = rim;
      col = c - halo - n_loc;
    }
    const size_t at = (size_t)f * n_loc + col;
    out[t] = pr ? rsp_magnitude(pr[at], pi[at], mag_mode) : 0.0f;
  }
}

// Kernel K. left_nb, right_nb: the neighbours' float32 [frames, n_loc]
// blocks, or null at a global frame end; left, right: float32
// [frames, halo] on the current device; 0 < halo <= n_loc. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int rsp_halo_exchange(const float* left_nb, const float* right_nb,
                                 float* left, float* right, int frames,
                                 cudaStream_t stream, int n_loc, int halo) {
  const long long cells = (long long)frames * halo;
  rsp_halo_exchange_kernel<<<rsp_halo_blocks(cells), RSP_HALO_THREADS, 0,
                             stream>>>(left_nb, right_nb, left, right, frames,
                                       n_loc, halo);
  return (int)cudaGetLastError();
}

// Kernel L. re, im: the local float32 [frames, n_loc] spectrum planes;
// lre/lim, rre/rim: the left and right neighbours' planes, null at a global
// frame end; out: float32 [frames, halo + n_loc + halo] on the current
// device; 0 <= halo <= n_loc; mag_mode 0..3 (clipped on the host). Launches
// on `stream` and returns cudaGetLastError().
extern "C" int rsp_mag_extend(const float* re, const float* im,
                              const float* lre, const float* lim,
                              const float* rre, const float* rim, float* out,
                              int frames, cudaStream_t stream, int n_loc,
                              int halo, int mag_mode) {
  const long long cells = (long long)frames * (n_loc + 2 * halo);
  rsp_mag_extend_kernel<<<rsp_halo_blocks(cells), RSP_HALO_THREADS, 0,
                          stream>>>(re, im, lre, lim, rre, rim, out, frames,
                                    n_loc, halo, mag_mode);
  return (int)cudaGetLastError();
}

// Lets `dev` read `peer`'s memory: 0 when it can (access enabled now or
// before), cudaErrorPeerAccessUnsupported when the pair cannot reach each
// other, else the CUDA error. The caller's current device is kept.
extern "C" int rsp_enable_peer_access(int dev, int peer) {
  int can = 0;
  cudaError_t e = cudaDeviceCanAccessPeer(&can, dev, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  int cur = 0;
  e = cudaGetDevice(&cur);
  if (e != cudaSuccess) return (int)e;
  e = cudaSetDevice(dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the error the refused call recorded
    e = cudaSuccess;
  }
  cudaError_t back = cudaSetDevice(cur);
  return (int)(e != cudaSuccess ? e : back);
}
