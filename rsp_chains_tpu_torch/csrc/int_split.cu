// Kernels F and G for frames of N = 2^L > 16384: the bit-true integer chain
// in three steps through device memory, since the frame no longer fits one
// block's shared memory (F's and G's frame-per-block kernels hold 197,632
// and 199,680 bytes at N = 16384).
//
// Replaces, for those frames, rsp_chains_tpu/kernels/int_chain_pallas.py::
// fused_chain_int (:441, pallas_call :512) and ::fused_chain_int_gos (:552,
// pallas_call :622), which take any power of two N >= 256
// (`int_chain_fusable`, :660-686). The host (kernels/int_chain.py) takes
// this route by N alone.
//
// Exact for the reason the integer FFT is exact anywhere: each radix-2 DIF
// stage rounds each butterfly on its own (ops/bit_true.py `_fft_int_fixed`),
// so the stages may run in any grouping that gives each butterfly its two
// cells, its stage flags and its twiddle. With s = L - 14:
//
// * Head (rsp_int_split_head_kernel<kS>): under DIF stages 0 .. s-1 the
//   cells j + t N/2^s (t < 2^s) of each j < N/2^s form a closed group. A
//   thread takes a group of 2^kS cells at a stride for kS <= 4 stages in
//   registers (`rsp_int_butterfly`, the twiddle tw[half + (cell mod half)],
//   the stage's expand and keepLSB bits), neighbouring threads on
//   neighbouring cells, so loads and stores are coalesced. Beyond four
//   stages (N > 2^18) a further launch takes the next ones, in place.
// * Body (rsp_int_split_body_kernel): each contiguous sub-frame of 16384
//   cells is then an independent DIF transform for stages s .. L-1, whose
//   twiddles W_{2h}^j (h <= 8192) are rows h + j of the same table. A block
//   of 1024 threads runs `rsp_int_fft` on it in shared memory with the
//   masks shifted by s and `grown` already set when a head stage expanded
//   (the one place a shifted mask alone is wrong). Cell q of sub-frame b is
//   bin bitrev_14(q) 2^s + bitrev_s(b); the body writes each bin's integer
//   magnitude (`rsp_int_magnitude`, modes 0-2) to a natural-order int32
//   magnitude row, zero at and beyond n_active.
// * Tail (rsp_int_split_tail_kernel): the magnitude row in tiles of
//   RSP_SPLIT_TILE cells, one a block, each with RSP_PAD cells either side
//   read from device memory (zeros outside the frame), so windows and peak
//   grouping see the whole row: F's CA sums (`rsp_int_ca_sums`, wrapping)
//   or, with the algorithm register at 1, G's rank statistics (`rsp_gos_stats`
//   on int32, INT32_MAX past the active cells), then `rsp_int_combine` and
//   `rsp_int_thr_peak`, active cells [0, n_active) as in F and G.
//
// Bound on the H100: the function moves 13 bytes a sample and its
// butterflies cost 8.5 L integer operations a sample; the route moves 37
// (head 8 + 8, body 8 + 4, tail 4 + 5) and the body's radix-2 stages go
// through shared memory with a barrier a stage. Scratch: 12 bytes a sample
// (the head's two planes, the magnitude row), allocated by the wrapper.
#include <cuda_runtime.h>

#include "gos_cfar.cuh"
#include "int_front.cuh"

#define RSP_SPLIT_LOG2 14         // the body's sub-frame, 16384 cells
#define RSP_SPLIT_THREADS 1024    // the body's block
#define RSP_SPLIT_TILE_LOG2 12    // the tail's tile, 4096 cells

// One stage's butterflies on a thread's kG cells (slot k at frame cell
// first + stride k, `lo` = first mod stride), pairing slots k and k + hs.
template <int kG>
static __device__ __forceinline__ void rsp_split_stage(
    int* xr, int* xi, int lo, int stride, int hs, const int2* __restrict__ tw,
    bool expanding, bool lsb, bool grown) {
  const int half = hs * stride;  // the pair distance in cells
#pragma unroll
  for (int k = 0; k < kG; ++k) {
    if (k & hs) continue;
    const int j = (lo + stride * k) & (half - 1);
    rsp_int_butterfly(xr[k], xi[k], xr[k + hs], xi[k + hs],
                      __ldg(tw + half + j), expanding, lsb, grown);
  }
}

// DIF stages t0 .. t0 + kS - 1 of frames of 2^log2n cells, a group of 2^kS
// cells a thread: `groups` = frames 2^(log2n - kS) threads. re / im may be
// yr / yi (a later head launch runs in place: each thread reads and writes
// only its own cells). `grown`: whether a stage before t0 expanded.
template <int kS>
__global__ void __launch_bounds__(RSP_THREADS)
rsp_int_split_head_kernel(const int* re, const int* im, int* yr, int* yi,
                          const int2* __restrict__ tw, int log2n, int t0,
                          unsigned expand_mask, unsigned lsb_mask, bool grown,
                          size_t groups) {
  constexpr int G = 1 << kS;
  const size_t g = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= groups) return;
  const int sh = log2n - t0 - kS;  // log2 of the stride
  const int stride = 1 << sh;
  const int idx = (int)(g & (((size_t)1 << (log2n - kS)) - 1));
  const int lo = idx & (stride - 1);
  const size_t base = ((g >> (log2n - kS)) << log2n)
                      + ((size_t)(idx >> sh) << (log2n - t0)) + lo;
  int xr[G], xi[G];
#pragma unroll
  for (int k = 0; k < G; ++k) {
    xr[k] = re[base + (size_t)k * stride];
    xi[k] = im[base + (size_t)k * stride];
  }
#pragma unroll
  for (int l = 0; l < kS; ++l) {
    const int hs = (G >> 1) >> l;  // the pair distance in slots
    const int s = t0 + l;
    const bool expanding = (expand_mask >> s) & 1u;
    const bool lsb = !expanding && ((lsb_mask >> s) & 1u);
    grown = grown || expanding;
    // uniform over the launch: a round-half-up stage on data that has not
    // grown folds its flags away
    if (!grown && !lsb)
      rsp_split_stage<G>(xr, xi, lo, stride, hs, tw, false, false, false);
    else
      rsp_split_stage<G>(xr, xi, lo, stride, hs, tw, expanding, lsb, grown);
  }
#pragma unroll
  for (int k = 0; k < G; ++k) {
    yr[base + (size_t)k * stride] = xr[k];
    yi[base + (size_t)k * stride] = xi[k];
  }
}

// Stages s .. log2n - 1 of each sub-frame of 16384 cells of yr / yi (one a
// block, s = log2n - 14), then the magnitude of each bin to its natural
// place in `mag`, zero at and beyond n_active. `grown`: whether a head stage
// expanded.
__global__ void __launch_bounds__(RSP_SPLIT_THREADS)
rsp_int_split_body_kernel(const int* __restrict__ yr,
                          const int* __restrict__ yi,
                          const int2* __restrict__ tw, int* __restrict__ mag,
                          int log2n, unsigned expand_mask, unsigned lsb_mask,
                          bool grown, RspIntRegs r) {
  extern __shared__ int ismem[];
  constexpr int kSub = 1 << RSP_SPLIT_LOG2;
  int* xr = ismem;
  int* xi = ismem + kSub;
  const int s = log2n - RSP_SPLIT_LOG2;
  const size_t sub = blockIdx.x;
  const size_t base = sub << RSP_SPLIT_LOG2;
  const int b = (int)(sub & ((1u << s) - 1u));
  const size_t frame = (sub >> s) << log2n;
  for (int i = threadIdx.x; i < kSub; i += blockDim.x) {
    xr[i] = yr[base + i];
    xi[i] = yi[base + i];
  }
  rsp_int_fft(xr, xi, tw, RSP_SPLIT_LOG2, expand_mask >> s, lsb_mask >> s,
              grown);
  const int rb = __brev(b) >> (32 - s);  // bitrev_s(b); s >= 1
  for (int k = threadIdx.x; k < kSub; k += blockDim.x) {
    const int q = __brev(k) >> (32 - RSP_SPLIT_LOG2);  // the cell of bin k
    const int bin = (k << s) | rb;
    mag[frame + bin] =
        bin < r.n_active ? rsp_int_magnitude(xr[q], xi[q], r.mag_mode) : 0;
  }
}

// Threshold and peaks of each tile of RSP_SPLIT_TILE cells of the magnitude
// rows `mag` (frames of 2^log2n cells), one a block: CA sums, or with the
// algorithm register at 1 the rank statistics of the active cells.
__global__ void __launch_bounds__(RSP_THREADS)
rsp_int_split_tail_kernel(const int* __restrict__ mag, int* __restrict__ thr,
                          uint8_t* __restrict__ peaks, int log2n,
                          RspIntRegs r) {
  extern __shared__ int ismem[];
  constexpr int T = 1 << RSP_SPLIT_TILE_LOG2, S = T + 2 * RSP_PAD;
  const int n = 1 << log2n;
  const int per = log2n - RSP_SPLIT_TILE_LOG2;  // log2 of tiles a frame
  const size_t frame = (size_t)(blockIdx.x >> per) << log2n;
  const int ts = (int)(blockIdx.x & ((1u << per) - 1u)) << RSP_SPLIT_TILE_LOG2;
  int* row = ismem;  // cells ts - RSP_PAD .. ts + T + RSP_PAD - 1
  int* st0 = row + S;  // by window start, like `row` (algorithm 1)
  int* st1 = st0 + S;
  for (int k = threadIdx.x; k < S; k += blockDim.x) {
    const int c = ts - RSP_PAD + k;
    row[k] = c >= 0 && c < n ? mag[frame + c] : 0;
  }
  __syncthreads();

  const int w = 1 << r.log2w, g = r.guard, hi = r.n_active;
  if (r.algorithm == 1) {
    // st0[k] / st1[k]: the lag / lead rank statistic of the window of row
    // cells k .. k + w - 1 over the active cells [0, hi)
    rsp_gos_stats(row, st0, st1, RSP_PAD - g - w, RSP_PAD + T + g + 1, w,
                  RSP_PAD - ts, RSP_PAD - ts + hi, r.rank_lagg, r.rank_lead);
    __syncthreads();
  }
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    const int i = ts + j;
    const size_t o = frame + i;
    if (i >= hi) {
      thr[o] = 0;
      peaks[o] = 0;
      continue;
    }
    const int k = RSP_PAD + j;
    const int* c = row + k;
    int s_lag, s_lead;
    if (r.algorithm == 1) {
      s_lag = st0[k - g - w];
      s_lead = st1[k + g + 1];
    } else {
      int lag, lead;
      rsp_int_ca_sums(c, g, w, lag, lead);
      s_lag = lag >> r.div_sum;
      s_lead = lead >> r.div_sum;
    }
    int t;
    uint8_t pk;
    rsp_int_thr_peak(c, i, rsp_int_combine(r.cfar_mode, s_lag, s_lead), r, t,
                     pk);
    thr[o] = t;
    peaks[o] = pk;
  }
}

// re, im, thr: int32 [frames, 2^log2n]; peaks: uint8 [frames, 2^log2n];
// tw: int32 [2^log2n, 2] (see rsp_int_fft); scratch: int32 [3, frames,
// 2^log2n]; all contiguous on the current device, 15 <= log2n <= 30. The
// algorithm register picks F's CA sums (0) or G's rank statistics (1).
// Launches the head (one launch a group of up to four stages), the body and
// the tail on `stream`; returns the first cudaGetLastError() that fails.
extern "C" int rsp_int_split(const int* re, const int* im, int* thr,
                             uint8_t* peaks, int frames, cudaStream_t stream,
                             const int* tw, int log2n, int expand_mask,
                             int lsb_mask, RspIntRegs regs, int* scratch) {
  if (log2n <= RSP_SPLIT_LOG2 || log2n > 30) return (int)cudaErrorInvalidValue;
  const int s = log2n - RSP_SPLIT_LOG2;
  const unsigned em = (unsigned)expand_mask, lm = (unsigned)lsb_mask;
  const size_t cells = (size_t)frames << log2n;
  int* yr = scratch;
  int* yi = scratch + cells;
  int* mag = yi + cells;
  const int2* tw2 = reinterpret_cast<const int2*>(tw);
  cudaError_t e;

  const int* xr = re;
  const int* xi = im;
  for (int t0 = 0; t0 < s; t0 += 4) {
    const int k = min(4, s - t0);
    const bool grown = (em & ((1u << t0) - 1u)) != 0u;
    const size_t groups = cells >> k;
    const unsigned blocks =
        (unsigned)((groups + RSP_THREADS - 1) / RSP_THREADS);
    switch (k) {
      case 1:
        rsp_int_split_head_kernel<1><<<blocks, RSP_THREADS, 0, stream>>>(
            xr, xi, yr, yi, tw2, log2n, t0, em, lm, grown, groups);
        break;
      case 2:
        rsp_int_split_head_kernel<2><<<blocks, RSP_THREADS, 0, stream>>>(
            xr, xi, yr, yi, tw2, log2n, t0, em, lm, grown, groups);
        break;
      case 3:
        rsp_int_split_head_kernel<3><<<blocks, RSP_THREADS, 0, stream>>>(
            xr, xi, yr, yi, tw2, log2n, t0, em, lm, grown, groups);
        break;
      default:
        rsp_int_split_head_kernel<4><<<blocks, RSP_THREADS, 0, stream>>>(
            xr, xi, yr, yi, tw2, log2n, t0, em, lm, grown, groups);
        break;
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    xr = yr;
    xi = yi;
  }

  const size_t body_smem = (size_t)2 << RSP_SPLIT_LOG2 << 2;
  if ((e = rsp_opt_in(rsp_int_split_body_kernel, body_smem)) != cudaSuccess)
    return (int)e;
  rsp_int_split_body_kernel<<<(unsigned)(cells >> RSP_SPLIT_LOG2),
                              RSP_SPLIT_THREADS, body_smem, stream>>>(
      yr, yi, tw2, mag, log2n, em, lm, (em & ((1u << s) - 1u)) != 0u, regs);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const size_t row = (size_t)((1 << RSP_SPLIT_TILE_LOG2) + 2 * RSP_PAD)
                     * sizeof(int);
  if ((e = rsp_opt_in(rsp_int_split_tail_kernel, 3 * row)) != cudaSuccess)
    return (int)e;
  rsp_int_split_tail_kernel<<<(unsigned)(cells >> RSP_SPLIT_TILE_LOG2),
                              RSP_THREADS, regs.algorithm == 1 ? 3 * row : row,
                              stream>>>(mag, thr, peaks, log2n, regs);
  return (int)cudaGetLastError();
}
