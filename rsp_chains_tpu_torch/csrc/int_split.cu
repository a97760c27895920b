// Kernels F and G for frames of N = 2^L > 16384: the bit-true integer chain
// in three launches through device memory, since the frame no longer fits
// the registers and shared memory of one block or of a pair of blocks
// (int_mid.cu takes N = 2048-16384 in one launch: 8192 cells a block, two
// blocks of a thread-block cluster at 16384).
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
// cells, its stage flags and its twiddle. With s = L - 13:
//
// * Head (rsp_int_split_head_kernel<kS>): under DIF stages 0 .. s-1 the
//   cells j + t N/2^s (t < 2^s) of each j < N/2^s form a closed group. A
//   thread takes a group of 2^kS cells at a stride for kS <= 5 stages in
//   registers (`rsp_int_butterfly`, the twiddle tw[half + (cell mod half)],
//   the stage's expand and keepLSB bits), neighbouring threads on
//   neighbouring cells, so loads and stores are coalesced. One launch up to
//   N = 2^18; beyond, a further launch takes the next stages, in place.
// * Body (rsp_int_split_body_kernel): each contiguous sub-frame of 8192
//   cells is then an independent DIF transform for stages s .. L-1, whose
//   twiddles W_{2h}^j (h <= 4096) are rows h + j of the same table. A block
//   of 1024 threads holds it in registers, 8 cells a thread, on the
//   8192-cell body of int_rows.cuh (`rsp_split_passes`, F's register passes
//   `rsp_int_pass`): passes of 3 stages at the strides 1024, 128, 16 and 2,
//   one block an SM. Where no stage expands and none
//   of the body's keeps the LSB (the bench's flags), the launch takes the
//   instantiation whose masks are the constant 0, so every stage flag folds
//   away; any other reads the flags at run time, each stage through a
//   uniform branch (16 cells a thread would need 86 registers there).
//   Between passes the cells cross through two int planes of shared memory
//   under an XOR swizzle free of bank conflicts (`rsp_split_slot`); the last
//   stage runs across lane pairs by shuffles (`rsp_split_last`): 3 barriers
//   against 13 stages. The masks are shifted by s and `grown` comes in set
//   when a head stage expanded (the one place a shifted mask alone is
//   wrong). Cell q of sub-frame b is bin k 2^s + bitrev_s(b), k =
//   bitrev_13(q); each thread takes its cells' integer magnitudes
//   (`rsp_int_magnitude`, modes 0-2, zero at and beyond n_active) in
//   registers and stages them at k past the planes (one word of padding in
//   32: no bank conflicts), so the block stores its sub-frame's 8192
//   magnitudes in order of k, whole sectors: the hand-off `mag[frame][b][k]`.
//   Beyond N = 2^20 (s > 7) it stores each at its natural bin instead, 2^s
//   cells apart, as the tail's runs would fall under 32 cells.
// * Tail (rsp_int_split_tail_kernel): tiles of RSP_SPLIT_TILE cells, one a
//   block, each with RSP_PAD cells either side (zeros outside the frame), so
//   windows and peak grouping see the whole frame. A tile's 4352 cells are,
//   residue t mod 2^s apart, 2^s runs of 4352 / 2^s consecutive k of
//   sub-frame bitrev_s(t) (34 cells at s = 7): the block reads the runs,
//   neighbouring threads on neighbouring k, and puts each cell at its
//   natural place in shared memory. Then F's CA by run sums
//   (int_rows.cuh `rsp_int_ca_runs`: 16 cells a thread, wrapping uint32_t
//   sums, exact) or, with the algorithm register at 1, G's rank statistics
//   (`rsp_gos_stats` on int32, INT32_MAX past the active cells: at w <= 32
//   run pairs, two runs of the tile's window starts a warp an odd number
//   apart, one a half-warp; at w = 64 a run a warp), then
//   `rsp_int_combine` and `rsp_int_thr_peak`; active cells [0, n_active) as
//   in F and G.
//
// Bound on the H100: the function moves 13 bytes a sample and its
// butterflies cost 8.5 L integer operations a sample; the route moves 37
// (head 8 + 8, body 8 + 4, tail 4 + 5). The body runs about 160
// instructions a cell (13 stages of half a butterfly, 17 integer
// operations each, the exchanges, the magnitude), 0.09 ms at the card's
// full instruction rate at 512 x 32768, above its 12 bytes' 0.06. Scratch: 12 bytes a
// sample (the head's two planes, the magnitudes), allocated by the
// wrapper.
#include <cuda_runtime.h>

#include "gos_cfar.cuh"
#include "int_rows.cuh"

#define RSP_SPLIT_HEAD 5          // head stages a launch, at most
#define RSP_SPLIT_RUNS 7          // s up to which the hand-off is in runs
#define RSP_SPLIT_TILE_LOG2 12    // the tail's tile, 4096 cells

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
  // F's register pass on the group: slot k at cell lo + stride k as far as
  // the twiddle rows go (the group's first cell differs from lo by a
  // multiple of 2^(log2n - t0))
  rsp_int_pass<kS, G>(xr, xi, lo, stride, t0, tw, expand_mask, lsb_mask,
                      grown);
#pragma unroll
  for (int k = 0; k < G; ++k) {
    yr[base + (size_t)k * stride] = xr[k];
    yi[base + (size_t)k * stride] = xi[k];
  }
}

// Where the body stages the magnitude of a sub-frame's bin k: one word of
// padding in 32.
static __host__ __device__ constexpr int rsp_split_mag_slot(int k) {
  return k + (k >> 5);
}

// Stages s .. log2n - 1 of each sub-frame of 8192 cells of yr / yi (one a
// block, s = log2n - 13), then the magnitude of each of its bins to `mag`:
// sub-frame b's bin k at the sub-frame's own place, b 8192 + k, for s <= 7,
// else at the bin's natural place; zero at and beyond n_active. `grown`:
// whether a head stage expanded. kPlain: no stage expands and none of the
// body's keeps the LSB, so the masks are the constant 0 and every stage
// flag folds away (the run-time form at those flags computes the same).
template <bool kPlain>
__global__ void __launch_bounds__((1 << RSP_SPLIT_LOG2) / RSP_SPLIT_CELLS, 1)
rsp_int_split_body_kernel(const int* __restrict__ yr,
                          const int* __restrict__ yi,
                          const int2* __restrict__ tw, int* __restrict__ mag,
                          int log2n, unsigned expand_mask, unsigned lsb_mask,
                          bool grown, RspIntRegs r) {
  extern __shared__ int ismem[];
  constexpr int kSub = 1 << RSP_SPLIT_LOG2, T = kSub / RSP_SPLIT_CELLS;
  const int s = log2n - RSP_SPLIT_LOG2;
  const size_t base = (size_t)blockIdx.x << RSP_SPLIT_LOG2;
  const int b = (int)(blockIdx.x & ((1u << s) - 1u));
  const size_t frame = ((size_t)blockIdx.x >> s) << log2n;
  const int m = threadIdx.x;
  int xr[RSP_SPLIT_CELLS], xi[RSP_SPLIT_CELLS];
#pragma unroll
  for (int k = 0; k < RSP_SPLIT_CELLS; ++k) {
    xr[k] = yr[base + m + T * k];
    xi[k] = yi[base + m + T * k];
  }
  bool g = !kPlain && grown;
  rsp_split_passes<0>(xr, xi, ismem, ismem + kSub, m, tw,
                      kPlain ? 0u : expand_mask >> s,
                      kPlain ? 0u : lsb_mask >> s, g);
  // the bins, staged past the planes (no barrier before the stores)
  int* staged = ismem + 2 * kSub;
  const int rb = __brev(b) >> (32 - s);  // bitrev_s(b); s >= 2
#pragma unroll
  for (int k = 0; k < RSP_SPLIT_CELLS; ++k) {
    const int q =  // bin k
        __brev(RSP_SPLIT_CELLS * m + k) >> (32 - RSP_SPLIT_LOG2);
    const int bin = (q << s) | rb;
    staged[rsp_split_mag_slot(q)] =
        bin < r.n_active ? rsp_int_magnitude(xr[k], xi[k], r.mag_mode) : 0;
  }
  __syncthreads();
  const bool runs = s <= RSP_SPLIT_RUNS;
  for (int k = m; k < kSub; k += T)
    mag[runs ? base + k : frame + (((size_t)k << s) | rb)] =
        staged[rsp_split_mag_slot(k)];
}

// Threshold and peaks of each tile of RSP_SPLIT_TILE cells of the frames of
// 2^log2n cells whose magnitudes the body left in `mag`, one a block: F's
// CA by run sums, or with the algorithm register at 1 G's rank statistics
// of the active cells.
__global__ void __launch_bounds__(RSP_THREADS)
rsp_int_split_tail_kernel(const int* __restrict__ mag, int* __restrict__ thr,
                          uint8_t* __restrict__ peaks, int log2n,
                          RspIntRegs r) {
  extern __shared__ int ismem[];
  constexpr int T = 1 << RSP_SPLIT_TILE_LOG2, S = T + 2 * RSP_PAD;
  const int n = 1 << log2n, s = log2n - RSP_SPLIT_LOG2;
  const int per = log2n - RSP_SPLIT_TILE_LOG2;  // log2 of tiles a frame
  const size_t frame = (size_t)(blockIdx.x >> per) << log2n;
  const int ts = (int)(blockIdx.x & ((1u << per) - 1u)) << RSP_SPLIT_TILE_LOG2;
  const int c0 = ts - RSP_PAD;  // the cell at row index 0
  const bool gos = r.algorithm == 1;
  // row index j, the cell c0 + j: at j for the selection, at rsp_mag_slot(j)
  // (one word of padding in 16) for the run sums
  int* row = ismem;
  // thread slot i = threadIdx.x + RSP_THREADS q reads one cell, all its
  // loads in flight before the stores
  static_assert(S % RSP_THREADS == 0 && S % 256 == 0, "the tile's row");
  constexpr int kReads = S / RSP_THREADS;
  const bool runs = s <= RSP_SPLIT_RUNS;
  // in runs: residue t's cells c0 + kk 2^s + t are the R = S / 2^s
  // consecutive bins from c0 >> s of sub-frame bitrev_s(t) (c0 and S are
  // multiples of 2^s); slot i is run t = i / R, bin kk = i mod R of it
  const int k0 = c0 >> s;
  int v[kReads], at[kReads];
#pragma unroll
  for (int q = 0; q < kReads; ++q) {
    const int i = threadIdx.x + RSP_THREADS * q;
    if (runs) {
      const int t = (i >> (8 - s)) / (S >> 8), kk = i - t * (S >> s);
      const int k = k0 + kk;
      at[q] = (kk << s) | t;
      v[q] = (unsigned)k < (1u << RSP_SPLIT_LOG2)
                 ? mag[frame + ((size_t)(__brev(t) >> (32 - s))
                                << RSP_SPLIT_LOG2) + k]
                 : 0;
    } else {
      const int c = c0 + i;
      at[q] = i;
      v[q] = c >= 0 && c < n ? mag[frame + c] : 0;
    }
  }
#pragma unroll
  for (int q = 0; q < kReads; ++q)
    row[gos ? at[q] : rsp_mag_slot(at[q])] = v[q];
  __syncthreads();

  if (!gos) {
    int* t = thr + frame + ts;
    uint8_t* pk = peaks + frame + ts;
    const int i0 = 16 * threadIdx.x;
    switch (r.log2w) {
      case 0: rsp_int_ca_runs<1>(row, i0, r, t, pk, ts); break;
      case 1: rsp_int_ca_runs<2>(row, i0, r, t, pk, ts); break;
      case 2: rsp_int_ca_runs<4>(row, i0, r, t, pk, ts); break;
      case 3: rsp_int_ca_runs<8>(row, i0, r, t, pk, ts); break;
      default: rsp_int_ca_runs<16>(row, i0, r, t, pk, ts); break;
    }
    return;
  }
  int* st0 = row + S;  // by window start, like `row`
  int* st1 = st0 + S;
  const int w = 1 << r.log2w, g = r.guard, hi = r.n_active;
  // st0[k] / st1[k]: the lag / lead rank statistic of the window of row
  // cells k .. k + w - 1 over the active cells [0, hi)
  rsp_gos_stats<int>(row, st0, st1, RSP_PAD - g - w, RSP_PAD + T + g + 1, w,
                     RSP_PAD - ts, RSP_PAD - ts + hi, r.rank_lagg,
                     r.rank_lead);
  __syncthreads();
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    const int i = ts + j;
    const size_t o = frame + i;
    if (i >= hi) {
      thr[o] = 0;
      peaks[o] = 0;
      continue;
    }
    const int k = RSP_PAD + j;
    int t;
    uint8_t pk;
    rsp_int_thr_peak(row + k, i, rsp_int_combine(r.cfar_mode, st0[k - g - w],
                                                  st1[k + g + 1]),
                     r, t, pk);
    thr[o] = t;
    peaks[o] = pk;
  }
}

// re, im, thr: int32 [frames, 2^log2n]; peaks: uint8 [frames, 2^log2n];
// tw: int32 [2^log2n, 2] (int_front.cuh); scratch: int32 [3, frames,
// 2^log2n]; all contiguous on the current device, 15 <= log2n <= 30. The
// algorithm register picks F's CA (anything but 1) or G's rank statistics
// (1). Launches the head (one launch a group of up to five stages), the body
// and the tail on `stream`; returns the first cudaGetLastError() that fails.
extern "C" int rsp_int_split(const int* re, const int* im, int* thr,
                             uint8_t* peaks, int frames, cudaStream_t stream,
                             const int* tw, int log2n, int expand_mask,
                             int lsb_mask, RspIntRegs regs, int* scratch) {
  if (log2n < 15 || log2n > 30) return (int)cudaErrorInvalidValue;
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
  for (int t0 = 0; t0 < s; t0 += RSP_SPLIT_HEAD) {
    const int k = min(RSP_SPLIT_HEAD, s - t0);
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
      case 4:
        rsp_int_split_head_kernel<4><<<blocks, RSP_THREADS, 0, stream>>>(
            xr, xi, yr, yi, tw2, log2n, t0, em, lm, grown, groups);
        break;
      default:
        rsp_int_split_head_kernel<5><<<blocks, RSP_THREADS, 0, stream>>>(
            xr, xi, yr, yi, tw2, log2n, t0, em, lm, grown, groups);
        break;
    }
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    xr = yr;
    xi = yi;
  }

  // two planes and the staged bins
  constexpr size_t body_smem =
      (2 * (1 << RSP_SPLIT_LOG2) + rsp_split_mag_slot(1 << RSP_SPLIT_LOG2))
      * sizeof(int);
  const unsigned body_blocks = (unsigned)(cells >> RSP_SPLIT_LOG2);
  const bool grown = (em & ((1u << s) - 1u)) != 0u;
  auto body = em == 0u && (lm >> s) == 0u ? rsp_int_split_body_kernel<true>
                                          : rsp_int_split_body_kernel<false>;
  if ((e = rsp_opt_in(body, body_smem)) != cudaSuccess) return (int)e;
  body<<<body_blocks, (1 << RSP_SPLIT_LOG2) / RSP_SPLIT_CELLS, body_smem,
         stream>>>(yr, yi, tw2, mag, log2n, em, lm, grown, regs);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  constexpr int S = (1 << RSP_SPLIT_TILE_LOG2) + 2 * RSP_PAD;
  const size_t gos_smem = (size_t)3 * S * sizeof(int);
  if ((e = rsp_opt_in(rsp_int_split_tail_kernel, gos_smem)) != cudaSuccess)
    return (int)e;
  rsp_int_split_tail_kernel<<<
      (unsigned)(cells >> RSP_SPLIT_TILE_LOG2), RSP_THREADS,
      regs.algorithm == 1
          ? gos_smem
          : (size_t)rsp_mag_floats(1 << RSP_SPLIT_TILE_LOG2) * sizeof(int),
      stream>>>(mag, thr, peaks, log2n, regs);
  return (int)cudaGetLastError();
}
