// Kernels F and G for frames of N = 2^L = 2048 ... 16384: the bit-true
// integer chain in one launch that reads the IQ once and writes the
// threshold and the peaks once, the frame kept in registers and shared
// memory between.
//
// Replaces, for those frames, rsp_chains_tpu/kernels/int_chain_pallas.py::
// fused_chain_int (:441, pallas_call :512) and ::fused_chain_int_gos (:552,
// pallas_call :622), which take them in one kernel too (n > 1024 at a 96 MiB
// VMEM limit, :508-510). The host (kernels/int_chain.py) takes this route by
// N alone and counts its launches as chain_int_mid (F; the algorithm
// register forced to 0) and chain_int_gos_mid (G).
//
// Exact for the reason the integer FFT is exact on every route: each radix-2
// DIF stage rounds each butterfly on its own (ops/bit_true.py
// `_fft_int_fixed`), so the stages may run in any grouping that gives each
// butterfly its two cells, its stage flags and its twiddle tw[half + j].
//
// * Front. A block of 1024 threads holds 8192 cells in registers, 8 a
//   thread, on the 8192-cell body of int_rows.cuh (`rsp_split_passes`:
//   passes of 3 stages at the strides 1024, 128, 16 and 2 through two
//   swizzled int planes, the last stage across lane pairs; 3 barriers). At
//   L <= 13 the block holds 2^d whole frames, d = 13 - L: body stage t pairs
//   cells 2^(12 - t) apart, which is stage t - d of each frame, so the first
//   pass skips d stages and the masks come shifted left by d. At L = 14 the
//   frame's 128 KiB of planes and 16 cells a thread do not fit one block
//   (16 cells under run-time flags need 86 registers, over the 64 of 1024
//   threads), so a thread-block cluster of two blocks takes it, a half
//   each: DIF stage 0 pairs cell i with i + 8192, so each block reads both
//   halves from device memory (the partner's read of the same cells
//   mostly hits L2; an exchange of the halves through distributed shared
//   memory behind a cluster barrier measured slower), runs stage 0 and
//   keeps its output, block 0 the sums and block 1 the differences; then
//   the body runs stages 1 .. 13 on it, the masks
//   shifted right by one and `grown` set where stage 0 expanded (the split
//   route's body at s = 1). Where no stage expands or keeps the LSB (the
//   bench's flags) the launch takes the instantiation whose masks are the
//   constant 0.
// * Magnitude. After the last stage slot k holds cell 8 m + k, whose bin is
//   its bit reversal over L bits (at L = 14, cell q of half r is bin
//   2 bitrev_13(q) + r); each thread takes `rsp_int_magnitude` (modes 0-2,
//   zero at and beyond n_active) in registers and stores it at its bin in a
//   magnitude row past the planes (`rsp_mag_slot`, one word of padding in
//   16, RSP_PAD cells either side, zeros outside the frame), so no barrier
//   stands between the last pass and the stores. At L = 14 a block's row
//   spans its half's 8192 bins and RSP_PAD either side; the other parity's
//   bins come from the partner, which writes them straight into this
//   block's row through distributed shared memory (each block writes every
//   bin it holds into each row that spans it), and one cluster barrier
//   makes both rows whole.
// * Tail, F (and G with algorithm 0). The run sums of `rsp_int_ca_runs`, 16
//   cells a thread (512 threads), wrapping uint32_t sums, exact; then
//   `rsp_int_combine`, the threshold and the peak test; int4 and uint4
//   stores.
// * Tail, G. The rows copied by cell, without the padding (the
//   selection's loads then take no address arithmetic), then the rank
//   selection of gos_cfar.cuh on int32, INT32_MAX past the active cells. At
//   w <= 32 two windows a warp: frame pairs where the block holds 4 or 2
//   rows (`rsp_gos_row_pairs`, the pairs' starts cut into 32 equal runs),
//   run pairs over its one row at N = 8192 and 16384 (`rsp_gos_stats`, two
//   runs a warp an odd number of starts apart), whose chunks' loads ahead
//   of the slides fit the 64 registers of 1024 threads without a spill. At
//   w = 64 a window a warp (`rsp_gos_ranks`). The
//   copies and the two statistic rows a row, kStatP words apart (an odd
//   multiple of 16, so a frame pair's two words lie in different banks),
//   take the dead planes' place; then a cell a thread, stores coalesced.
//
// Bound on the H100: the function moves 13 bytes a sample (0.0651 ms at
// 2^24 samples) and its butterflies cost 8.5 L integer operations a sample
// (0.047-0.060 ms at 33.5e12/s); this kernel moves those 13 bytes from
// device memory (at L = 14 each half is read twice, the second time
// mostly from L2) and runs about 160 instructions a cell in the body,
// which its time follows (the split route's body took 0.1705 ms over 2^24
// cells); G adds the selection's, about three shared-memory or shuffle
// operations a window start at w <= 32.
// One block of 1024 threads an SM: a block's loads, FFT, tail and stores
// do not overlap another block's.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gos_cfar.cuh"
#include "int_rows.cuh"

namespace cg = cooperative_groups;

#define RSP_MID_T ((1 << RSP_SPLIT_LOG2) / RSP_SPLIT_CELLS)  // 1024 threads

// A block's shared memory in words. The front: the two planes of the body;
// once they are dead, G's two statistic rows a row (by window start) and
// its rows by cell. Past the front, the magnitude
// rows of the block's kRows frames (L <= 13) or of its half-frame (L = 14),
// which the partner writes into and G's statistic rows must not overlap.
template <int kLog2N>
struct RspMidPlan {
  static_assert(kLog2N >= 11 && kLog2N <= 14, "the route takes N 2048-16384");
  static constexpr bool kPair = kLog2N > RSP_SPLIT_LOG2;
  static constexpr int kRows = kPair ? 1 : 1 << (RSP_SPLIT_LOG2 - kLog2N);
  static constexpr int kSpan = kPair ? 1 << RSP_SPLIT_LOG2 : 1 << kLog2N;
  static constexpr int kRow = rsp_mag_floats(kSpan);     // a magnitude row
  static constexpr int kStat = kSpan + 2 * RSP_PAD;      // a row by cell
  // G's rows by cell and statistic rows lie kStatP apart, an odd multiple
  // of 16 words: a frame pair's two words of one instruction fall in
  // different banks
  static constexpr int kStatP = kStat + 16;
  static constexpr int kPlanes = 2 << RSP_SPLIT_LOG2;
  static constexpr int kGos = 3 * kRows * kStatP;
  static constexpr int kFront = kPlanes > kGos ? kPlanes : kGos;
  static constexpr int kWords = kFront + kRows * kRow;
};

// Threshold and peaks of the frames of 2^kLog2N cells of re / im: frames
// kRows a block, or at L = 14 a cluster of two blocks a frame. kPlain: no
// stage expands and none keeps the LSB, so the masks are the constant 0.
template <int kLog2N, bool kPlain>
__global__ void __launch_bounds__(RSP_MID_T, 1)
rsp_int_mid_kernel(const int* __restrict__ re, const int* __restrict__ im,
                   const int2* __restrict__ tw, int* __restrict__ thr,
                   uint8_t* __restrict__ peaks, int frames,
                   unsigned expand_mask, unsigned lsb_mask, RspIntRegs r) {
  using P = RspMidPlan<kLog2N>;
  constexpr int T = RSP_MID_T, K = RSP_SPLIT_CELLS, S = P::kSpan;
  constexpr int kHalf = 1 << RSP_SPLIT_LOG2;
  extern __shared__ int ismem[];
  int* rows = ismem + P::kFront;
  const int m = threadIdx.x;
  // the block's half of its frame (L = 14), else 0; the row's first cell
  const int rank = P::kPair ? (int)(blockIdx.x & 1u) : 0;
  const int org = rank * kHalf;
  const size_t f0 = P::kPair ? (size_t)(blockIdx.x >> 1)
                             : (size_t)blockIdx.x * P::kRows;
  const int live = P::kPair ? 1 : min(P::kRows, frames - (int)f0);
  if constexpr (P::kPair)  // the partner writes this block's row later
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // zeros outside the frame: each row's margins (at L = 14 the outer one,
  // the inner comes from the partner)
  if (m < RSP_PAD) {
#pragma unroll
    for (int f = 0; f < P::kRows; ++f) {
      int* rw = rows + f * P::kRow;
      if (rank == 0) rw[rsp_mag_slot(m)] = 0;
      if (!P::kPair || rank == 1) rw[rsp_mag_slot(RSP_PAD + S + m)] = 0;
    }
  }

  int xr[K], xi[K];
  bool grown = false;
  if constexpr (P::kPair) {
    // stage 0 on the cells q of both halves, read from device memory (the
    // partner's read of the same cells mostly hits L2), keeping this
    // block's output
    const bool expanding = !kPlain && (expand_mask & 1u);
    const bool lsb = !kPlain && !expanding && (lsb_mask & 1u);
    const size_t base = f0 << kLog2N;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = m + T * k;
      int ar = re[base + q], ai = im[base + q];
      int br = re[base + kHalf + q], bi = im[base + kHalf + q];
      rsp_int_butterfly(ar, ai, br, bi, __ldg(tw + kHalf + q), expanding,
                        lsb, expanding);
      xr[k] = rank ? br : ar;
      xi[k] = rank ? bi : ai;
    }
    grown = expanding;
    rsp_split_passes<0>(xr, xi, ismem, ismem + kHalf, m, tw,
                        kPlain ? 0u : expand_mask >> 1,
                        kPlain ? 0u : lsb_mask >> 1, grown);
  } else {
    constexpr int d = RSP_SPLIT_LOG2 - kLog2N;
    const size_t base = f0 << kLog2N;
    const int n_live = live << kLog2N;  // the live frames' cells
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = m + T * k;
      xr[k] = c < n_live ? re[base + c] : 0;
      xi[k] = c < n_live ? im[base + c] : 0;
    }
    rsp_split_passes<0, d>(xr, xi, ismem, ismem + kHalf, m, tw,
                           kPlain ? 0u : expand_mask << d,
                           kPlain ? 0u : lsb_mask << d, grown);
  }

  // slot k: the cell K m + k of the block's 8192
  const int hi = r.n_active;
  if constexpr (P::kPair) {
    // this block's row spans the bins org - PAD .. org + 8192 + PAD, the
    // partner's org' - PAD .. org' + 8192 + PAD; the partner is running
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    cg::cluster_group cluster = cg::this_cluster();
    int* peer = cluster.map_shared_rank(rows, rank ^ 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int bin =
          (int)((__brev(K * m + k) >> (32 - RSP_SPLIT_LOG2)) << 1) | rank;
      const int v =
          bin < hi ? rsp_int_magnitude(xr[k], xi[k], r.mag_mode) : 0;
      const int jo = RSP_PAD + bin - org, jp = RSP_PAD + bin - (org ^ kHalf);
      if ((unsigned)jo < (unsigned)P::kStat) rows[rsp_mag_slot(jo)] = v;
      if ((unsigned)jp < (unsigned)P::kStat) peer[rsp_mag_slot(jp)] = v;
    }
    cluster.sync();  // both rows whole; no remote access after it
  } else {
    int* rw = rows + ((K * m) >> kLog2N) * P::kRow;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int bin =
          (int)(__brev((K * m + k) & (S - 1)) >> (32 - kLog2N));
      rw[rsp_mag_slot(RSP_PAD + bin)] =
          bin < hi ? rsp_int_magnitude(xr[k], xi[k], r.mag_mode) : 0;
    }
    __syncthreads();
  }

  const int w = 1 << r.log2w, g = r.guard;
  if (r.algorithm != 1) {
    // F's run sums, 16 cells a thread
    constexpr int kRunT = S * P::kRows / 16;
    static_assert(kRunT <= T, "16 cells a thread");
    const int c0 = 16 * m, f = c0 / S, i0 = c0 % S;
    if (m >= kRunT || f >= live) return;
    const int* rw = rows + f * P::kRow;
    const size_t o = ((f0 + f) << kLog2N) + org;
    int* t = thr + o;
    uint8_t* pk = peaks + o;
    switch (r.log2w) {
      case 0: rsp_int_ca_runs<1>(rw, i0, r, t, pk, org); break;
      case 1: rsp_int_ca_runs<2>(rw, i0, r, t, pk, org); break;
      case 2: rsp_int_ca_runs<4>(rw, i0, r, t, pk, org); break;
      case 3: rsp_int_ca_runs<8>(rw, i0, r, t, pk, org); break;
      default: rsp_int_ca_runs<16>(rw, i0, r, t, pk, org); break;
    }
    return;
  }

  // G's rank statistics: the lag and lead ranks of row f by window start
  // (start s: the row cells s .. s + w - 1) at st0(f) and st1(f), over the
  // active cells [0, hi) of the frame, from the rows copied by cell to
  // cells(f) (the planes are dead), so the selection's loads take no address
  // arithmetic. Two windows a warp at w <= 32: frame pairs where the block
  // holds 4 or 2 rows, run pairs over its one row at N = 8192 and 16384.
  const auto st0 = [&](int f) { return ismem + f * P::kStatP; };
  const auto st1 = [&](int f) { return ismem + (P::kRows + f) * P::kStatP; };
  const auto cells = [&](int f) {
    return ismem + (2 * P::kRows + f) * P::kStatP;
  };
  for (int c = m; c < P::kRows * P::kStat; c += T) {
    const int f = c / P::kStat, j = c - f * P::kStat;
    cells(f)[j] = rows[f * P::kRow + rsp_mag_slot(j)];
  }
  __syncthreads();
  {
    const int s_lo = RSP_PAD - g - w, s_hi = RSP_PAD + S + g + 1;
    const int alo = RSP_PAD - org, ahi = RSP_PAD - org + hi;
    if constexpr (P::kRows == 1)
      rsp_gos_stats<int>(cells(0), st0(0), st1(0), s_lo, s_hi, w, alo, ahi,
                         r.rank_lagg, r.rank_lead);
    else
      rsp_gos_row_pairs<int>(
          [&](int f) { return RspStartRows<int>{cells(f), st0(f), st1(f)}; },
          live, s_lo, s_hi - s_lo, w, alo, ahi, r.rank_lagg, r.rank_lead);
  }
  __syncthreads();
  for (int c = m; c < S * P::kRows; c += T) {
    const int f = c / S, j = c % S, i = org + j;  // i: the frame's cell
    if (f >= live) break;
    const size_t o = ((f0 + f) << kLog2N) + i;
    if (i >= hi) {
      thr[o] = 0;
      peaks[o] = 0;
      continue;
    }
    const int k = RSP_PAD + j;
    int t;
    uint8_t pk;
    rsp_int_thr_peak(cells(f) + k, i,
                     rsp_int_combine(r.cfar_mode, st0(f)[k - g - w],
                                     st1(f)[k + g + 1]),
                     r, t, pk);
    thr[o] = t;
    peaks[o] = pk;
  }
}

template <int kLog2N, bool kPlain>
static int rsp_int_mid_launch(const int* re, const int* im, int* thr,
                              uint8_t* peaks, int frames, cudaStream_t stream,
                              const int2* tw, unsigned em, unsigned lm,
                              RspIntRegs regs) {
  using P = RspMidPlan<kLog2N>;
  const auto kernel = rsp_int_mid_kernel<kLog2N, kPlain>;
  const size_t smem = (size_t)P::kWords * sizeof(int);
  cudaError_t e = rsp_opt_in(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P::kPair ? 2u * (unsigned)frames
                              : (unsigned)((frames + P::kRows - 1) / P::kRows));
  cfg.blockDim = dim3(RSP_MID_T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = P::kPair ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kernel, re, im, tw, thr, peaks, frames, em, lm,
                         regs);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// re, im, thr: int32 [frames, 2^log2n]; peaks: uint8 [frames, 2^log2n];
// tw: int32 [2^log2n, 2] (int_front.cuh); all contiguous on the current
// device, 11 <= log2n <= 14. The algorithm register picks F's CA (anything
// but 1) or G's rank statistics (1). Launches on `stream`; returns the
// launch's error or cudaGetLastError().
extern "C" int rsp_int_mid(const int* re, const int* im, int* thr,
                           uint8_t* peaks, int frames, cudaStream_t stream,
                           const int* tw, int log2n, int expand_mask,
                           int lsb_mask, RspIntRegs regs) {
  const unsigned em = (unsigned)expand_mask, lm = (unsigned)lsb_mask;
  const int2* tw2 = reinterpret_cast<const int2*>(tw);
  const bool plain = em == 0u && lm == 0u;
#define RSP_MID_CASE(L)                                                    \
  case L:                                                                  \
    return plain ? rsp_int_mid_launch<L, true>(re, im, thr, peaks, frames, \
                                               stream, tw2, em, lm, regs)  \
                 : rsp_int_mid_launch<L, false>(re, im, thr, peaks,        \
                                                frames, stream, tw2, em,   \
                                                lm, regs)
  switch (log2n) {
    RSP_MID_CASE(11);
    RSP_MID_CASE(12);
    RSP_MID_CASE(13);
    RSP_MID_CASE(14);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef RSP_MID_CASE
}
