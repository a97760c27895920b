// The rank selection of Kernels D (chain_gos.cu) and G (chain_int_gos.cu)
// on the row plan of row_fft.cuh: frames of N = 256, 512 or 1024, N / 16
// threads a frame, 256 / (N / 16) frames a block, three blocks an SM.
//
// * Where the cells and ranks live (RspCellRows): the selection reads the
//   frame's magnitude row in its padded layout (rsp_mag_slot, one float in
//   16), as the front scattered it. A rank is kept by the cell that reads
//   it, not by its window start: the lag rank of cell j (window start
//   RSP_PAD + j - g - w) at st0[j], its lead rank (start RSP_PAD + j + g +
//   1) at st1[j]. So each statistic row holds N values and fits in one of
//   the frame's FFT planes (N + 16 floats), which are dead once the forward
//   transform's last pass has read them: the block needs no more shared
//   memory than Kernels A and F. Consecutive starts keep their ranks at
//   consecutive words, so the selection stores at constant offsets (see
//   the chunks of rsp_gos_pair_ranks and rsp_gos_ranks), and the tail,
//   whose thread takes the cells m + (N / 16) k, reads them free of bank
//   conflicts. A start whose cell lies outside the frame keeps that rank
//   nowhere.
// * Two frames a warp (gos_cfar.cuh rsp_gos_pair_ranks, w <= 32). The
//   selection is held by its pipe to shared memory and shuffles: a start
//   costs two broadcast loads, two shuffles and two one-lane stores, and
//   the row plan's 24 warps an SM slid a frame a warp no faster than Kernel
//   C's 64 (~0.5 ms for the headline's 17.4 M starts, either way, on the
//   H100). So a warp slides two frames' windows at the same starts (frame
//   pairs): each half-warp keeps one window of up to 32 cells sorted two
//   slots a lane, and each load, shuffle and store serves both halves,
//   three a start. The frames' active ranges are the same, so both halves
//   take every branch together. A window of 64 keeps the warp-wide slide of
//   rsp_gos_ranks, a frame a warp.
// * The schedule (rsp_gos_rows_stats, on gos_cfar.cuh's rsp_gos_row_pairs,
//   which Kernels C and G's mid-size route share): the window starts that
//   the active cells of the block's live frames read, pair of frames after
//   pair (frame after frame at w = 64), are cut into eight equal runs, one
//   a warp, and a run is split where it crosses into the next pair: each
//   piece starts with its own bitonic sort. Four frames of 1024 give each
//   warp ~266 starts of two frames; one frame of a served request ~133
//   starts with its pair's other half idle. The magnitude rows lie at an
//   odd multiple of 16 floats apart (RspGosRows::kMag), so a pair's two
//   broadcast loads fall in different banks.
// * The CPI's count (rsp_count_cells): once a warp's live lanes have
//   stored the peak bytes of their cells, each lane reads 16 of the warp's
//   bytes back in one load, the warp adds their peaks, and one lane adds the
//   sum to a 64-bit counter in device memory, which the C entry zeroes on
//   the launch's stream. Integer atomics are exact in any order. So the
//   stream reads the count and never sums the peaks again. The tail's loop
//   over the cells keeps no count of its own: one more live register there
//   makes D spill (-Xptxas -v).
#pragma once

#include "gos_cfar.cuh"
#include "row_fft.cuh"

// The block's shared memory on the selection's row plan: Kernel A's FFT
// planes, then the magnitude rows kMag floats apart (A's kMagS, padded to
// an odd multiple of 16).
template <int kN>
struct RspGosRows {
  using P = RspRowPlan<kN>;
  static constexpr int kMag = P::kMagS % 32 ? P::kMagS : P::kMagS + 16;
  static constexpr int kFloats = P::kRows * (2 * P::kS + kMag);
};

// rsp_gos_ranks' reads and stores on the row plan (see above): rw the
// frame's magnitude row, st0 / st1 its two statistic rows; off0 / off1 the
// lag / lead window start of cell 0 (RSP_PAD - g - w, RSP_PAD + g + 1).
template <typename T>
struct RspCellRows {
  static constexpr bool kStaged = true;  // see rsp_gos_ranks
  static constexpr int kAlign = 16;      // see rsp_gos_pair_ranks
  const T* __restrict__ rw;
  T* st0;
  T* st1;
  int off0, off1, n;
  __device__ __forceinline__ T at(int c) const { return rw[rsp_mag_slot(c)]; }
  // cells c .. c + 15 for a 16-aligned c: contiguous from here
  __device__ __forceinline__ const T* run(int c) const {
    return rw + rsp_mag_slot(c);
  }
  // the starts between which every start keeps both ranks
  __device__ __forceinline__ int both_lo() const { return off1; }
  __device__ __forceinline__ int both_hi() const { return off0 + n; }
  __device__ __forceinline__ bool has_lag(int s) const {
    return (unsigned)(s - off0) < (unsigned)n;
  }
  __device__ __forceinline__ bool has_lead(int s) const {
    return (unsigned)(s - off1) < (unsigned)n;
  }
  __device__ __forceinline__ T* lag_at(int s) const { return st0 + (s - off0); }
  __device__ __forceinline__ T* lead_at(int s) const { return st1 + (s - off1); }
};

// The rank statistics of the block's frames 0 .. live - 1 (of kRows; the
// block's shared memory `smem` holds the FFT planes, then the magnitude rows,
// as RspGosRows lays them out) over their active cells [lo, hi): the
// lag rank k0 and lead rank k1 of each cell at its word of the frame's two
// planes (RspCellRows), by the schedule above. Every thread of the block
// calls it; the warps of dead frames' threads work on live frames. The
// caller synchronises before (the magnitude rows) and after (the ranks).
template <int kN, typename T>
static __device__ __forceinline__ void rsp_gos_rows_stats(T* smem, int live,
                                                          int w, int g, int lo,
                                                          int hi, int k0,
                                                          int k1) {
  using P = RspRowPlan<kN>;
  rsp_gos_row_pairs<T>(
      [&](int f) {
        return RspCellRows<T>{
            smem + 2 * P::kRows * P::kS + f * RspGosRows<kN>::kMag,
            smem + f * P::kS, smem + (P::kRows + f) * P::kS, RSP_PAD - g - w,
            RSP_PAD + g + 1, kN};
      },
      live, RSP_PAD + lo - g - w, hi - lo + 2 * g + w + 1, w, RSP_PAD + lo,
      RSP_PAD + hi, k0, k1);
}

// The lanes of this thread's warp that hold live frames (of `frames`, kRows
// a block, kT threads a frame): a block's frames are its threads / kT in
// order, so a warp's live lanes are its first ones.
template <int kT, int kRows>
static __device__ __forceinline__ unsigned rsp_live_lanes(int frames) {
  const int n = (frames - (int)blockIdx.x * kRows) * kT -
                (int)(threadIdx.x & ~31u);
  return n >= 32 ? 0xffffffffu : (1u << max(n, 0)) - 1u;
}

// Adds to *count (nothing where it is null) the peaks that the live lanes
// `lanes` of this thread's warp have stored, each at the cells m + kT j (j
// < 16) of its frame's row pk, m its thread of the frame; the live lanes
// call it. Each lane reads 16 of the warp's bytes (each 0 or 1): at kT <=
// 32 a warp holds whole frames, and the lane reads its frame's cells 16 m
// ..; at kT = 64 a warp holds half a frame, 32 cells of each j, two lanes a
// j. A tail whose thread stores the 16 cells 16 m .. (the CA tails) counts
// as kT = 16.
template <int kT>
static __device__ __forceinline__ void rsp_count_cells(
    unsigned long long* count, const uint8_t* pk, int m, unsigned lanes) {
  static_assert(kT == 16 || kT == 32 || kT == 64, "the row plan's kT");
  if (count == nullptr) return;
  __syncwarp(lanes);  // the warp's peak bytes are stored, and visible to it
  const int lane = threadIdx.x & 31;
  const uint8_t* p = kT <= 32 ? pk + 16 * m
                              : pk + kT * (lane >> 1) + (m - lane) +
                                    16 * (lane & 1);
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const unsigned n = __reduce_add_sync(
      lanes, __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w));
  if (lane == 0 && n != 0) atomicAdd(count, (unsigned long long)n);
}
