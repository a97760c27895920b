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
//   rsp_gos_ranks' staged loop), and the tail, whose thread takes the cells
//   m + (N / 16) k, reads them free of bank conflicts. A start whose cell
//   lies outside the frame keeps that rank nowhere.
// * Two frames a warp (rsp_gos_pair_ranks, w <= 32). The selection is
//   held by its pipe to shared memory and shuffles: a start costs two
//   broadcast loads, two shuffles and two one-lane stores, and the row
//   plan's 24 warps an SM slid a frame a warp no faster than Kernel C's 64
//   (~0.5 ms for the headline's 17.4 M starts, either way, on the H100). So
//   a warp slides two frames' windows at the same starts: each
//   half-warp keeps one window of up to 32 cells sorted two slots a lane
//   (slots 2l and 2l + 1 in lane l of the half), and each load, shuffle and
//   store serves both halves, three a start. The frames' active ranges are
//   the same, so both halves take every branch together. A window of 64
//   keeps the warp-wide slide of rsp_gos_ranks, a frame a warp.
// * The schedule (rsp_gos_rows_stats): the window starts that the active
//   cells of the block's live frames read, pair of frames after pair (frame
//   after frame at w = 64), are cut into eight equal runs, one a warp, and
//   a run is split where it crosses into the next pair: each piece starts
//   with its own bitonic sort. Four frames of 1024 give each warp ~266
//   starts of two frames; one frame of a served request ~133 starts with
//   its pair's other half idle. The magnitude rows lie at an odd multiple
//   of 16 floats apart (RspGosRows::kMag), so a pair's two broadcast loads
//   fall in different banks.
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

// The window of a half-warp sorted ascending, slot 2l in x0 and 2l + 1 in
// x1 of its lane l: a bitonic network over the 32 slots, a lane's own pair
// compared in registers, the others by shuffles inside the half.
template <typename T>
static __device__ __forceinline__ void rsp_half_sort(T& x0, T& x1, int l) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const bool up = ((2 * l) & k) == 0;
      if (j == 1) {
        const bool lt = x1 < x0;
        const T lo = lt ? x1 : x0, hi = lt ? x0 : x1;
        x0 = up ? lo : hi;
        x1 = up ? hi : lo;
      } else {
        const bool keep_min = (((2 * l) & j) == 0) == up;
        x0 = rsp_keep(x0, __shfl_xor_sync(RSP_FULL_WARP, x0, j >> 1, 16),
                      keep_min);
        x1 = rsp_keep(x1, __shfl_xor_sync(RSP_FULL_WARP, x1, j >> 1, 16),
                      keep_min);
      }
    }
  }
}

// rsp_slide on a half-warp's window of two slots a lane: vo leaves, vi
// enters; each slot finds its new value from its neighbours' as there.
template <typename T>
static __device__ __forceinline__ void rsp_half_slide(T& x0, T& x1, T vo,
                                                      T vi, int l) {
  const T inf = RspTop<T>::value();
  const T up = __shfl_up_sync(RSP_FULL_WARP, x1, 1, 16);    // slot 2l - 1
  const T dn = __shfl_down_sync(RSP_FULL_WARP, x0, 1, 16);  // slot 2l + 2
  const T c0 = x0 < vo ? x0 : x1, p0 = up < vo ? up : x0;
  const T c1 = x1 < vo ? x1 : (l == 15 ? inf : dn), p1 = x0 < vo ? x0 : x1;
  x0 = c0 < vi ? c0 : (l > 0 && !(p0 < vi) ? p0 : vi);
  x1 = c1 < vi ? c1 : (!(p1 < vi) ? p1 : vi);
}

// rsp_gos_ranks for two frames at once, w <= 32 (see above): the half-warp
// of lane 16 h + l slides the window of `rows`, its frame's, over the same
// starts s_a <= s < s_b as the other half; a dead frame's half
// (rows.live false) stores nothing.
template <typename T>
struct RspPairRows : RspCellRows<T> {
  bool live;
};

template <typename T>
static __device__ __forceinline__ void rsp_gos_pair_ranks(
    const RspPairRows<T>& rows, int s_a, int s_b, int w, int alo, int ahi,
    int k0, int k1) {
  const int l = threadIdx.x & 15;
  const T inf = RspTop<T>::value();
  const unsigned span = (unsigned)max(ahi - alo, 0);
  const auto act = [&](int c) { return (unsigned)(c - alo) < span; };
  // the first window: slots 2l and 2l + 1 hold cells s_a + 2l, s_a + 2l + 1
  const int c = s_a + 2 * l;
  T x0 = 2 * l < w && act(c) ? rows.at(c) : inf;
  T x1 = 2 * l + 1 < w && act(c + 1) ? rows.at(c + 1) : inf;
  rsp_half_sort(x0, x1, l);
  int nv = max(min(s_a + w, ahi) - max(s_a, alo), 0);

  const auto store = [&](int s) {
    const int j0 = max(min(k0, nv - 1), 0), j1 = max(min(k1, nv - 1), 0);
    if (rows.live && l == (j0 >> 1) && rows.has_lag(s))
      *rows.lag_at(s) = nv > 0 ? (j0 & 1 ? x1 : x0) : T(0);
    if (rows.live && l == (j1 >> 1) && rows.has_lead(s))
      *rows.lead_at(s) = nv > 0 ? (j1 & 1 ? x1 : x0) : T(0);
  };
  // the whole-window starts that keep both ranks, as in rsp_gos_ranks
  const int f_lo = max(max(alo + 1, s_a + 1), rows.both_lo());
  const int f_hi = min(min(ahi - w + 1, s_b), rows.both_hi());
  const int f0 = min(k0, w - 1), f1 = min(k1, w - 1);
  store(s_a);
  for (int s = s_a + 1; s < s_b; ++s) {
    if (s == f_lo && f_lo < f_hi) {
      const bool p0 = rows.live && l == (f0 >> 1);
      const bool p1 = rows.live && l == (f1 >> 1);
      const bool e0 = f0 & 1, e1 = f1 & 1;
      const auto step = [&](int s) {
        rsp_half_slide(x0, x1, rows.at(s - 1), rows.at(s - 1 + w), l);
        if (p0) *rows.lag_at(s) = e0 ? x1 : x0;
        if (p1) *rows.lead_at(s) = e1 ? x1 : x0;
      };
      // chunks of 16 from a 16-aligned outgoing cell, as in rsp_gos_ranks
      constexpr int C = 16;
      for (const int s16 = min(f_hi, ((s + C - 2) & ~(C - 1)) + 1); s < s16;
           ++s)
        step(s);
      const auto chunks = [&](const auto& in) {
        for (; s + C <= f_hi; s += C) {
          // the chunk's cells into registers before any of its stores
          const T* out = rows.run(s - 1);
          T vo[C], vi[C];
#pragma unroll
          for (int t = 0; t < C; ++t) {
            vo[t] = out[t];
            vi[t] = in(s - 1 + w, t);
          }
          T* lag = rows.lag_at(s);
          T* lead = rows.lead_at(s);
#pragma unroll
          for (int t = 0; t < C; ++t) {
            rsp_half_slide(x0, x1, vo[t], vi[t], l);
            if (p0) lag[t] = e0 ? x1 : x0;
            if (p1) lead[t] = e1 ? x1 : x0;
          }
        }
      };
      if ((w & (C - 1)) == 0)
        chunks([&](int c, int t) { return rows.run(c)[t]; });
      else
        chunks([&](int c, int t) { return rows.at(c + t); });
      for (; s < f_hi; ++s) step(s);
      if (s == s_b) break;
    }
    const int co = s - 1, ci = co + w;
    const bool ao = act(co), ai = act(ci);
    if (ao || ai) {
      rsp_half_slide(x0, x1, ao ? rows.at(co) : inf, ai ? rows.at(ci) : inf,
                     l);
      nv += (int)ai - (int)ao;
    }
    store(s);
  }
}

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
  if (hi <= lo) return;
  const bool pairs = w <= 32;
  const int units = pairs ? (live + 1) / 2 : live;  // pairs or frames
  const int s_lo = RSP_PAD + lo - g - w;   // the first cell's lag start
  const int len = hi - lo + 2 * g + w + 1;  // starts a frame
  const int warps = blockDim.x >> 5;
  const int per = (units * len + warps - 1) / warps;
  int u = (int)(threadIdx.x >> 5) * per;
  const int u_end = min(u + per, units * len);
  while (u < u_end) {
    const int p = u / len;
    const int v = min(u_end, (p + 1) * len);
    const int f = pairs ? 2 * p + ((threadIdx.x >> 4) & 1) : p;
    const RspCellRows<T> rows{
        smem + 2 * P::kRows * P::kS + f * RspGosRows<kN>::kMag,
        smem + f * P::kS, smem + (P::kRows + f) * P::kS, RSP_PAD - g - w,
        RSP_PAD + g + 1, kN};
    const int s_a = s_lo + (u - p * len), s_b = s_a + (v - u);
    if (pairs)
      rsp_gos_pair_ranks(RspPairRows<T>{rows, f < live}, s_a, s_b, w,
                         RSP_PAD + lo, RSP_PAD + hi, k0, k1);
    else
      rsp_gos_ranks<true, T>(rows, s_a, s_b, w, RSP_PAD + lo, RSP_PAD + hi,
                             k0, k1);
    u = v;
  }
}
