// Shared device functions of the GOSCA kernels: the rank selection of C
// (mag_gos_cfar.cu), D (chain_gos.cu), G (chain_int_gos.cu) and G's split
// route (int_split.cu), and Kernel C's GOS / GOSCA / CASH CFAR tail over one
// range tile of a frame's magnitude row in shared memory. D and G run the
// selection on the row plan's layout (gos_rows.cuh).
//
// Replaces, in rsp_chains_tpu/kernels/cfar_pallas.py, the v3 GOS body
// `_gos_rows_init` (:1232) + `_gos_tail` (:1317). The TPU builds every
// window's sorted list with a sliding odd-even merge ladder of lane rotations
// because Mosaic allows no unaligned lane slices or per-lane gathers. On the
// GPU a thread reads its window straight from shared memory, so only the
// result is kept, in the semantics of the JAX package's plain `ops.cfar.cfar_op`:
//
// * rank statistic of a side: over the window's cells that lie inside
//   [active_lo, active_hi) (cells outside are EXCLUDED, not zeros), nv of
//   them, the min(rank, nv-1)-th smallest; 0 when nv = 0;
// * CASH statistic of a side: the least sum of sub_w consecutive cells that
//   lie wholly inside the active range and the reference window, divided by
//   sub_w; 0 when none fits (so 0 when sub_w > w); the sides combine by max;
// * CA sums with PARTIAL edges (cells outside the active range are zeros),
//   divided by 2^divSum;
// * the CA/GO/SO mode over the selected side statistics, the scaler, the
//   active-range mask and peak grouping of ca_cfar.cuh.
//
// Work sharing: the lag window of cell i starts at i-g-w and the lead window
// at i+g+1, so each statistic is computed once per window START and read by
// both sides; one pass of the selection finds both ranks.
//
// The rank selection (`rsp_gos_ranks`), templated on the value type (float
// for C and D, the int32 magnitudes for G) and on where it reads the cells
// and puts the ranks (RspStartRows here: a row and two statistic rows
// indexed by window start; gos_rows.cuh's RspCellRows for the row plan):
// each warp owns a contiguous run
// of window starts and keeps the active cells of its current window sorted
// in registers, one slot a lane (two at w = 64), the type's top value (+inf,
// INT32_MAX under signed compares) past the nv active ones. A bitonic sort
// over the lanes builds the run's first window; each further start replaces
// the outgoing cell by the incoming one with compares against the two
// neighbouring slots (two shuffles, four at w = 64), and the lane holding each
// rank stores it. The k-th slot of the sorted multiset is the counting
// definition's k-th smallest, ties included, so the statistic is exact: no
// arithmetic touches a value. An active cell equal to the top value (G's
// square sum saturates to INT32_MAX) trades places with the padding, which
// leaves the multiset, and so every rank below nv, as it was. Where the whole
// window is active (all but the frame's edges) a start costs about twenty
// warp instructions, six of them on the shared memory and shuffle pipe;
// nothing diverges.
//
// Bound on the H100: the selection's pipe to shared memory and shuffles,
// not device memory. A start of the whole-window loop issues two broadcast
// loads (the outgoing and incoming cells), two shuffles (four at w = 64)
// and two single-lane stores (the ranks), at one warp instruction a clock
// an SM: about 6 SM clocks a start, some six times the time of the 13
// bytes of device traffic a cell at w = 32. Loading four cells and storing four
// ranks at a time would halve that pipe's share.
#pragma once

#include <climits>

#include "ca_cfar.cuh"

// Kernel C's range tile: a block takes RSP_GOS_TILE cells of one frame (or
// 2 or 4 tiles, where the frame divides; see mag_gos_cfar.cu) and a RSP_PAD
// margin of magnitudes on each side.
#define RSP_GOS_TILE 256
#define RSP_FULL_WARP 0xffffffffu

// The register file in the order of the JAX package's `fused_mag_gos_cfar`
// scalars (cfar_pallas.py:1663-1677) plus the scaler, after the host clamps
// and resolves the elaboration (see kernels/cfar.py, `gos_registers`).
struct RspGosRegs {
  int log2w;          // log2 of the reference window (<= 6)
  int guard;          // guard cells per side
  int div_sum;        // CA divider shift
  int cfar_mode;      // 0 CA, 1 GO, 2 SO, 3 CASH (3 only where elaborated)
  int log_or_linear;  // 1 linear (scaler multiplies), else log (adds)
  int peak_grouping;  // 1: peaks must be local maxima
  int active_hi;      // active cells [active_lo, active_hi)
  int mag_mode;       // 0 abs, 1 sqr, 2 JPL, 3 log2(JPL); clipped on the host
  int algorithm;      // 1: side statistics are order statistics, 0: CA sums
  int rank_lagg;      // ranks, clamped to [0, max_ref_window)
  int rank_lead;
  int sub_w;          // CASH sub-window, clamped to [min_sub_window, wmax]
  int active_lo;
  float scaler;
};

// The value past the nv active cells of a sorted window: it sorts after
// every value of the type.
template <typename T>
struct RspTop;
template <>
struct RspTop<float> {
  static __device__ __forceinline__ float value() { return CUDART_INF_F; }
};
template <>
struct RspTop<int> {
  static __device__ __forceinline__ int value() { return INT_MAX; }
};

// What a lane keeps of its own `v` and its partner's `o` in a
// compare-exchange: the lesser (`keep_min`) or the greater. The same strict
// compare on both sides keeps the pair a permutation of its bits, ties,
// -0 / +0 and NaN included.
template <typename T>
static __device__ __forceinline__ T rsp_keep(T v, T o, bool keep_min) {
  return (keep_min ? o < v : v < o) ? o : v;
}

// One value a lane, sorted ascending over the warp by a bitonic network.
template <typename T>
static __device__ __forceinline__ T rsp_warp_sort(T v, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1)
      v = rsp_keep(v, __shfl_xor_sync(RSP_FULL_WARP, v, j),
                   ((lane & j) == 0) == ((lane & k) == 0));
  }
  return v;
}

// A bitonic sequence of one value a lane, sorted ascending over the warp.
template <typename T>
static __device__ __forceinline__ T rsp_warp_merge(T v, int lane) {
#pragma unroll
  for (int j = 16; j > 0; j >>= 1)
    v = rsp_keep(v, __shfl_xor_sync(RSP_FULL_WARP, v, j), (lane & j) == 0);
  return v;
}

// One slide of the sorted window held in slot `lane` of `a` (and, for
// kWide, slot 32 + lane of `b`): vo leaves, vi enters, either of them the
// top value where its cell is inactive (the padding past nv). From its
// neighbours' slots a lane finds its own in the new window: after vo goes,
// the slots below vo keep theirs and the rest take their upper neighbour's;
// after vi comes, the slots below vi keep theirs, the first of the rest
// takes vi and the others their lower neighbour's. Compares only, no votes:
// equal values may trade slots, the multiset of values is exact.
template <bool kWide, typename T>
static __device__ __forceinline__ void rsp_slide(T& a, T& b, T vo, T vi,
                                                 int lane) {
  const T inf = RspTop<T>::value();
  const int up = (lane - 1) & 31, dn = (lane + 1) & 31;
  const T a_dn = __shfl_sync(RSP_FULL_WARP, a, dn);
  const T a_up = __shfl_sync(RSP_FULL_WARP, a, up);
  T a_next = lane == 31 ? inf : a_dn;
  if (kWide) {
    // across the halves: a's slot 31 is followed by b's slot 0, which the
    // wrapped shuffles deliver to lane 31 (b_dn) and lane 0 (a_up)
    const T b_dn = __shfl_sync(RSP_FULL_WARP, b, dn);
    const T b_up = __shfl_sync(RSP_FULL_WARP, b, up);
    a_next = lane == 31 ? b_dn : a_dn;
    const T next = lane == 31 ? inf : b_dn;
    const T prev = lane == 0 ? a_up : b_up;
    const T cur = b < vo ? b : next, cur_prev = prev < vo ? prev : b;
    b = cur < vi ? cur : (cur_prev < vi ? vi : cur_prev);
  }
  const T cur = a < vo ? a : a_next, cur_prev = a_up < vo ? a_up : a;
  a = cur < vi ? cur : (lane > 0 && !(cur_prev < vi) ? cur_prev : vi);
}

// Where rsp_gos_ranks reads the cells and puts the ranks, for Kernel C's
// tiles, Kernel G's frames of 2048 and more and the split route's tiles: the
// row, and the two statistic rows indexed like it by window start; every
// start keeps both ranks. (gos_rows.cuh's RspCellRows is the row plan's.)
template <typename T>
struct RspStartRows {
  static constexpr bool kStaged = false;  // see rsp_gos_ranks
  const T* __restrict__ row;
  T* st0;
  T* st1;
  __device__ __forceinline__ T at(int c) const { return row[c]; }
  // the starts between which every start keeps both ranks
  __device__ __forceinline__ int both_lo() const { return INT_MIN; }
  __device__ __forceinline__ int both_hi() const { return INT_MAX; }
  __device__ __forceinline__ bool has_lag(int) const { return true; }
  __device__ __forceinline__ bool has_lead(int) const { return true; }
  // where the lag / lead rank of start s goes; start s + 1's follows it
  __device__ __forceinline__ T* lag_at(int s) const { return st0 + s; }
  __device__ __forceinline__ T* lead_at(int s) const { return st1 + s; }
};

// The rank statistics of one warp's window starts s_a <= s < s_b: the
// min(k, nv-1)-th smallest (k = k0 for the lag rank, k1 for the lead rank)
// of the nv active cells of the window of cells s .. s + w - 1 (rows.at),
// 0 where nv = 0; cell c is active when alo <= c < ahi. The ranks go to
// rows.lag_at(s) / rows.lead_at(s), where the policy keeps them. The warp
// keeps the window sorted in slot `lane` of `a` and, for kWide (w = 64),
// slot 32 + lane of `b`; the top value past nv; the lane holding a rank
// stores it. Every branch is uniform over the warp. With Rows::kStaged the
// policy reads the cells through a slot map (gos_rows.cuh), and the
// whole-window starts go 16 at a time from one whose outgoing cell is
// 16-aligned: the 16 outgoing cells lie contiguous in the slot map
// (rows.run), so do the incoming ones where w is a multiple of 16, and
// each of the chunk's loads and stores is a constant offset from a base:
// the map's address arithmetic stays out of the per-start work, and the
// chunk's 32 loads all go ahead of its slides, so no load waits behind a
// rank store on the slide's chain of shuffles and compares.
template <bool kWide, typename T, typename Rows>
static __device__ __forceinline__ void rsp_gos_ranks(const Rows& rows, int s_a,
                                                     int s_b, int w, int alo,
                                                     int ahi, int k0, int k1) {
  const int lane = threadIdx.x & 31;
  const T inf = RspTop<T>::value();
  // cell c is active when (unsigned)(c - alo) < span
  const unsigned span = (unsigned)max(ahi - alo, 0);
  // the first window, row[s_a .. s_a + w), by a bitonic sort
  int c = s_a + lane;
  bool act = lane < w && (unsigned)(c - alo) < span;
  T a = rsp_warp_sort(act ? rows.at(c) : inf, lane);
  int nv = __popc(__ballot_sync(RSP_FULL_WARP, act));
  T b = inf;
  if (kWide) {
    c += 32;
    act = (unsigned)(c - alo) < span;
    nv += __popc(__ballot_sync(RSP_FULL_WARP, act));
    b = rsp_warp_sort(act ? rows.at(c) : inf, lane);
    // a ascending then b reversed is bitonic: the half-cleaner leaves the
    // lesser half in a, then each half is merged
    const T t = __shfl_sync(RSP_FULL_WARP, b, 31 - lane);
    const bool swap = t < a;
    b = swap ? a : t;
    a = swap ? t : a;
    a = rsp_warp_merge(a, lane);
    b = rsp_warp_merge(b, lane);
  }

  auto store = [&](int s) {
    const int j0 = max(min(k0, nv - 1), 0), j1 = max(min(k1, nv - 1), 0);
    const T x0 = kWide && j0 >= 32 ? b : a;
    const T x1 = kWide && j1 >= 32 ? b : a;
    if (lane == (j0 & 31) && rows.has_lag(s))
      *rows.lag_at(s) = nv > 0 ? x0 : T(0);
    if (lane == (j1 & 31) && rows.has_lead(s))
      *rows.lead_at(s) = nv > 0 ? x1 : T(0);
  };
  // the starts s whose slide keeps the whole window active (cells s - 1
  // and s - 1 + w both active, nv == w throughout) and which keep both
  // ranks: no range tests, and the ranks stay in the same slots
  const int f_lo = max(max(alo + 1, s_a + 1), rows.both_lo());
  const int f_hi = min(min(ahi - w + 1, s_b), rows.both_hi());
  const int f0 = min(k0, w - 1), f1 = min(k1, w - 1);
  store(s_a);
  for (int s = s_a + 1; s < s_b; ++s) {
    if (s == f_lo && f_lo < f_hi) {
      const bool p0 = lane == (f0 & 31), p1 = lane == (f1 & 31);
      const bool h0 = kWide && f0 >= 32, h1 = kWide && f1 >= 32;
      const auto step = [&](int s) {
        rsp_slide<kWide>(a, b, rows.at(s - 1), rows.at(s - 1 + w), lane);
        if (p0) *rows.lag_at(s) = h0 ? b : a;
        if (p1) *rows.lead_at(s) = h1 ? b : a;
      };
      if constexpr (Rows::kStaged) {
        for (const int s16 = min(f_hi, ((s + 14) & ~15) + 1); s < s16; ++s)
          step(s);
        const auto chunks = [&](const auto& in) {
          for (; s + 16 <= f_hi; s += 16) {
            // the chunk's cells into registers before any of its stores,
            // which the compiler may not move the loads past
            const T* out = rows.run(s - 1);
            T vo[16], vi[16];
#pragma unroll
            for (int t = 0; t < 16; ++t) {
              vo[t] = out[t];
              vi[t] = in(s - 1 + w, t);
            }
            T* lag = rows.lag_at(s);
            T* lead = rows.lead_at(s);
#pragma unroll
            for (int t = 0; t < 16; ++t) {
              rsp_slide<kWide>(a, b, vo[t], vi[t], lane);
              if (p0) lag[t] = h0 ? b : a;
              if (p1) lead[t] = h1 ? b : a;
            }
          }
        };
        if (kWide || (w & 15) == 0)
          chunks([&](int c, int t) { return rows.run(c)[t]; });
        else
          chunks([&](int c, int t) { return rows.at(c + t); });
      }
      for (; s < f_hi; ++s) step(s);
      if (s == s_b) break;
    }
    // slide by one cell: row[s - 1] leaves, row[s - 1 + w] enters
    const int co = s - 1, ci = co + w;
    const bool ao = (unsigned)(co - alo) < span;
    const bool ai = (unsigned)(ci - alo) < span;
    if (ao || ai) {
      rsp_slide<kWide>(a, b, ao ? rows.at(co) : inf, ai ? rows.at(ci) : inf,
                       lane);
      nv += (int)ai - (int)ao;
    }
    store(s);
  }
}

// st0[s] / st1[s] for the window starts s_lo <= s < s_hi: the lag / lead
// rank statistic of the window [s, s + w) (see rsp_gos_ranks), each warp of
// the block over a contiguous run of the starts. The caller synchronises
// before reading them.
template <typename T>
static __device__ __forceinline__ void rsp_gos_stats(
    const T* __restrict__ row, T* st0, T* st1, int s_lo, int s_hi, int w,
    int alo, int ahi, int k0, int k1) {
  const int warps = blockDim.x >> 5;
  const int per = (s_hi - s_lo + warps - 1) / warps;
  const int s_a = s_lo + (int)(threadIdx.x >> 5) * per;
  const int s_b = min(s_a + per, s_hi);
  if (s_a >= s_b) return;
  const RspStartRows<T> rows{row, st0, st1};
  if (w > 32)
    rsp_gos_ranks<true, T>(rows, s_a, s_b, w, alo, ahi, k0, k1);
  else
    rsp_gos_ranks<false, T>(rows, s_a, s_b, w, alo, ahi, k0, k1);
}

// Kernel C's tail. `row`: shared memory [RSP_PAD | T | RSP_PAD] holding the
// magnitude of cells ts - RSP_PAD .. ts + T + RSP_PAD - 1, zero outside the
// active range (and outside the frame). `st0`, `st1`: shared scratch of
// T + 2*RSP_PAD floats each, indexed like `row` by window start. The caller has synchronised
// after filling the row. Writes threshold and peaks of cells ts .. ts+T-1 to
// thr[0 .. T) and peaks[0 .. T).
static __device__ __forceinline__ void rsp_gos_tail(
    const float* __restrict__ row, float* st0, float* st1, int ts, int T,
    const RspGosRegs& r, float* __restrict__ thr,
    uint8_t* __restrict__ peaks) {
  const int w = 1 << r.log2w, g = r.guard;
  const int lo = r.active_lo, hi = r.active_hi;
  const int base = ts - RSP_PAD;  // cell index of row[0]
  // the window starts the tile's cells read: lag windows from ts - g - w,
  // lead windows up to ts + T - 1 + g + 1
  const int s_lo = RSP_PAD - g - w, s_hi = RSP_PAD + T + g + 1;

  if (r.cfar_mode == 3) {
    const int sw = r.sub_w;
    if (sw <= w) {
      // st0[s]: sum of the sw cells from start s; +inf unless wholly active
      for (int s = s_lo + threadIdx.x; s < s_hi + w - sw; s += blockDim.x) {
        float sum = 0.0f;
        for (int k = 0; k < sw; ++k) sum += row[s + k];
        const int q = base + s;
        st0[s] = q >= lo && q + sw <= hi ? sum : CUDART_INF_F;
      }
      __syncthreads();
    }
    // st1[s]: least sub-window mean inside the window [s, s + w)
    for (int s = s_lo + threadIdx.x; s < s_hi; s += blockDim.x) {
      float m = CUDART_INF_F;
      for (int t = 0; t <= w - sw; ++t) m = fminf(m, st0[s + t]);
      st1[s] = m < CUDART_INF_F ? m / (float)max(sw, 1) : 0.0f;
    }
  } else if (r.algorithm == 1) {
    rsp_gos_stats(row, st0, st1, s_lo, s_hi, w, lo - base, hi - base,
                  r.rank_lagg, r.rank_lead);
  }
  __syncthreads();

  const float inv_div = ldexpf(1.0f, -r.div_sum);
  for (int j = threadIdx.x; j < T; j += blockDim.x) {
    const int i = ts + j;
    if (i < lo || i >= hi) {
      thr[j] = 0.0f;
      peaks[j] = 0;
      continue;
    }
    const int s = RSP_PAD + j;
    const float* c = row + s;
    float noise;
    if (r.cfar_mode == 3) {
      noise = fmaxf(st1[s - g - w], st1[s + g + 1]);
    } else {
      float s_lag, s_lead;
      if (r.algorithm == 1) {
        s_lag = st0[s - g - w];
        s_lead = st1[s + g + 1];
      } else {
        float lag, lead;
        rsp_ca_sums(c, g, w, lag, lead);
        s_lag = lag * inv_div;
        s_lead = lead * inv_div;
      }
      noise = rsp_combine(r.cfar_mode, s_lag, s_lead);
    }
    const float t = rsp_threshold(noise, r.log_or_linear, r.scaler);
    thr[j] = t;
    peaks[j] = rsp_peak(c, i, t, r.peak_grouping, lo, hi);
  }
}
