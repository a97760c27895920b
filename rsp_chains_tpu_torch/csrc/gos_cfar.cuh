// Shared device functions of the GOSCA kernels: the rank selection of C
// (mag_gos_cfar.cu), D (chain_gos.cu), G (chain_int_gos.cu, and int_mid.cu
// and int_split.cu beyond N = 1024), and Kernel C's GOS / GOSCA / CASH CFAR
// tail over one range tile of one or two frames' magnitude rows in shared
// memory. D and G at N <= 1024 run the selection on the row plan's layout
// (gos_rows.cuh).
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
// The rank selection, templated on the value type (float for C and D, the
// int32 magnitudes for G) and on where it reads the cells and puts the
// ranks (RspStartRows here: a row and two statistic rows indexed by window
// start; gos_rows.cuh's RspCellRows for the row plan). A warp slides sorted
// windows over a run of window starts, the active cells of each window
// sorted in registers, the type's top value (+inf, INT32_MAX under signed
// compares) past the nv active ones. A bitonic sort builds a run's first
// window; each further start replaces the outgoing cell by the incoming
// one with compares against the neighbouring slots (two shuffles), and the
// lane holding each rank stores it. The k-th slot of the sorted multiset is
// the counting definition's k-th smallest, ties included, so the statistic
// is exact: no arithmetic touches a value. An active cell equal to the top
// value (G's square sum saturates to INT32_MAX) trades places with the
// padding, which leaves the multiset, and so every rank below nv, as it was.
//
// * w <= 32 (`rsp_gos_pair_ranks`): two windows a warp, one a half-warp,
//   two slots a lane; each load, shuffle and store instruction serves both
//   halves, about three a window start. Frame pairs (`rsp_gos_row_pairs`:
//   the same starts of two rows; C's range tile of two frames, D and G on
//   the row plan, G's 4 or 2 rows a block at N = 2048 and 4096) or run pairs
//   (`rsp_gos_stats`: one row, half 1 on the run an odd number of starts
//   past half 0's; G's one row a block at N = 8192 and 16384 and its split
//   tail's tiles).
// * w = 64 (`rsp_gos_ranks`): one window a warp, two slots a lane, four
//   shuffles a start; about six shared-memory or shuffle operations a start.
//
// Bound on the H100: the selection's pipe to shared memory and shuffles,
// not device memory. A whole-window start issues two broadcast loads (the
// outgoing and incoming cells), two shuffles and two single-lane stores (the
// ranks) at one warp instruction a clock an SM; two windows a warp share
// each of them, so a window start costs about 3 SM clocks (6 at w = 64),
// some three times the time of the 13 bytes of device traffic a cell.
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

// One slide of the sorted window of 64 slots held in slot `lane` of `a`
// and slot 32 + lane of `b`: vo leaves, vi enters, either of them the top
// value where its cell is inactive (the padding past nv). From its
// neighbours' slots a lane finds its own in the new window: after vo goes,
// the slots below vo keep theirs and the rest take their upper neighbour's;
// after vi comes, the slots below vi keep theirs, the first of the rest
// takes vi and the others their lower neighbour's. Compares only, no votes:
// equal values may trade slots, the multiset of values is exact.
template <typename T>
static __device__ __forceinline__ void rsp_slide(T& a, T& b, T vo, T vi,
                                                 int lane) {
  const T inf = RspTop<T>::value();
  const int up = (lane - 1) & 31, dn = (lane + 1) & 31;
  const T a_dn = __shfl_sync(RSP_FULL_WARP, a, dn);
  const T a_up = __shfl_sync(RSP_FULL_WARP, a, up);
  // across the halves: a's slot 31 is followed by b's slot 0, which the
  // wrapped shuffles deliver to lane 31 (b_dn) and lane 0 (a_up)
  const T b_dn = __shfl_sync(RSP_FULL_WARP, b, dn);
  const T b_up = __shfl_sync(RSP_FULL_WARP, b, up);
  const T a_next = lane == 31 ? b_dn : a_dn;
  const T next = lane == 31 ? inf : b_dn;
  const T prev = lane == 0 ? a_up : b_up;
  const T cur_b = b < vo ? b : next, prev_b = prev < vo ? prev : b;
  b = cur_b < vi ? cur_b : (prev_b < vi ? vi : prev_b);
  const T cur = a < vo ? a : a_next, cur_prev = a_up < vo ? a_up : a;
  a = cur < vi ? cur : (lane > 0 && !(cur_prev < vi) ? cur_prev : vi);
}

// Where rsp_gos_ranks and rsp_gos_pair_ranks read the cells and put the
// ranks, for Kernel C's tiles, Kernel G's frames of 2048 and more and the
// split route's tiles: the row, and the two statistic rows indexed like it by
// window start; every start keeps both ranks. (gos_rows.cuh's RspCellRows is
// the row plan's.)
template <typename T>
struct RspStartRows {
  static constexpr bool kStaged = false;  // see rsp_gos_ranks
  static constexpr int kAlign = 1;        // see rsp_gos_pair_ranks
  const T* __restrict__ row;
  T* st0;
  T* st1;
  __device__ __forceinline__ T at(int c) const { return row[c]; }
  // cells c, c + 1, ...: contiguous from here
  __device__ __forceinline__ const T* run(int c) const { return row + c; }
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
// rows.lag_at(s) / rows.lead_at(s), where the policy keeps them. For w =
// 64 (w <= 32 takes rsp_gos_pair_ranks): the warp keeps the window sorted
// in slot `lane` of `a` and slot 32 + lane of `b`, the top value past nv;
// the lane holding a rank stores it. Every branch is uniform over the
// warp. With Rows::kStaged the
// policy reads the cells through a slot map (gos_rows.cuh), and the
// whole-window starts go 16 at a time from one whose outgoing cell is
// 16-aligned: the 16 outgoing cells lie contiguous in the slot map
// (rows.run), so do the incoming ones, and each of the chunk's loads and
// stores is a constant offset from a base:
// the map's address arithmetic stays out of the per-start work, and the
// chunk's 32 loads all go ahead of its slides, so no load waits behind a
// rank store on the slide's chain of shuffles and compares.
template <typename T, typename Rows>
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
  c += 32;
  act = (unsigned)(c - alo) < span;
  nv += __popc(__ballot_sync(RSP_FULL_WARP, act));
  T b = rsp_warp_sort(act ? rows.at(c) : inf, lane);
  {
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
    const T x0 = j0 >= 32 ? b : a;
    const T x1 = j1 >= 32 ? b : a;
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
      const bool h0 = f0 >= 32, h1 = f1 >= 32;
      const auto step = [&](int s) {
        rsp_slide(a, b, rows.at(s - 1), rows.at(s - 1 + w), lane);
        if (p0) *rows.lag_at(s) = h0 ? b : a;
        if (p1) *rows.lead_at(s) = h1 ? b : a;
      };
      if constexpr (Rows::kStaged) {
        for (const int s16 = min(f_hi, ((s + 14) & ~15) + 1); s < s16; ++s)
          step(s);
        for (; s + 16 <= f_hi; s += 16) {
          // the chunk's cells into registers before any of its stores,
          // which the compiler may not move the loads past
          const T* out = rows.run(s - 1);
          const T* in = rows.run(s - 1 + w);
          T vo[16], vi[16];
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            vo[t] = out[t];
            vi[t] = in[t];
          }
          T* lag = rows.lag_at(s);
          T* lead = rows.lead_at(s);
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            rsp_slide(a, b, vo[t], vi[t], lane);
            if (p0) lag[t] = h0 ? b : a;
            if (p1) lead[t] = h1 ? b : a;
          }
        }
      }
      for (; s < f_hi; ++s) step(s);
      if (s == s_b) break;
    }
    // slide by one cell: row[s - 1] leaves, row[s - 1 + w] enters
    const int co = s - 1, ci = co + w;
    const bool ao = (unsigned)(co - alo) < span;
    const bool ai = (unsigned)(ci - alo) < span;
    if (ao || ai) {
      rsp_slide(a, b, ao ? rows.at(co) : inf, ai ? rows.at(ci) : inf, lane);
      nv += (int)ai - (int)ao;
    }
    store(s);
  }
}

// ---- two windows a warp, w <= 32 ----

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

// One half-warp's part of rsp_gos_pair_ranks: where its cells and ranks lie
// (`rows`, in the warp's start coordinates: the second half of a run pair
// sees its row shifted by its offset), its active cells [alo, ahi) in the
// same coordinates, and how many of the warp's starts, from the first, it
// keeps the ranks of (0: a dead frame's half, which stores nothing).
template <typename Rows>
struct RspHalf {
  Rows rows;
  int alo, ahi;
  int keep;
};

// rsp_gos_ranks two windows a warp, w <= 32: the half-warp of lane 16 h + l
// slides the window of its own half `hf` over the warp's starts s_a <= s <
// s_b. A half keeps one window of up to 32 cells sorted two slots a lane
// (slots 2l and 2l + 1 in lane l), the top value past its nv active cells,
// and each load, shuffle and store instruction serves both halves: about
// three a window start, where rsp_gos_ranks takes six. rsp_half_sort and
// rsp_half_slide shuffle at width 16 under the full mask, so every branch is
// uniform over the warp:
// * the whole-window stretch takes the starts where both halves' windows are
//   wholly active and every half that keeps keeps both ranks (the halves'
//   bounds met by a shuffle), 16 starts at a time from one whose outgoing
//   cell is Rows::kAlign-aligned (RspCellRows' slot map keeps 16 cells
//   contiguous), the chunk's 2 x 16 loads all ahead of its slides and
//   stores (no spill in G's mid-size kernel at 64 registers a thread);
// * elsewhere each start slides both halves, the top value out and in where
//   a half's cell is inactive (which leaves its sorted multiset as it was),
//   each half counting its own nv and storing under its own predicates; a
//   start where neither half's cells are active slides neither (a vote).
// Frame pairs give the halves two rows over the same starts; run pairs one
// row, half 1 on starts an odd number past half 0's, so that the two
// halves' words of one instruction fall in different banks.
template <typename T, typename Rows>
static __device__ __forceinline__ void rsp_gos_pair_ranks(
    const RspHalf<Rows>& hf, int s_a, int s_b, int w, int k0, int k1) {
  constexpr int A = Rows::kAlign, kChunk = 16;
  static_assert(A == 1 || A % kChunk == 0, "a chunk's cells lie contiguous");
  const int l = threadIdx.x & 15;
  const T inf = RspTop<T>::value();
  const Rows& rows = hf.rows;
  const unsigned span = (unsigned)max(hf.ahi - hf.alo, 0);
  const auto act = [&](int c) { return (unsigned)(c - hf.alo) < span; };
  const bool live = hf.keep > 0;
  const int s_k = s_a + hf.keep;  // the first start this half does not keep
  // the first window: slots 2l and 2l + 1 hold cells s_a + 2l, s_a + 2l + 1
  const int c = s_a + 2 * l;
  T x0 = 2 * l < w && act(c) ? rows.at(c) : inf;
  T x1 = 2 * l + 1 < w && act(c + 1) ? rows.at(c + 1) : inf;
  rsp_half_sort(x0, x1, l);
  int nv = max(min(s_a + w, hf.ahi) - max(s_a, hf.alo), 0);

  const auto store = [&](int s) {
    const int j0 = max(min(k0, nv - 1), 0), j1 = max(min(k1, nv - 1), 0);
    const bool kept = s < s_k;
    if (kept && l == (j0 >> 1) && rows.has_lag(s))
      *rows.lag_at(s) = nv > 0 ? (j0 & 1 ? x1 : x0) : T(0);
    if (kept && l == (j1 >> 1) && rows.has_lead(s))
      *rows.lead_at(s) = nv > 0 ? (j1 & 1 ? x1 : x0) : T(0);
  };
  // the whole-window starts, as in rsp_gos_ranks, met over the halves
  int f_lo = max(max(hf.alo + 1, s_a + 1), rows.both_lo());
  int f_hi = min(min(hf.ahi - w + 1, s_b), rows.both_hi());
  if (live) f_hi = min(f_hi, s_k);
  f_lo = max(f_lo, __shfl_xor_sync(RSP_FULL_WARP, f_lo, 16));
  f_hi = min(f_hi, __shfl_xor_sync(RSP_FULL_WARP, f_hi, 16));
  const int f0 = min(k0, w - 1), f1 = min(k1, w - 1);
  store(s_a);
  for (int s = s_a + 1; s < s_b; ++s) {
    if (s == f_lo && f_lo < f_hi) {
      const bool p0 = live && l == (f0 >> 1);
      const bool p1 = live && l == (f1 >> 1);
      const bool e0 = f0 & 1, e1 = f1 & 1;
      const auto step = [&](int s) {
        rsp_half_slide(x0, x1, rows.at(s - 1), rows.at(s - 1 + w), l);
        if (p0) *rows.lag_at(s) = e0 ? x1 : x0;
        if (p1) *rows.lead_at(s) = e1 ? x1 : x0;
      };
      if (A > 1)
        for (const int s_al = min(f_hi, ((s + A - 2) & ~(A - 1)) + 1);
             s < s_al; ++s)
          step(s);
      const auto chunks = [&](const auto& in) {
        for (; s + kChunk <= f_hi; s += kChunk) {
          // the chunk's cells into registers before any of its stores,
          // which the compiler may not move the loads past
          const T* out = rows.run(s - 1);
          T vo[kChunk], vi[kChunk];
#pragma unroll
          for (int t = 0; t < kChunk; ++t) {
            vo[t] = out[t];
            vi[t] = in(s - 1 + w, t);
          }
          T* lag = rows.lag_at(s);
          T* lead = rows.lead_at(s);
#pragma unroll
          for (int t = 0; t < kChunk; ++t) {
            rsp_half_slide(x0, x1, vo[t], vi[t], l);
            if (p0) lag[t] = e0 ? x1 : x0;
            if (p1) lead[t] = e1 ? x1 : x0;
          }
        }
      };
      if (w % A == 0)
        chunks([&](int c, int t) { return rows.run(c)[t]; });
      else
        chunks([&](int c, int t) { return rows.at(c + t); });
      for (; s < f_hi; ++s) step(s);
      if (s == s_b) break;
    }
    // slide by one cell: cell s - 1 leaves, s - 1 + w enters, each the top
    // value where it is inactive; skipped where neither half's is active
    const int co = s - 1, ci = co + w;
    const bool ao = act(co), ai = act(ci);
    if (__any_sync(RSP_FULL_WARP, ao || ai)) {
      rsp_half_slide(x0, x1, ao ? rows.at(co) : inf, ai ? rows.at(ci) : inf,
                     l);
      nv += (int)ai - (int)ao;
    }
    store(s);
  }
}

// Frame pairs: the rank statistics of a block's rows 0 .. live - 1, each
// over its window starts s_lo <= s < s_lo + len and the active cells [alo,
// ahi) that all its rows share. The starts, pair of rows after pair (w <=
// 32; row after row at w = 64), are cut into equal runs, one a warp, and a
// run is split where it crosses into the next pair, each piece with its own
// sort; both halves of a pair take the same starts and every branch
// together. rows_of(f) is row f's Rows, also for f = live where live is odd:
// that dead half reads its row but stores nothing. Every thread of the block
// calls it; the caller synchronises before (the rows) and after (the ranks).
template <typename T, typename RowsOf>
static __device__ __forceinline__ void rsp_gos_row_pairs(
    const RowsOf& rows_of, int live, int s_lo, int len, int w, int alo,
    int ahi, int k0, int k1) {
  using Rows = decltype(rows_of(0));
  if (ahi <= alo) return;  // no cell reads a rank
  const bool pairs = w <= 32;
  const int units = pairs ? (live + 1) / 2 : live;  // pairs or rows
  const int warps = blockDim.x >> 5;
  const int per = (units * len + warps - 1) / warps;
  int u = (int)(threadIdx.x >> 5) * per;
  const int u_end = min(u + per, units * len);
  while (u < u_end) {
    const int p = u / len;
    const int v = min(u_end, (p + 1) * len);
    const int s_a = s_lo + (u - p * len), s_b = s_a + (v - u);
    if (pairs) {
      const int f = 2 * p + (int)((threadIdx.x >> 4) & 1);
      rsp_gos_pair_ranks<T>(
          RspHalf<Rows>{rows_of(f), alo, ahi, f < live ? s_b - s_a : 0}, s_a,
          s_b, w, k0, k1);
    } else {
      rsp_gos_ranks<T>(rows_of(p), s_a, s_b, w, alo, ahi, k0, k1);
    }
    u = v;
  }
}

// st0[s] / st1[s] for the window starts s_lo <= s < s_hi of one row at w =
// 64: the lag / lead rank statistic of the window [s, s + w) (see
// rsp_gos_ranks), one run of the starts a warp.
template <typename T>
static __device__ __forceinline__ void rsp_gos_runs(
    const T* __restrict__ row, T* st0, T* st1, int s_lo, int s_hi, int w,
    int alo, int ahi, int k0, int k1) {
  const int warps = blockDim.x >> 5;
  const int per = (s_hi - s_lo + warps - 1) / warps;
  const int s_a = s_lo + (int)(threadIdx.x >> 5) * per;
  const int s_b = min(s_a + per, s_hi);
  if (s_a < s_b)
    rsp_gos_ranks<T>(RspStartRows<T>{row, st0, st1}, s_a, s_b, w, alo, ahi,
                     k0, k1);
}

// Run pairs: st0[s] / st1[s] for the window starts s_lo <= s < s_hi of one
// row, the lag / lead rank statistic of the window [s, s + w) (see
// rsp_gos_ranks). At w <= 32 the starts are cut into two runs a warp of the
// same odd length, half h of warp k on run 2k + h, so the halves' loads and
// stores fall that odd number of words apart, in different banks; a half
// whose run passes s_hi slides on over inactive cells and keeps nothing
// there. At w = 64 one run a warp (rsp_gos_runs). The caller synchronises
// before reading them.
template <typename T>
static __device__ __forceinline__ void rsp_gos_stats(
    const T* __restrict__ row, T* st0, T* st1, int s_lo, int s_hi, int w,
    int alo, int ahi, int k0, int k1) {
  if (w > 32) {
    rsp_gos_runs<T>(row, st0, st1, s_lo, s_hi, w, alo, ahi, k0, k1);
    return;
  }
  const int warps = blockDim.x >> 5, warp = threadIdx.x >> 5;
  const int per = ((s_hi - s_lo + 2 * warps - 1) / (2 * warps)) | 1;
  const int s_a = s_lo + 2 * warp * per;
  if (s_a >= s_hi) return;
  // no kept window reads a cell at or past s_hi - 1 + w, so the runs read
  // nothing past it
  ahi = min(ahi, s_hi - 1 + w);
  const int d = (int)((threadIdx.x >> 4) & 1) * per;
  rsp_gos_pair_ranks<T>(
      RspHalf<RspStartRows<T>>{{row + d, st0 + d, st1 + d}, alo - d, ahi - d,
                               max(min(per, s_hi - s_a - d), 0)},
      s_a, s_a + per, w, k0, k1);
}

// Kernel C's tail over one range tile of `live` of the block's kPair
// frames. kPair = 2 (frame pairs): the rank selection at w <= 32, two
// frames' windows a warp (rsp_gos_row_pairs);
// kPair = 1: CASH, the CA sums and the selection at w = 64, a frame a block
// (the pair's registers stay out of it). `smem`: 3 kPair rows of `stride`
// floats, the frames' magnitude rows, then their lag statistic rows, then
// their lead statistic rows (frame f's at f, kPair + f and 2 kPair + f
// strides). A magnitude row [RSP_PAD | T | RSP_PAD] holds the magnitude of
// cells ts - RSP_PAD .. ts + T + RSP_PAD - 1, zero outside the active range
// (and outside the frame); the statistic rows are indexed like it by
// window start. `stride` is an odd multiple of 16, so the two frames'
// words at one index lie in different banks. The caller has synchronised
// after filling the rows. Writes threshold and peaks of frame f's cells ts
// .. ts + T - 1 to thr[f n ..] and peaks[f n ..].
template <int kPair>
static __device__ __forceinline__ void rsp_gos_tail(
    float* smem, int stride, int live, int ts, int T, int n,
    const RspGosRegs& r, float* __restrict__ thr,
    uint8_t* __restrict__ peaks) {
  const int w = 1 << r.log2w, g = r.guard;
  const int lo = r.active_lo, hi = r.active_hi;
  const int base = ts - RSP_PAD;  // cell index of row[0]
  // the window starts the tile's cells read: lag windows from ts - g - w,
  // lead windows up to ts + T - 1 + g + 1
  const int s_lo = RSP_PAD - g - w, s_hi = RSP_PAD + T + g + 1;
  const auto row_of = [&](int f) { return smem + f * stride; };
  const auto st0_of = [&](int f) { return smem + (kPair + f) * stride; };
  const auto st1_of = [&](int f) { return smem + (2 * kPair + f) * stride; };

  if constexpr (kPair == 2) {
    rsp_gos_row_pairs<float>(
        [&](int f) {
          return RspStartRows<float>{row_of(f), st0_of(f), st1_of(f)};
        },
        live, s_lo, s_hi - s_lo, w, lo - base, hi - base, r.rank_lagg,
        r.rank_lead);
  } else if (r.cfar_mode == 3) {
    const int sw = r.sub_w;
    const float* row = row_of(0);
    float* st0 = st0_of(0);
    float* st1 = st1_of(0);
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
    rsp_gos_runs<float>(row_of(0), st0_of(0), st1_of(0), s_lo, s_hi, w,
                        lo - base, hi - base, r.rank_lagg, r.rank_lead);
  }
  __syncthreads();

  const float inv_div = ldexpf(1.0f, -r.div_sum);
  for (int jf = threadIdx.x; jf < live * T; jf += blockDim.x) {
    const int f = kPair == 1 ? 0 : jf / T, j = jf - f * T;
    const int i = ts + j;
    const size_t o = (size_t)f * n + j;
    if (i < lo || i >= hi) {
      thr[o] = 0.0f;
      peaks[o] = 0;
      continue;
    }
    const int s = RSP_PAD + j;
    const float* c = row_of(f) + s;
    const float* st0 = st0_of(f);
    const float* st1 = st1_of(f);
    float noise;
    if (kPair == 1 && r.cfar_mode == 3) {
      noise = fmaxf(st1[s - g - w], st1[s + g + 1]);
    } else {
      float s_lag, s_lead;
      if (kPair == 2 || r.algorithm == 1) {
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
    thr[o] = t;
    peaks[o] = rsp_peak(c, i, t, r.peak_grouping, lo, hi);
  }
}
