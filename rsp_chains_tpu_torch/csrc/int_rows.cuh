// Kernel F's front and tail for frames of N = 256, 512 or 1024: the integer
// FFT butterflies of int_front.cuh on the row plan of row_fft.cuh, and an
// integer run-sum CA tail. Kernel G's frames of 256-1024 (chain_int_gos.cu)
// take the same front; the 8192-cell body below (the split route's
// sub-frames, int_split.cu, and the mid-size route's frames, int_mid.cu)
// the same passes; both routes the same tail.
//
// * The passes: thread m of a frame's N / 16 holds the 16 cells m + (N / 16) k
//   and runs the first four radix-2 DIF stages on them in registers (stage
//   s pairs the cells i and i + N >> (s + 1): slots k and k + 8, 4, 2, 1);
//   the cells cross through shared memory (int planes, the float plan's
//   swizzle) to the cells at stride N / 256 inside blocks of N / 16 (`b2` of
//   `rsp_row_forward`) for the next four stages, and at N = 512 and 1024
//   once more to the contiguous cells 16 m .. 16 m + 15 for the last one or
//   two. Each butterfly is `rsp_int_butterfly` with its stage's flags and
//   the twiddle tw[half + j]: each butterfly rounds on its own
//   (ops/bit_true.py `_fft_int_fixed`), so where a cell sits and how the
//   stages are grouped change no bit. No twiddles merge across stages and
//   no constant radix-16 DFT is used, since every stage rounds. 1 barrier
//   at N = 256, 2 at 512 and 1024, against log2 N.
// * The spectrum ends in bit-reversed order: each thread takes the
//   magnitude of its cells in registers and stores each at its natural
//   bin, __brev of the cell, in the frame's padded magnitude row.
// * The tail: wrapping uint32_t addition is associative and commutative, so
//   the run sums of `rsp_run_sums` equal the direct wrapping window sums
//   exactly; then `>> div_sum`, `rsp_int_combine`, the threshold and the
//   peak test of `rsp_int_thr_peak`, threshold and peak 0 at and beyond
//   n_active.
#pragma once

#include "int_front.cuh"
#include "row_fft.cuh"

// One stage's kSlots / 2 butterflies on a thread's kSlots cells (slot k at
// cell base + stride k), pairing slots k and k + hs, with the stage flags
// given.
template <int kSlots>
static __device__ __forceinline__ void rsp_int_stage(
    int* xr, int* xi, int base, int stride, int hs,
    const int2* __restrict__ tw, bool expanding, bool lsb, bool grown) {
  const int half = hs * stride;  // the pair distance in cells
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    if (k & hs) continue;
    const int j = (base + stride * k) & (half - 1);
    rsp_int_butterfly(xr[k], xi[k], xr[k + hs], xi[k + hs],
                      __ldg(tw + half + j), expanding, lsb, grown);
  }
}

// kStages radix-2 DIF stages of the integer FFT, the first stage s0, on a
// thread's kSlots cells: slot k at cell base + stride k, the first stage
// pairing slots k and k + 2^(kStages - 1). `grown`: whether a stage so far
// expanded.
// A stage that rounds half up on data that has not grown (every stage at
// the bench's configuration) takes the flags as constants, which fold away;
// any other stage takes them at run time, where the unrolled butterflies
// compute every path and select. The branch is uniform across the block.
template <int kStages, int kSlots = 16>
static __device__ __forceinline__ void rsp_int_pass(
    int* xr, int* xi, int base, int stride, int s0,
    const int2* __restrict__ tw, unsigned expand_mask, unsigned lsb_mask,
    bool& grown) {
#pragma unroll
  for (int l = 0; l < kStages; ++l) {
    const int hs = (1 << (kStages - 1)) >> l;  // pair distance in slots
    const int s = s0 + l;
    const bool expanding = (expand_mask >> s) & 1u;
    const bool lsb = !expanding && ((lsb_mask >> s) & 1u);
    grown = grown || expanding;
    if (!grown && !lsb)
      rsp_int_stage<kSlots>(xr, xi, base, stride, hs, tw, false, false,
                            false);
    else
      rsp_int_stage<kSlots>(xr, xi, base, stride, hs, tw, expanding, lsb,
                            grown);
  }
}

// The integer FFT and magnitude of a frame of kN cells by its kT threads
// (this one m): cells m + kT k of re / im at `base` (zeros where !live) in;
// out, the magnitude of each bin at rw[rsp_mag_slot(RSP_PAD + bin)], zero at
// and beyond n_active, with RSP_PAD zeros on each side. pr / pi: the frame's
// planes of the FFT buffer. Every thread of the block calls it; ends with
// __syncthreads().
template <int kN>
static __device__ __forceinline__ void rsp_int_front_rows(
    const int* __restrict__ re, const int* __restrict__ im, size_t base,
    bool live, int m, const int2* __restrict__ tw, int* pr, int* pi,
    int* rw, unsigned expand_mask, unsigned lsb_mask, const RspIntRegs& r) {
  using P = RspRowPlan<kN>;
  constexpr int T = P::kT, M2 = P::kM2;
  constexpr int kLog2N = kN == 256 ? 8 : kN == 512 ? 9 : 10;
  int xr[16], xi[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    xr[k] = live ? re[base + m + T * k] : 0;
    xi[k] = live ? im[base + m + T * k] : 0;
  }
  bool grown = false;
  rsp_int_pass<4>(xr, xi, m, T, 0, tw, expand_mask, lsb_mask, grown);
  rsp_put(pr, pi, m, T, xr, xi);
  __syncthreads();
  const int b2 = T * (m / M2) + m % M2;
  rsp_get(pr, pi, b2, M2, xr, xi);
  rsp_int_pass<4>(xr, xi, b2, M2, 4, tw, expand_mask, lsb_mask, grown);
  if constexpr (M2 > 1) {
    rsp_put(pr, pi, b2, M2, xr, xi);
    __syncthreads();
    rsp_get(pr, pi, 16 * m, 1, xr, xi);
    rsp_int_pass<M2 == 4 ? 2 : 1>(xr, xi, 16 * m, 1, 8, tw, expand_mask,
                                  lsb_mask, grown);
  }
  for (int j = m; j < RSP_PAD; j += T) {
    rw[rsp_mag_slot(j)] = 0;
    rw[rsp_mag_slot(RSP_PAD + kN + j)] = 0;
  }
  // slot k holds the cell 16 m + k, the bin brev(16 m + k)
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const int bin = __brev(16 * m + k) >> (32 - kLog2N);
    rw[rsp_mag_slot(RSP_PAD + bin)] =
        bin < r.n_active ? rsp_int_magnitude(xr[k], xi[k], r.mag_mode) : 0;
  }
  __syncthreads();
}

// Kernel F's CA/GO/SO tail of cells i0 .. i0 + 15 of a row whose cell 0 is
// the frame's cell `org` (0 for a whole frame; a tile's first cell in
// int_split.cu): `rw` the row's magnitudes at rsp_mag_slot(RSP_PAD + cell),
// zero at and beyond n_active and outside the frame; C = min(w, 16) windows
// of each side at a time. Writes thr[i0 .. i0 + 16) and peaks[i0 .. i0 +
// 16), both 16-byte aligned.
template <int C>
static __device__ __forceinline__ void rsp_int_ca_runs(
    const int* rw, int i0, const RspIntRegs& r, int* __restrict__ thr,
    uint8_t* __restrict__ peaks, int org = 0) {
  const int w = 1 << r.log2w, g = r.guard, hi = r.n_active;
  const uint32_t* uw = reinterpret_cast<const uint32_t*>(rw);
  int t[16];
  uint32_t pk[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c0 = 0; c0 < 16; c0 += C) {
    uint32_t lag[C], lead[C];
    rsp_run_sums<C>(uw, i0 + c0 - g - w, i0 + c0 + g + 1, w, lag, lead);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = c0 + k, i = i0 + j, f = org + i;  // f: in the frame
      const int m = rw[rsp_mag_slot(RSP_PAD + i)];
      const int th = rsp_int_threshold(
          rsp_int_combine(r.cfar_mode, (int)lag[k] >> r.div_sum,
                          (int)lead[k] >> r.div_sum),
          r);
      bool p = m > th;
      if (p && r.peak_grouping == 1) {
        const int left = f >= 1 ? rw[rsp_mag_slot(RSP_PAD + i - 1)]
                                : RSP_PEAK_EDGE;
        const int right = f + 1 < hi ? rw[rsp_mag_slot(RSP_PAD + i + 1)]
                                     : RSP_PEAK_EDGE;
        p = m >= left && m >= right;
      }
      const bool active = f < hi;
      t[j] = active ? th : 0;
      if (active && p) pk[j >> 2] |= 1u << (8 * (j & 3));
    }
  }
  int4* t4 = reinterpret_cast<int4*>(thr + i0);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    t4[q] = make_int4(t[4 * q], t[4 * q + 1], t[4 * q + 2], t[4 * q + 3]);
  *reinterpret_cast<uint4*>(peaks + i0) = make_uint4(pk[0], pk[1], pk[2],
                                                     pk[3]);
}

// ---- The 8192-cell body of the split route (int_split.cu) and of the
// mid-size route (int_mid.cu) ----
//
// A block of 1024 threads holds 8192 cells in registers, 8 a thread, and
// runs 13 radix-2 DIF stages on them in passes of 3 stages at the strides
// 1024, 128, 16 and 2 (`rsp_int_pass`), the cells crossing between passes
// through two int planes of shared memory under an XOR swizzle free of
// bank conflicts (`rsp_split_slot`), then the last stage across lane pairs
// by shuffles (`rsp_split_last`): 3 barriers against 13 stages. The split
// route runs it on a sub-frame of a longer frame (the masks shifted right),
// the mid-size route on 1, 2 or 4 whole frames (the first stages skipped,
// the masks shifted left) or on half a frame after its first stage.

#define RSP_SPLIT_LOG2 13   // the body's cells, 8192
#define RSP_SPLIT_CELLS 8   // cells a body thread, 1024 threads

// Where cell p of a body plane lives: the low 5 bits XOR-swizzled by bits
// 5-7, so that each pass's exchange is free of bank conflicts.
static __device__ __forceinline__ int rsp_split_slot(int p) {
  const int q = p >> 5;
  return p ^ ((q & 7) | ((q & 1) << 3) | ((q & 4) << 2));
}

// Slots k < RSP_SPLIT_CELLS to / from the cells b + stride k of the body's
// planes.
static __device__ __forceinline__ void rsp_split_put(int* pr, int* pi, int b,
                                                     int stride,
                                                     const int* xr,
                                                     const int* xi) {
#pragma unroll
  for (int k = 0; k < RSP_SPLIT_CELLS; ++k) {
    pr[rsp_split_slot(b + stride * k)] = xr[k];
    pi[rsp_split_slot(b + stride * k)] = xi[k];
  }
}

static __device__ __forceinline__ void rsp_split_get(const int* pr,
                                                     const int* pi, int b,
                                                     int stride, int* xr,
                                                     int* xi) {
#pragma unroll
  for (int k = 0; k < RSP_SPLIT_CELLS; ++k) {
    xr[k] = pr[rsp_split_slot(b + stride * k)];
    xi[k] = pi[rsp_split_slot(b + stride * k)];
  }
}

// The block's last DIF stage (body stage 12: the cells 2j and 2j + 1, the
// unity twiddle tw[1]) after a pass at stride 2, in registers: lanes m and
// m ^ 1 hold a block's even and odd cells in slot order, and the even lane
// takes the butterflies of slots k < 4, the odd lane the rest, each lane
// trading half its slots with the other by shuffles. Leaves the cell 8 m + k
// in slot k.
static __device__ __forceinline__ void rsp_split_last(
    int* xr, int* xi, int m, const int2* __restrict__ tw, unsigned em,
    unsigned lm, bool grown) {
  constexpr int H = RSP_SPLIT_CELLS / 2, st = RSP_SPLIT_LOG2 - 1;
  const bool odd = m & 1;
  const bool expanding = (em >> st) & 1u;
  const bool lsb = !expanding && ((lm >> st) & 1u);
  grown = grown || expanding;
  const int2 w = __ldg(tw + 1);
  int yr[RSP_SPLIT_CELLS], yi[RSP_SPLIT_CELLS];
#pragma unroll
  for (int k = 0; k < H; ++k) {
    // the even lane's slot k pairs with the odd lane's slot k
    const int gr = __shfl_xor_sync(0xffffffffu, odd ? xr[k] : xr[H + k], 1);
    const int gi = __shfl_xor_sync(0xffffffffu, odd ? xi[k] : xi[H + k], 1);
    int ar = odd ? gr : xr[k], ai = odd ? gi : xi[k];
    int br = odd ? xr[H + k] : gr, bi = odd ? xi[H + k] : gi;
    if (!grown && !lsb)
      rsp_int_butterfly(ar, ai, br, bi, w, false, false, false);
    else
      rsp_int_butterfly(ar, ai, br, bi, w, expanding, lsb, grown);
    yr[2 * k] = ar;
    yi[2 * k] = ai;
    yr[2 * k + 1] = br;
    yi[2 * k + 1] = bi;
  }
#pragma unroll
  for (int k = 0; k < RSP_SPLIT_CELLS; ++k) {
    xr[k] = yr[k];
    xi[k] = yi[k];
  }
}

// Body pass kPass of a block of 8192 cells on a thread's 8 cells: body
// stages 3 kPass .. 3 kPass + 2 on the cells base + stride k inside blocks
// of 2^(13 - 3 kPass) cells (body stage t pairs cells 2^(12 - t) apart),
// the first pass skipping its first kSkip stages (the block holds 2^kSkip
// frames of 2^(13 - kSkip) cells: their first stage is body stage kSkip,
// and the masks come shifted left by kSkip); the slots cross through the
// planes pr / pi to the next pass, and after the pass at stride 2 the last
// stage runs across lane pairs (rsp_split_last). The first pass's cells
// come in in the slots; the last stage's leave in them (slot k: cell
// 8 m + k).
template <int kPass, int kSkip = 0>
static __device__ __forceinline__ void rsp_split_passes(
    int* xr, int* xi, int* pr, int* pi, int m, const int2* __restrict__ tw,
    unsigned em, unsigned lm, bool& grown) {
  constexpr int c = 3;  // log2 RSP_SPLIT_CELLS
  constexpr int p0 = c * kPass;
  constexpr int lb = RSP_SPLIT_LOG2 - p0;  // log2 of the block
  constexpr int ls = lb - c;               // log2 of the stride
  constexpr int skip = kPass == 0 ? kSkip : 0;
  static_assert(ls >= 1, "13 stages: whole passes, then one stage");
  static_assert(kSkip >= 0 && kSkip < c, "frames of 2^11 cells or more");
  const int base = ((m >> ls) << lb) | (m & ((1 << ls) - 1));
  if (kPass > 0) rsp_split_get(pr, pi, base, 1 << ls, xr, xi);
  rsp_int_pass<c - skip, RSP_SPLIT_CELLS>(xr, xi, base, 1 << ls, p0 + skip,
                                          tw, em, lm, grown);
  if constexpr (ls == 1) {
    rsp_split_last(xr, xi, m, tw, em, lm, grown);
  } else {
    rsp_split_put(pr, pi, base, 1 << ls, xr, xi);
    __syncthreads();
    rsp_split_passes<kPass + 1, kSkip>(xr, xi, pr, pi, m, tw, em, lm, grown);
  }
}
