// The register-resident row FFT and the run-sum CA tail, shared by the range
// rows of Kernels H and J (rd_front.cuh), Kernels A (chain_ca.cu), D
// (chain_gos.cu, with the rank selection of gos_rows.cuh), E (wire_ca.cu)
// and I (pc_ca.cu), in integers Kernels F and G (int_rows.cuh), and the
// tail alone by Kernel B (mag_cfar.cu). Kernel E gives the forward
// transform its own pass-1 load (`rsp_row_forward_with`: a functor) and the
// tail its own store (`rsp_ca_row_with`: a policy); A, B, D, H and I take
// the float planes and RspCaStore.
//
// * The plan of a row of N = 256, 512, 1024, 2048 or 4096 cells
//   (RspRowPlan): N / 16 threads a row (at most 256), 256 / (N / 16) rows a
//   block (one at N = 4096), 16 cells a thread. Each pass is radix-16 DFTs in
//   registers (four radix-2 stages, constant twiddles, `rsp_dft`) on cells
//   at a stride, then the pass twiddles, float64-rounded host tables read
//   through __ldg (kernels/chain.py `row_twiddles`; no fast math: ~4e-7
//   relative, as a radix-2 FFT): N = 16 x 16 (x 2, 4, 8 or 16). The forward
//   transform (`rsp_row_forward`) is a decimation in frequency, natural
//   order in and digit-reversed order out, in place (kernels/chain.py
//   `row_order`; `rsp_row_bin`). The first pass reads device memory,
//   coalesced; between passes the cells go through shared memory (an XOR
//   swizzle, p ^ ((p >> 4) & 31), and a row stride of N + 16 floats keep
//   every access free of bank conflicts): 1 barrier at N = 256, 2 above,
//   against log2 N radix-2 stages.
// * The CA tail (`rsp_ca_runs`): a thread takes 16 contiguous cells of the
//   magnitude row and sums each side's windows with adds only, the cells
//   every window of the run holds once and the edges as running sums (about
//   w + 16 shared reads a side for 16 cells, against 2w a cell), so its
//   rounding is a plain sum's. The magnitude row is padded one float in 16,
//   so the 16-cell runs of a warp's lanes fall in distinct banks.
//
// Every sum stays fp32 FMA (no tensor cores, no low precision): a single
// low-precision pass missed the accuracy bar on the TPU.
#pragma once

#include <cuda_runtime.h>

#include "ca_cfar.cuh"

// Blocks an SM in the launch bounds of Kernels A's, D's, F's, G's and I's
// row kernels (rsp_chain_ca_rows_kernel, rsp_chain_gos_rows_kernel,
// rsp_chain_int_rows_kernel, rsp_chain_int_gos_rows_kernel,
// rsp_pc_ca_rows_kernel); chip_smoke.py builds and times them at 1 to 4
// (`row_blocks`).
#ifndef RSP_ROWS_BLOCKS
#define RSP_ROWS_BLOCKS 3
#endif

// Floats of a CA magnitude row of `len` cells, [RSP_PAD | len | RSP_PAD]
// padded one float in 16 (`rsp_mag_slot`).
static __host__ __device__ constexpr int rsp_mag_floats(int len) {
  return (len + 2 * RSP_PAD) / 16 * 17 + 16;
}

// The plan of a row of kN cells: kT threads a row, kRows rows a block,
// passes of radix 16 at strides kT and kM2, then (kM2 > 1) one of radix kM2
// (2, 4, 8 or 16) at stride 1; kS floats a row plane of the FFT buffer,
// kMagS a CA magnitude row.
template <int kN>
struct RspRowPlan {
  static_assert(kN >= 256 && kN <= 4096 && (kN & (kN - 1)) == 0,
                "the row plan takes N = 256 ... 4096");
  static constexpr int kT = kN / 16;
  static constexpr int kRows = RSP_THREADS / kT;
  static constexpr int kM2 = kN / 256;
  static constexpr int kS = kN + 16;
  static constexpr int kMagS = rsp_mag_floats(kN);
};

// Where cell p of a row plane lives: within each 32 floats, XOR-swizzled by
// bits 4.. of p.
static __device__ __forceinline__ int rsp_fft_slot(int p) {
  return p ^ ((p >> 4) & 31);
}

// Where cell i of a magnitude row lives: one float of padding in 16.
static __device__ __forceinline__ int rsp_mag_slot(int i) {
  return i + (i >> 4);
}

// The spectrum bin at cell p of the forward output (kernels/chain.py
// `row_order`): cell d1 kT + d2 kM2 + d3 holds bin d1 + 16 d2 + 256 d3.
template <int kN>
static __device__ __forceinline__ int rsp_row_bin(int p) {
  using P = RspRowPlan<kN>;
  return p / P::kT + 16 * (p % P::kT / P::kM2) + 256 * (p % P::kM2);
}

// exp(-2 pi i k / 16), k in [0, 16); folds to constants for a constant k.
static __device__ __forceinline__ float2 rsp_w16(int k) {
  const float c1 = 0.92387953251128674f;  // cos(pi / 8)
  const float c2 = 0.70710678118654752f;  // cos(pi / 4)
  const float c3 = 0.38268343236508977f;  // cos(3 pi / 8)
  float c, s;  // cos and sin of 2 pi (k mod 4) / 16
  switch (k & 3) {
    case 0: c = 1.0f; s = 0.0f; break;
    case 1: c = c1; s = c3; break;
    case 2: c = c2; s = c2; break;
    default: c = c3; s = c1; break;
  }
  switch ((k >> 2) & 3) {  // times (-i)^(k / 4)
    case 0: return make_float2(c, -s);
    case 1: return make_float2(-s, -c);
    case 2: return make_float2(-c, s);
    default: return make_float2(s, c);
  }
}

// (re, im) times w, or times conj(w) for kConj.
template <bool kConj>
static __device__ __forceinline__ void rsp_cmul(float& re, float& im,
                                                float2 w) {
  const float wi = kConj ? -w.y : w.y;
  const float r = fmaf(w.x, re, -wi * im);
  im = fmaf(w.x, im, wi * re);
  re = r;
}

// Bit reversal of k over log2(R) bits.
template <int R>
static __device__ __forceinline__ constexpr int rsp_brev(int k) {
  int v = 0;
  for (int b = 1; b < R; b <<= 1) v = (v << 1) | ((k & b) ? 1 : 0);
  return v;
}

// In-register DFT of R points (R = 2, 4, 8 or 16) in slots xr/xi[0 .. R),
// natural order in and out: sum_r x[r] exp(-+2 pi i r k / R) (+ for kConj),
// by radix-2 decimation-in-frequency stages. Every index is a constant once
// unrolled, so the slots stay registers and the final reordering is free.
template <int R, bool kConj>
static __device__ __forceinline__ void rsp_dft(float* xr, float* xi) {
#pragma unroll
  for (int half = R / 2; half >= 1; half >>= 1) {
#pragma unroll
    for (int b = 0; b < R / 2; ++b) {
      const int pos = b % half;
      const int i0 = b / half * 2 * half + pos, i1 = i0 + half;
      const float dr = xr[i0] - xr[i1], di = xi[i0] - xi[i1];
      xr[i0] += xr[i1];
      xi[i0] += xi[i1];
      const int k = pos * (16 / (2 * half));  // W_{2 half}^pos = W_16^k
      if (k == 0) {
        xr[i1] = dr;
        xi[i1] = di;
      } else if (k == 4) {  // times -i, or i for kConj
        xr[i1] = kConj ? -di : di;
        xi[i1] = kConj ? dr : -dr;
      } else {
        xr[i1] = dr;
        xi[i1] = di;
        rsp_cmul<kConj>(xr[i1], xi[i1], rsp_w16(k));
      }
    }
  }
  float tr[R], ti[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    tr[k] = xr[rsp_brev<R>(k)];
    ti[k] = xi[rsp_brev<R>(k)];
  }
#pragma unroll
  for (int k = 0; k < R; ++k) {
    xr[k] = tr[k];
    xi[k] = ti[k];
  }
}

// Slot k (k >= 1) times the pass twiddle tw[k * stride] (conjugated for
// kConj); slot 0's twiddle is 1.
template <bool kConj>
static __device__ __forceinline__ void rsp_twiddle(
    float* xr, float* xi, const float2* __restrict__ tw, int stride) {
#pragma unroll
  for (int k = 1; k < 16; ++k)
    rsp_cmul<kConj>(xr[k], xi[k], __ldg(tw + k * stride));
}

// Slots k to / from cells b + stride * k of a row's planes (float or int).
template <typename V>
static __device__ __forceinline__ void rsp_put(V* pr, V* pi, int b,
                                               int stride, const V* xr,
                                               const V* xi) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    pr[rsp_fft_slot(b + stride * k)] = xr[k];
    pi[rsp_fft_slot(b + stride * k)] = xi[k];
  }
}

template <typename V>
static __device__ __forceinline__ void rsp_get(const V* pr, const V* pi,
                                               int b, int stride, V* xr,
                                               V* xi) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    xr[k] = pr[rsp_fft_slot(b + stride * k)];
    xi[k] = pi[rsp_fft_slot(b + stride * k)];
  }
}

// The forward transform of a row of kN cells by its kT threads (this one
// m): `load(j, re, im)` gives the cell m + kT j (pass 1's load, in order of
// j), slot j = the spectrum's cell 16 m + j (bin rsp_row_bin(16 m + j))
// out. pr / pi: the row's planes of the FFT buffer. Every thread of the
// block calls it: it holds 1 (kN = 256) or 2 barriers, and the last pass
// reads the planes after the last of them. Pass 3 is 16 / kM2 DFTs of radix
// kM2 (8 at kN = 2048, one of 16 at 4096).
template <int kN, typename Load>
static __device__ __forceinline__ void rsp_row_forward_with(
    Load load, int m, const float2* __restrict__ tw, float* pr, float* pi,
    float* xr, float* xi) {
  using P = RspRowPlan<kN>;
  constexpr int T = P::kT, M2 = P::kM2;
  // pass 1: radix 16 over cells m + T r, twiddles W_N^(m k)
#pragma unroll
  for (int j = 0; j < 16; ++j) load(j, xr[j], xi[j]);
  rsp_dft<16, false>(xr, xi);
  rsp_twiddle<false>(xr, xi, tw + m, T);
  rsp_put(pr, pi, m, T, xr, xi);
  __syncthreads();
  // pass 2: radix 16 at stride M2 inside a block of T cells, twiddles
  // W_T^(m2 k)
  const int m2 = m % M2, b2 = T * (m / M2) + m2;
  rsp_get(pr, pi, b2, M2, xr, xi);
  rsp_dft<16, false>(xr, xi);
  if constexpr (M2 > 1) {
    rsp_twiddle<false>(xr, xi, tw + kN + m2, M2);
    rsp_put(pr, pi, b2, M2, xr, xi);
    __syncthreads();
    // pass 3: radix M2 over the contiguous groups of cells 16 m .. 16 m + 15
    rsp_get(pr, pi, 16 * m, 1, xr, xi);
#pragma unroll
    for (int j = 0; j < 16; j += M2) rsp_dft<M2, false>(xr + j, xi + j);
  }
}

// rsp_row_forward_with over the float planes yre / yim: cells m + kT j of
// the row at `base`, zeros where !live (Kernels A, H and I).
template <int kN>
static __device__ __forceinline__ void rsp_row_forward(
    const float* yre, const float* yim, size_t base, bool live, int m,
    const float2* __restrict__ tw, float* pr, float* pi, float* xr,
    float* xi) {
  constexpr int T = RspRowPlan<kN>::kT;
  rsp_row_forward_with<kN>(
      [&](int j, float& re, float& im) {
        re = live ? yre[base + m + T * j] : 0.0f;
        im = live ? yim[base + m + T * j] : 0.0f;
      },
      m, tw, pr, pi, xr, xi);
}

// A[k] / B[k] = the sums of cells a + k .. a + k + w - 1 / b + k .. b + k +
// w - 1 of a magnitude row, for k < C <= w, by adds only: the cells every
// window holds (from a + C - 1 to a + w - 1) once, the left edges as a
// running sum downwards and the right edges upwards; the two sides' sums
// interleave, so each chain of dependent adds waits on half the loads.
// 2 (w + C - 1) reads. V = float, or uint32_t for Kernel F's wrapping sums.
template <int C, typename V>
static __device__ __forceinline__ void rsp_run_sums(const V* rw, int a, int b,
                                                    int w, V (&A)[C],
                                                    V (&B)[C]) {
  V ma = 0, mb = 0;
  for (int t = C - 1; t < w; ++t) {
    ma += rw[rsp_mag_slot(RSP_PAD + a + t)];
    mb += rw[rsp_mag_slot(RSP_PAD + b + t)];
  }
  V ea = 0, eb = 0;
  A[C - 1] = ma;
  B[C - 1] = mb;
#pragma unroll
  for (int k = C - 2; k >= 0; --k) {
    ea += rw[rsp_mag_slot(RSP_PAD + a + k)];
    eb += rw[rsp_mag_slot(RSP_PAD + b + k)];
    A[k] = ea + ma;
    B[k] = eb + mb;
  }
  ea = eb = 0;
#pragma unroll
  for (int k = 1; k < C; ++k) {
    ea += rw[rsp_mag_slot(RSP_PAD + a + w + k - 1)];
    eb += rw[rsp_mag_slot(RSP_PAD + b + w + k - 1)];
    A[k] += ea;
    B[k] += eb;
  }
}

// The store of a 16-cell run's thresholds and peak bytes (Kernels A, B, H
// and I): thr[i0 .. i0 + 16) as four float4, peaks[i0 .. i0 + 16) as one
// uint4, both 16-byte aligned. pk[q] holds the peak bytes of cells
// 4 q .. 4 q + 3 of the run, byte j & 3 the cell j.
struct RspCaStore {
  float* thr;
  uint8_t* peaks;
  __device__ __forceinline__ void operator()(int i0, const float (&t)[16],
                                             const uint32_t (&pk)[4]) const {
    float4* t4 = reinterpret_cast<float4*>(thr + i0);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      t4[q] = make_float4(t[4 * q], t[4 * q + 1], t[4 * q + 2], t[4 * q + 3]);
    *reinterpret_cast<uint4*>(peaks + i0) = make_uint4(pk[0], pk[1], pk[2],
                                                       pk[3]);
  }
};

// The CA/GO/SO tail of cells i0 .. i0 + 15 of one row (PARTIAL edges, the
// mode, the scaler, the active mask, peak grouping): `rw` the row's
// magnitudes at rsp_mag_slot(RSP_PAD + cell), zero outside the active range
// and the frame; C = min(w, 16) windows of each side at a time. Hands the
// run's thresholds and peak bits to `store(i0, t, pk)` (RspCaStore, or
// Kernel E's packed words).
template <int C, typename Store>
static __device__ __forceinline__ void rsp_ca_runs(const float* rw, int i0,
                                                   const RspCaRegs& r,
                                                   const Store& store) {
  const int w = 1 << r.log2w, g = r.guard;
  const int lo = r.active_lo, hi = r.active_hi;
  const float inv_div = ldexpf(1.0f, -r.div_sum);
  float t[16];
  uint32_t pk[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int c0 = 0; c0 < 16; c0 += C) {
    float lag[C], lead[C];
    rsp_run_sums<C>(rw, i0 + c0 - g - w, i0 + c0 + g + 1, w, lag, lead);
#pragma unroll
    for (int k = 0; k < C; ++k) {
      const int j = c0 + k, i = i0 + j;
      const float m = rw[rsp_mag_slot(RSP_PAD + i)];
      const float th = rsp_threshold(
          rsp_combine(r.cfar_mode, lag[k] * inv_div, lead[k] * inv_div),
          r.log_or_linear, r.scaler);
      bool p = m > th;
      if (p && r.peak_grouping == 1) {
        const float left = i - 1 >= lo ? rw[rsp_mag_slot(RSP_PAD + i - 1)]
                                       : -CUDART_INF_F;
        const float right = i + 1 < hi ? rw[rsp_mag_slot(RSP_PAD + i + 1)]
                                       : -CUDART_INF_F;
        p = m >= left && m >= right;
      }
      const bool active = i >= lo && i < hi;
      t[j] = active ? th : 0.0f;
      if (active && p) pk[j >> 2] |= 1u << (8 * (j & 3));
    }
  }
  store(i0, t, pk);
}

// rsp_ca_runs over a row, one thread a 16-cell run (cells 16 m ..),
// C = min(w, 16) from the window register, each run to `store`.
template <typename Store>
static __device__ __forceinline__ void rsp_ca_row_with(const float* rw, int m,
                                                       const RspCaRegs& r,
                                                       const Store& store) {
  switch (r.log2w) {
    case 0: rsp_ca_runs<1>(rw, 16 * m, r, store); break;
    case 1: rsp_ca_runs<2>(rw, 16 * m, r, store); break;
    case 2: rsp_ca_runs<4>(rw, 16 * m, r, store); break;
    case 3: rsp_ca_runs<8>(rw, 16 * m, r, store); break;
    default: rsp_ca_runs<16>(rw, 16 * m, r, store); break;
  }
}

// rsp_ca_row_with and RspCaStore: thresholds to thr, peak bytes to pk.
static __device__ __forceinline__ void rsp_ca_row(const float* rw, int m,
                                                  const RspCaRegs& r,
                                                  float* __restrict__ thr,
                                                  uint8_t* __restrict__ pk) {
  rsp_ca_row_with(rw, m, r, RspCaStore{thr, pk});
}
