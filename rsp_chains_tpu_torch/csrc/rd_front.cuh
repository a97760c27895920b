// The range-Doppler front of Kernels H (rd_ca.cu) and J (rd_2d.cu): the
// Doppler transform over the pulses of each CPI, then, per Doppler row, the
// circular matched filter along range.
//
// Replaces the front of rsp_chains_tpu/kernels/rd_pallas.py (`_rd_front`
// :251, with `_mf_rows` :230, `_dot_left` :199 and the host constants
// `_h_block` :126 and `_doppler_triple` :163). The TPU kernel holds one
// channel's whole CPI [P, N] in VMEM, runs the matched filter along range
// first and the Doppler DFT as one [P, P] matmul. A CPI at P = 256,
// N = 1024 is 2 MiB of complex fp32, far past one block's 227 KB of shared
// memory, so this front splits it into two launches. The matched filter
// (along range) and the Doppler transform (along pulses) are linear maps on
// different axes, so they commute: the Doppler transform goes first, and the
// range launch can then end in the magnitude and the CFAR.
//
// * rsp_rd_doppler_kernel, one block per channel and RSP_RD_COLS range
//   columns: each pulse's 32 columns are one coalesced 128-byte read per
//   plane. The window multiplies the pulses, a radix-2 DIT over P runs in
//   shared memory (P x 32 x 8 bytes, 128 KB at P = 512) with the 32 columns
//   of a butterfly in the 32 lanes of a warp, and the store writes row k as
//   the centred bin k - P/2 under fftshift, the DIV_N / SQRT_N scale folded.
//   Bound: device memory, 16 bytes a sample in and out (~0.08 ms at
//   64 x 256 x 1024); it runs at about three times that, its log2 P stages
//   each ending in a barrier. It and the scratch round trip go together
//   once a channel's CPI stays on chip (ROADMAP queue 2).
// * rsp_rd_rows_kernel, N / 16 threads a Doppler row of N (256, 512, 1024;
//   a template parameter) and 256 / (N / 16) rows a block. The FFT pair is
//   register-resident: a thread holds 16 points, and each pass is radix-16
//   DFTs in registers (four radix-2 stages, constant twiddles) on cells at
//   a stride, then the pass twiddles, float64-rounded host tables read
//   through __ldg (no fast math: ~4e-7 relative, as the radix-2 FFT):
//   N = 16 x 16 (x 2 or x 4). The forward transform is a decimation in
//   frequency, natural order in and digit-reversed order out, in place; it
//   is multiplied by H in that same order (the host permutes H once,
//   kernels/rd.py `row_order`); the inverse is the adjoint of each pass in
//   reverse order (conjugate twiddles, then conjugate DFTs), digit-reversed
//   order in and natural order out, times 1/N. No bit reversal anywhere. The
//   first pass reads device memory and the last writes it, coalesced; the
//   last forward pass and the first inverse one share their cells, so H's
//   product stays in registers; between the other passes the cells go
//   through shared memory (an XOR swizzle, p ^ ((p >> 4) & 31), and a row
//   stride of N + 16 floats keep every access free of bank conflicts):
//   2 barriers a row pair at N = 256, 4 at 512 and 1024, against 20 radix-2
//   stages before. The row ends in the CA tail (Kernel H), the complex row
//   (emit='map') or the magnitude (Kernel J). Every cell of a row is read
//   before a barrier that comes before any write of it, so the map and
//   magnitude outputs may overwrite their input.
//   Bound: device memory, 8 bytes a sample in and 5 (CA), 8 (map) or 4
//   (magnitude) out; the two FFTs' ~1.7e9 flops at 64 x 256 x 1024 take
//   ~0.025 ms at the fp32 rate.
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

#define RSP_RD_COLS 32
#define RSP_RD_OUT_CFAR 0
#define RSP_RD_OUT_MAP 1
#define RSP_RD_OUT_MAG 2

// Launch 1: the windowed Doppler DFT of RSP_RD_COLS range columns of one
// channel. Grid (channels, N / RSP_RD_COLS). Static, as every kernel of
// this header: each source that includes it gets its own copy.
static __global__ void __launch_bounds__(RSP_THREADS)
rsp_rd_doppler_kernel(const float* __restrict__ re,
                      const float* __restrict__ im,
                      const float2* __restrict__ twp,
                      const float* __restrict__ win, float* __restrict__ yre,
                      float* __restrict__ yim, int log2p, int log2n,
                      float scale, int fft_shift) {
  extern __shared__ float smem[];
  const int p = 1 << log2p;
  const int n = 1 << log2n;
  float* xr = smem;                    // [p][RSP_RD_COLS], bit-reversed rows
  float* xi = smem + p * RSP_RD_COLS;
  const size_t base = (size_t)blockIdx.x * p * n + blockIdx.y * RSP_RD_COLS;

  for (int idx = threadIdx.x; idx < p * RSP_RD_COLS; idx += blockDim.x) {
    const int q = idx / RSP_RD_COLS, c = idx % RSP_RD_COLS;
    const int j = __brev(q) >> (32 - log2p);
    const size_t g = base + (size_t)q * n + c;
    const float wq = win[q];
    xr[j * RSP_RD_COLS + c] = re[g] * wq;
    xi[j * RSP_RD_COLS + c] = im[g] * wq;
  }
  __syncthreads();
  for (int s = 1; s <= log2p; ++s) {
    const int half = 1 << (s - 1);
    for (int idx = threadIdx.x; idx < (p / 2) * RSP_RD_COLS;
         idx += blockDim.x) {
      const int b = idx / RSP_RD_COLS, c = idx % RSP_RD_COLS;
      const int pos = b & (half - 1);
      const int i0 = (((b >> (s - 1)) << s) + pos) * RSP_RD_COLS + c;
      const int i1 = i0 + half * RSP_RD_COLS;
      const float2 w = twp[pos << (log2p - s)];
      const float br = xr[i1], bi = xi[i1];
      const float tr = fmaf(w.x, br, -w.y * bi);
      const float ti = fmaf(w.x, bi, w.y * br);
      const float ar = xr[i0], ai = xi[i0];
      xr[i0] = ar + tr;
      xi[i0] = ai + ti;
      xr[i1] = ar - tr;
      xi[i1] = ai - ti;
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < p * RSP_RD_COLS; idx += blockDim.x) {
    const int k = idx / RSP_RD_COLS, c = idx % RSP_RD_COLS;
    const int src = fft_shift ? (k + p / 2) & (p - 1) : k;
    const size_t g = base + (size_t)k * n + c;
    yre[g] = xr[src * RSP_RD_COLS + c] * scale;
    yim[g] = xi[src * RSP_RD_COLS + c] * scale;
  }
}

// ---- Launch 2: the range rows ----

// The plan of a row of kN cells: kT threads a row, kRows rows a block,
// passes of radix 16 at strides kT and kM2, then (kM2 > 1) one of radix kM2
// at stride 1; kS floats a row plane of the FFT buffer, kMagS a CA
// magnitude row ([RSP_PAD | kN | RSP_PAD], padded one float in 16).
template <int kN>
struct RspRowPlan {
  static constexpr int kT = kN / 16;
  static constexpr int kRows = RSP_THREADS / kT;
  static constexpr int kM2 = kN / 256;
  static constexpr int kS = kN + 16;
  static constexpr int kMagS = (kN + 2 * RSP_PAD) / 16 * 17 + 16;
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

// In-register DFT of R points (R = 2, 4 or 16) in slots xr/xi[0 .. R),
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

// Slots k to / from cells b + stride * k of a row's planes.
static __device__ __forceinline__ void rsp_put(float* pr, float* pi, int b,
                                               int stride, const float* xr,
                                               const float* xi) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    pr[rsp_fft_slot(b + stride * k)] = xr[k];
    pi[rsp_fft_slot(b + stride * k)] = xi[k];
  }
}

static __device__ __forceinline__ void rsp_get(const float* pr,
                                               const float* pi, int b,
                                               int stride, float* xr,
                                               float* xi) {
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    xr[k] = pr[rsp_fft_slot(b + stride * k)];
    xi[k] = pi[rsp_fft_slot(b + stride * k)];
  }
}

// A[k] / B[k] = the sums of cells a + k .. a + k + w - 1 / b + k .. b + k +
// w - 1 of a magnitude row, for k < C <= w, by adds only: the cells every
// window holds (from a + C - 1 to a + w - 1) once, the left edges as a
// running sum downwards and the right edges upwards; the two sides' sums
// interleave, so each chain of dependent adds waits on half the loads.
// 2 (w + C - 1) reads.
template <int C>
static __device__ __forceinline__ void rsp_run_sums(const float* rw, int a,
                                                    int b, int w,
                                                    float (&A)[C],
                                                    float (&B)[C]) {
  float ma = 0.0f, mb = 0.0f;
  for (int t = C - 1; t < w; ++t) {
    ma += rw[rsp_mag_slot(RSP_PAD + a + t)];
    mb += rw[rsp_mag_slot(RSP_PAD + b + t)];
  }
  float ea = 0.0f, eb = 0.0f;
  A[C - 1] = ma;
  B[C - 1] = mb;
#pragma unroll
  for (int k = C - 2; k >= 0; --k) {
    ea += rw[rsp_mag_slot(RSP_PAD + a + k)];
    eb += rw[rsp_mag_slot(RSP_PAD + b + k)];
    A[k] = ea + ma;
    B[k] = eb + mb;
  }
  ea = eb = 0.0f;
#pragma unroll
  for (int k = 1; k < C; ++k) {
    ea += rw[rsp_mag_slot(RSP_PAD + a + w + k - 1)];
    eb += rw[rsp_mag_slot(RSP_PAD + b + w + k - 1)];
    A[k] += ea;
    B[k] += eb;
  }
}

// The CA/GO/SO tail of cells i0 .. i0 + 15 of one row, as rsp_ca_tail
// computes it (PARTIAL edges, the mode, the scaler, the active mask, peak
// grouping): `rw` the row's magnitudes at rsp_mag_slot(RSP_PAD + cell),
// zero outside the active range and the frame; C = min(w, 16) windows of
// each side at a time. Writes thr[i0 .. i0 + 16) and peaks[i0 .. i0 + 16),
// both 16-byte aligned.
template <int C>
static __device__ __forceinline__ void rsp_ca_runs(
    const float* rw, int i0, const RspCaRegs& r, float* __restrict__ thr,
    uint8_t* __restrict__ peaks) {
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
  float4* t4 = reinterpret_cast<float4*>(thr + i0);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    t4[q] = make_float4(t[4 * q], t[4 * q + 1], t[4 * q + 2], t[4 * q + 3]);
  *reinterpret_cast<uint4*>(peaks + i0) = make_uint4(pk[0], pk[1], pk[2],
                                                     pk[3]);
}

// Launch 2: the matched filter along each Doppler row of kN cells, then per
// kOut the CA tail (thr = o0, peaks = o1), the complex row (o0 = re,
// o1 = im) or the magnitude (o0). `tw`: the pass twiddles of `rd_row_twiddles`
// (kernels/rd.py); `h`: H's [2, kN] planes in the forward output's
// digit-reversed order. yre/yim may alias o0/o1. Grid ceil(rows / kRows).
// Two blocks an SM: unbounded, the unrolled passes take ~170 registers a
// thread and one block an SM; at 128 a few slots spill and the launch runs
// faster for the second block's overlap.
template <int kN, int kOut>
static __global__ void __launch_bounds__(RSP_THREADS, 2)
rsp_rd_rows_kernel(const float* yre, const float* yim,
                   const float2* __restrict__ tw, const float* __restrict__ h,
                   float* o0, void* o1, int rows, RspCaRegs r) {
  using P = RspRowPlan<kN>;
  constexpr int T = P::kT, M2 = P::kM2;
  extern __shared__ float smem[];
  const int q = threadIdx.x / T, m = threadIdx.x % T;
  const int row = blockIdx.x * P::kRows + q;
  const bool live = row < rows;
  const size_t base = (size_t)row * kN;
  float* pr = smem + q * P::kS;  // this row's planes of the FFT buffer
  float* pi = pr + P::kRows * P::kS;
  float xr[16], xi[16];

  // forward pass 1: radix 16 over cells m + T r, twiddles W_N^(m k)
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    xr[j] = live ? yre[base + m + T * j] : 0.0f;
    xi[j] = live ? yim[base + m + T * j] : 0.0f;
  }
  rsp_dft<16, false>(xr, xi);
  rsp_twiddle<false>(xr, xi, tw + m, T);
  rsp_put(pr, pi, m, T, xr, xi);
  __syncthreads();
  // forward pass 2: radix 16 at stride M2 inside a block of T cells,
  // twiddles W_T^(m2 k)
  const int m2 = m % M2, b2 = T * (m / M2) + m2;
  rsp_get(pr, pi, b2, M2, xr, xi);
  rsp_dft<16, false>(xr, xi);
  if constexpr (M2 > 1) {
    rsp_twiddle<false>(xr, xi, tw + kN + m2, M2);
    rsp_put(pr, pi, b2, M2, xr, xi);
    __syncthreads();
    // forward pass 3: radix M2 over the contiguous groups of cells
    // 16 m .. 16 m + 15
    rsp_get(pr, pi, 16 * m, 1, xr, xi);
#pragma unroll
    for (int j = 0; j < 16; j += M2) rsp_dft<M2, false>(xr + j, xi + j);
  }
  // slot j holds the spectrum's cell 16 m + j: times H in the same order
  const float4* hr = reinterpret_cast<const float4*>(h + 16 * m);
  const float4* hi = reinterpret_cast<const float4*>(h + kN + 16 * m);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 a = __ldg(hr + j), b = __ldg(hi + j);
    rsp_cmul<false>(xr[4 * j], xi[4 * j], make_float2(a.x, b.x));
    rsp_cmul<false>(xr[4 * j + 1], xi[4 * j + 1], make_float2(a.y, b.y));
    rsp_cmul<false>(xr[4 * j + 2], xi[4 * j + 2], make_float2(a.z, b.z));
    rsp_cmul<false>(xr[4 * j + 3], xi[4 * j + 3], make_float2(a.w, b.w));
  }
  // the inverse: the passes' adjoints in reverse order
  if constexpr (M2 > 1) {
#pragma unroll
    for (int j = 0; j < 16; j += M2) rsp_dft<M2, true>(xr + j, xi + j);
    rsp_put(pr, pi, 16 * m, 1, xr, xi);
    __syncthreads();
    rsp_get(pr, pi, b2, M2, xr, xi);
    rsp_twiddle<true>(xr, xi, tw + kN + m2, M2);
  }
  rsp_dft<16, true>(xr, xi);
  rsp_put(pr, pi, b2, M2, xr, xi);
  __syncthreads();
  rsp_get(pr, pi, m, T, xr, xi);
  rsp_twiddle<true>(xr, xi, tw + m, T);
  rsp_dft<16, true>(xr, xi);
  // slot j: cell m + T j of the filtered row, times 1/N
  const float inv_n = 1.0f / kN;
  if constexpr (kOut == RSP_RD_OUT_CFAR) {
    float* rw = smem + 2 * P::kRows * P::kS + q * P::kMagS;
    for (int j = m; j < RSP_PAD; j += T) {
      rw[rsp_mag_slot(j)] = 0.0f;
      rw[rsp_mag_slot(RSP_PAD + kN + j)] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int i = m + T * j;
      const bool active = i >= r.active_lo && i < r.active_hi;
      rw[rsp_mag_slot(RSP_PAD + i)] =
          active ? rsp_magnitude(xr[j] * inv_n, xi[j] * inv_n, r.mag_mode)
                 : 0.0f;
    }
    __syncthreads();
    if (!live) return;
    float* thr = o0 + base;
    uint8_t* pk = static_cast<uint8_t*>(o1) + base;
    switch (r.log2w) {
      case 0: rsp_ca_runs<1>(rw, 16 * m, r, thr, pk); break;
      case 1: rsp_ca_runs<2>(rw, 16 * m, r, thr, pk); break;
      case 2: rsp_ca_runs<4>(rw, 16 * m, r, thr, pk); break;
      case 3: rsp_ca_runs<8>(rw, 16 * m, r, thr, pk); break;
      default: rsp_ca_runs<16>(rw, 16 * m, r, thr, pk); break;
    }
    return;
  }
  if (!live) return;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const size_t i = base + m + T * j;
    if (kOut == RSP_RD_OUT_MAP) {
      o0[i] = xr[j] * inv_n;
      static_cast<float*>(o1)[i] = xi[j] * inv_n;
    } else {
      o0[i] = rsp_magnitude(xr[j] * inv_n, xi[j] * inv_n, r.mag_mode);
    }
  }
}

// Shared memory of the two launches.
static inline size_t rsp_rd_doppler_smem(int log2p) {
  return (size_t)2 * (1 << log2p) * RSP_RD_COLS * sizeof(float);
}

template <int kN, int kOut>
static inline size_t rsp_rd_rows_smem() {
  using P = RspRowPlan<kN>;
  return (size_t)P::kRows *
         (2 * P::kS + (kOut == RSP_RD_OUT_CFAR ? P::kMagS : 0)) *
         sizeof(float);
}

// Launch 2 for a row of kN cells over `rows` rows.
template <int kN, int kOut>
static inline cudaError_t rsp_rd_rows(const float* yre, const float* yim,
                                      const float* tw, const float* h,
                                      float* o0, void* o1, int rows,
                                      cudaStream_t stream, RspCaRegs r) {
  const size_t smem = rsp_rd_rows_smem<kN, kOut>();
  cudaError_t e = rsp_opt_in(rsp_rd_rows_kernel<kN, kOut>, smem);
  if (e != cudaSuccess) return e;
  constexpr int kRows = RspRowPlan<kN>::kRows;
  rsp_rd_rows_kernel<kN, kOut><<<(rows + kRows - 1) / kRows, RSP_THREADS,
                                 smem, stream>>>(
      yre, yim, reinterpret_cast<const float2*>(tw), h, o0, o1, rows, r);
  return cudaGetLastError();
}

// Launch 1 into (yre, yim), then launch 2 with output kOut. tw_n: the range
// pass twiddles; h: H in the forward output's order (kernels/rd.py). Returns
// the first CUDA error.
template <int kOut>
static inline int rsp_rd_launch(const float* re, const float* im, float* yre,
                                float* yim, float* o0, void* o1, int batch,
                                cudaStream_t stream, const float* tw_p,
                                const float* win, const float* tw_n,
                                const float* h, int log2p, int log2n,
                                float dop_scale, int fft_shift, RspCaRegs r) {
  const size_t s1 = rsp_rd_doppler_smem(log2p);
  cudaError_t e = rsp_opt_in(rsp_rd_doppler_kernel, s1);
  if (e != cudaSuccess) return (int)e;
  rsp_rd_doppler_kernel<<<dim3(batch, (1 << log2n) / RSP_RD_COLS),
                          RSP_THREADS, s1, stream>>>(
      re, im, reinterpret_cast<const float2*>(tw_p), win, yre, yim, log2p,
      log2n, dop_scale, fft_shift);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rows = batch << log2p;
  switch (log2n) {
    case 8:
      return (int)rsp_rd_rows<256, kOut>(yre, yim, tw_n, h, o0, o1, rows,
                                         stream, r);
    case 9:
      return (int)rsp_rd_rows<512, kOut>(yre, yim, tw_n, h, o0, o1, rows,
                                         stream, r);
    case 10:
      return (int)rsp_rd_rows<1024, kOut>(yre, yim, tw_n, h, o0, o1, rows,
                                          stream, r);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
