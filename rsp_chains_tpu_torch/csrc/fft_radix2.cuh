// The FFT front of Kernel D (chain_gos.cu), the one frame-per-block float
// kernel left: an iterative radix-2 decimation in time in fp32 FMA over one
// frame in shared memory. (Kernels A, E and I and the range rows of H and J
// run the register-resident radix-16 passes of row_fft.cuh.)
//
// Replaces the four-step matmul FFT of rsp_chains_tpu/kernels/chain_pallas.py
// (`_chain_core` :541 / `_fft_block_order`, with `_dft_blocks` and
// `_dot_pass3`). The input is loaded in bit-reversed order, log2 N butterfly
// stages follow, and the output is in natural order. Twiddles
// exp(-2 pi i k / N), k < N/2, are computed on the host in float64 and rounded
// to float32. No tensor core path: a single low-precision pass missed the
// accuracy bar by ~1.4e-3 relative on the TPU (chain_pallas.py:878-887), and
// fp32 FMA is not the bound here.
#pragma once

// The butterfly stages over one frame already in shared memory in
// bit-reversed order, xr/xi (2^log2n floats each), 1 <= log2n <= 12; the
// output is in natural order. Every thread of the block takes part; starts
// and ends with __syncthreads(), so the loads before it and the spectrum
// after it are visible to the whole block.
static __device__ __forceinline__ void rsp_fft_radix2_stages(
    const float2* __restrict__ tw, float* xr, float* xi, int log2n) {
  const int n = 1 << log2n;
  __syncthreads();
  for (int s = 1; s <= log2n; ++s) {
    const int half = 1 << (s - 1);
    for (int b = threadIdx.x; b < n / 2; b += blockDim.x) {
      const int pos = b & (half - 1);
      const int i0 = ((b >> (s - 1)) << s) + pos;
      const int i1 = i0 + half;
      const float2 w = tw[pos << (log2n - s)];
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
}

// Transforms re/im[0 .. 2^log2n) (device memory, one frame) into xr/xi
// (shared memory, 2^log2n floats each), 1 <= log2n <= 12, as
// rsp_fft_radix2_stages.
static __device__ __forceinline__ void rsp_fft_radix2(
    const float* __restrict__ re, const float* __restrict__ im,
    const float2* __restrict__ tw, float* xr, float* xi, int log2n) {
  const int n = 1 << log2n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int j = __brev(i) >> (32 - log2n);
    xr[j] = re[i];
    xi[j] = im[i];
  }
  rsp_fft_radix2_stages(tw, xr, xi, log2n);
}
