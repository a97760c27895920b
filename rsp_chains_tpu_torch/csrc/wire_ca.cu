// Kernel E: the wire top's whole CA chain, packed IQ beat words in, packed
// {threshold | bin | peak} words out, one thread block per frame.
//
// Replaces rsp_chains_tpu/kernels/chain_pallas.py::fused_chain_ca_packed
// (:1042, pallas_call :1122; body `_chain_kernel_packed` :742-800). It is
// Kernel A (chain_ca.cu) with another prologue and epilogue: the prologue
// unpacks each word (real in bits [31:16], imag in [15:0], each sign-extended)
// straight into the bit-reversed shared-memory frame of the FFT front
// (fft_radix2.cuh), and the epilogue emits one word per cell from the CA tail
// of ca_cfar.cuh: the threshold clipped to [0, 2^(31 - log2n) - 1] and
// truncated, in bits [31:log2n+1], the bin in [log2n:1], the peak in bit 0.
//
// Bound on the H100: device memory. A sample costs 8 bytes (a 4-byte word in,
// a 4-byte word out) against Kernel A's 13, for the same shared-memory work,
// so its floor is 8/13 of Kernel A's.
#include <cuda_runtime.h>

#include "ca_cfar.cuh"
#include "fft_radix2.cuh"

__global__ void __launch_bounds__(RSP_THREADS)
rsp_wire_ca_kernel(const uint32_t* __restrict__ words,
                   const float2* __restrict__ tw, uint32_t* __restrict__ out,
                   int log2n, float scale, RspCaRegs r) {
  extern __shared__ float smem[];
  const int n = 1 << log2n;
  float* xr = smem;
  float* xi = smem + n;
  float* row = smem + 2 * n;  // [RSP_PAD | n | RSP_PAD]
  const size_t base = (size_t)blockIdx.x * n;

  for (int j = threadIdx.x; j < RSP_PAD; j += blockDim.x) {
    row[j] = 0.0f;
    row[RSP_PAD + n + j] = 0.0f;
  }
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    // sign-extend each half on unsigned values: a left shift of a negative
    // int is undefined in C++17
    const uint32_t w = words[base + i];
    const int j = __brev(i) >> (32 - log2n);
    xr[j] = (float)(int16_t)(uint16_t)(w >> 16);
    xi[j] = (float)(int16_t)(uint16_t)(w & 0xFFFFu);
  }
  rsp_fft_radix2_stages(tw, xr, xi, log2n);

  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const bool active = i >= r.active_lo && i < r.active_hi;
    row[RSP_PAD + i] =
        active ? rsp_magnitude(xr[i] * scale, xi[i] * scale, r.mag_mode) : 0.0f;
  }
  __syncthreads();

  const float thr_max = (float)((1u << (31 - log2n)) - 1u);
  uint32_t* o = out + base;
  rsp_ca_tail_each(row, n, r, [&](int i, float t, uint8_t pk) {
    const uint32_t ti = (uint32_t)fminf(fmaxf(t, 0.0f), thr_max);
    o[i] = (ti << (log2n + 1)) | ((uint32_t)i << 1) | (uint32_t)pk;
  });
}

// words, out: uint32 [frames, 2^log2n] (the int32 view of the same bits is
// passed by the wrapper); tw: float32 [2^(log2n-1), 2] (cos, sin); all
// contiguous on the current device, 8 <= log2n <= 10. Launches on `stream`;
// returns cudaGetLastError().
extern "C" int rsp_wire_ca(const uint32_t* words, uint32_t* out, int frames,
                           cudaStream_t stream, const float* tw, int log2n,
                           float scale, RspCaRegs regs) {
  const int n = 1 << log2n;
  const size_t smem = (size_t)(3 * n + 2 * RSP_PAD) * sizeof(float);
  rsp_wire_ca_kernel<<<frames, RSP_THREADS, smem, stream>>>(
      words, reinterpret_cast<const float2*>(tw), out, log2n, scale, regs);
  return (int)cudaGetLastError();
}
