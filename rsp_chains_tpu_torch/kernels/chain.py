"""The whole-chain kernels (FFT, scale, magnitude, CFAR in one kernel) and the
chain stages that honour the FFT-size and CFAR registers.

* Kernel A, ``chain_ca``: CA/GO/SO. Replaces
  ``rsp_chains_tpu/kernels/chain_pallas.py::fused_chain_ca`` (:841,
  ``pallas_call`` :1013); CUDA source ``csrc/chain_ca.cu``.
* Kernel D, ``chain_gos``: GOS / GOSCA / CASH. Replaces
  ``chain_pallas.py::fused_chain_gos`` (:1221, ``pallas_call`` :1306); CUDA
  source ``csrc/chain_gos.cu``, Kernel A's row plan with the warp-resident
  rank selection of ``csrc/gos_cfar.cuh`` over the block's frames
  (``csrc/gos_rows.cuh``); it also counts the peaks
  (``CfarOutput.detections``).
* Kernel E, ``wire_ca``: the wire top's CA chain, packed IQ beat words in,
  packed ``{threshold | bin | peak}`` words out. Replaces
  ``chain_pallas.py::fused_chain_ca_packed`` (:1042, ``pallas_call`` :1122);
  CUDA source ``csrc/wire_ca.cu``, Kernel A's row plan with a load that
  unpacks the words and a tail store that packs them. It moves 8 bytes per
  sample, not 13.
* Kernel I, ``pc_ca``: the collapsed pulse-compression chain, Kernel A with
  the matched filter's reference spectrum H multiplied into the spectrum
  before the magnitude, frames of N = 256 ... 4096. Replaces the ``h_block``
  variant of ``chain_pallas.py::fused_chain_ca`` (operand :997-1006); CUDA
  source ``csrc/pc_ca.cu``, Kernel A's row kernel with the product and an
  entry of its own.
* ``fused_chain_ca_op``, ``fused_chain_gos_op`` and ``fused_wire_chain_op``,
  the ports of ``chain_pallas.py:1402``, ``:1350`` and ``:1432``.

Kernels A, D, E and I run the register-resident row FFT of
``csrc/row_fft.cuh`` (Kernel H's range rows share it): radix-16 passes over
``ROW_RADICES``, the spectrum left in digit-reversed order (``row_order``)
and each magnitude stored at its natural bin, the pass twiddles
``row_twiddles``; I multiplies H in that order (``_permuted``). Each CUDA
source says what bounds its kernel on the H100 and how its design answers. The spectrum stays on
chip: a kernel reads the IQ pair once and writes threshold and peaks once. A
wrapper launches its kernel for CUDA tensors and uses the plain version
(``*_reference``) only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..configs import CfarConfig, FftConfig, RuntimeConfig
from ..cplx import C, CLike, as_pair, join
from ..ops.cfar import CfarOutput
from ..ops.fft import check_keep_msb, fft_op, fft_scale
from ..packing import as_words, pack_cfar_words, unpack_iq_pair
from .cfar import (
    CaRegs, ca_like, ca_registers, call_entry, check_cuda_operands,
    check_window_bounds, entry, fused_mag_gos_dispatch, gos_registers, launch,
    mag_cfar, mag_cfar_reference, takes_plain_path,
)

FUSABLE_SIZES = (256, 512, 1024)
PC_SIZES = (256, 512, 1024, 2048, 4096)   # Kernel I (presets.py:462-464)
# the row plan's passes for each frame size (csrc/row_fft.cuh): radix 16 at
# strides N / 16 and N / 256, then radix N / 256 over contiguous groups
ROW_RADICES = {256: (16, 16), 512: (16, 16, 2), 1024: (16, 16, 4),
               2048: (16, 16, 8), 4096: (16, 16, 16)}


def row_order(n: int) -> np.ndarray:
    """The spectrum bin at each cell of the row plan's forward output: a
    decimation in frequency in place leaves bin ``R1 * k' + p // (n / R1)``
    at cell p, k' the bin at cell ``p % (n / R1)`` of the sub-transform over
    the remaining radices."""
    def bin_at(p: int, radices: tuple, size: int) -> int:
        if not radices:
            return 0
        r, sub = radices[0], size // radices[0]
        return r * bin_at(p % sub, radices[1:], sub) + p // sub

    return np.array([bin_at(p, ROW_RADICES[n], n) for p in range(n)])


def row_twiddles(n: int) -> np.ndarray:
    """The row plan's pass twiddles as [n + 16 * (n // 256), 2] float32
    (cos, sin), computed in float64: W_n^(m k) at [k * n/16 + m] (pass 1,
    m < n/16), then W_(n/16)^(m k) at [n + k * (n // 256) + m] (pass 2,
    m < n/256); k < 16. Pass 3's are all 1. The Doppler column plan
    (``csrc/rd_front.cuh``) takes the same table at n = P = 8 ... 512: pass
    1's only below P = 256 (none at P = 8, where one radix-8 pass runs)."""
    t, m2 = n // 16, n // 256
    k = np.arange(16)[:, None]
    w = np.concatenate([
        np.exp(-2j * np.pi * k * np.arange(t) / n).ravel(),
        np.exp(-2j * np.pi * k * np.arange(m2) / t).ravel()])
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _row_twiddles(n: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(row_twiddles(n)).to(device)


@functools.lru_cache(maxsize=64)
def _permuted(h: torch.Tensor) -> torch.Tensor:
    """The [2, n] planes ``h`` in ``row_order``, for a row kernel that
    multiplies H into its digit-reversed spectrum; computed once per H
    tensor (the cache holds it by identity)."""
    n = h.shape[-1]
    return h[:, torch.from_numpy(row_order(n)).to(h.device)].contiguous()


def _check_fusable(name: str, n: int, fft_cfg: FftConfig) -> None:
    """The JAX package's ``presets._fusable_fft`` gate, as errors."""
    if n != fft_cfg.max_size or n not in FUSABLE_SIZES:
        raise ValueError(f"{name} takes frames of max_size in "
                         f"{FUSABLE_SIZES}, got {n} (max_size "
                         f"{fft_cfg.max_size})")
    if fft_cfg.window is not None or not fft_cfg.use_bit_reverse:
        raise ValueError(f"{name} computes no window and emits natural order")
    check_keep_msb(fft_cfg)


def _chain_kernel(name: str, symbol: str, regs, x: CLike, fft_cfg: FftConfig,
                  tw: torch.Tensor, count: bool = False) -> CfarOutput:
    """Launch a whole-chain kernel over the CUDA IQ frames ``x`` with the
    twiddle table ``tw``; with ``count``, an entry that counts the peaks
    (``launch``)."""
    n = x.shape[-1]
    fn = entry(symbol, ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
               type(regs), *([ctypes.c_void_p] if count else []))
    return launch(name, x, fn, tw.data_ptr(), n.bit_length() - 1,
                  fft_scale(n, fft_cfg), regs, count=count)


def chain_ca_reference(x: CLike, rt: RuntimeConfig, fft_cfg: FftConfig,
                       cfar_cfg: CfarConfig) -> CfarOutput:
    """The plain PyTorch version of ``chain_ca`` and ``chain_gos``: the
    full-size ``fft_op`` (``torch.fft``) and then ``mag_cfar_reference``."""
    return mag_cfar_reference(fft_op(as_pair(x), None, fft_cfg), rt, cfar_cfg)


def chain_ca(x: CLike, rt: RuntimeConfig, fft_cfg: FftConfig,
             cfar_cfg: CfarConfig) -> CfarOutput:
    """FFT + magnitude + CA-family CFAR at the full elaborated FFT size over IQ
    frames ``[..., N]``, N = ``fft_cfg.max_size`` in {256, 512, 1024}. Returns
    threshold float32 and peaks bool."""
    xp = as_pair(x)
    n = xp.shape[-1]
    _check_fusable("chain_ca", n, fft_cfg)
    check_window_bounds(cfar_cfg)
    if takes_plain_path(xp, "chain_ca"):
        return chain_ca_reference(xp, rt, fft_cfg, cfar_cfg)
    return _chain_kernel("chain_ca", "rsp_chain_ca",
                         ca_registers(rt, cfar_cfg, n), xp, fft_cfg,
                         _row_twiddles(n, xp.device))


# The plain ops carry every CFAR variant, so Kernel D's plain version is
# Kernel A's.
chain_gos_reference = chain_ca_reference


def chain_gos(x: CLike, rt: RuntimeConfig, fft_cfg: FftConfig,
              cfar_cfg: CfarConfig) -> CfarOutput:
    """FFT + magnitude + GOS / GOSCA / CASH CFAR at the full elaborated FFT
    size over IQ frames ``[..., N]``, N = ``fft_cfg.max_size`` in {256, 512,
    1024}. Returns threshold float32, peaks bool and, from the kernel, the
    number of peaks (``detections``)."""
    xp = as_pair(x)
    n = xp.shape[-1]
    _check_fusable("chain_gos", n, fft_cfg)
    check_window_bounds(cfar_cfg)
    if takes_plain_path(xp, "chain_gos"):
        return chain_gos_reference(xp, rt, fft_cfg, cfar_cfg)
    return _chain_kernel("chain_gos", "rsp_chain_gos",
                         gos_registers(rt, cfar_cfg, n), xp, fft_cfg,
                         _row_twiddles(n, xp.device), count=True)


def _full_size(rt: RuntimeConfig, fft_cfg: FftConfig) -> bool:
    return not fft_cfg.runtime_size or rt.log2_fft_size >= fft_cfg.log2_max


def fused_chain_ca_op(x: CLike, rt: RuntimeConfig, fft_cfg: FftConfig,
                      cfar_cfg: CfarConfig) -> CfarOutput:
    """The CA chain stage: the full-size FFT register (the deployment hot
    path) runs ``chain_ca``; a smaller runtime size runs ``fft_op`` and then
    ``mag_cfar`` on the spectrum. The choice is a host ``if`` on the
    register, which is a host value."""
    xp = as_pair(x)
    if _full_size(rt, fft_cfg):
        return chain_ca(xp, rt, fft_cfg, cfar_cfg)
    return mag_cfar(fft_op(xp, rt.log2_fft_size, fft_cfg), rt, cfar_cfg)


def fused_chain_gos_op(x: CLike, rt: RuntimeConfig, fft_cfg: FftConfig,
                       cfar_cfg: CfarConfig) -> CfarOutput:
    """The GOSCA chain stage. At the full FFT size, CA-like registers
    (``kernels.cfar.ca_like``) run ``chain_ca`` and the rest ``chain_gos``; a
    smaller runtime size runs ``fft_op`` and then ``fused_mag_gos_dispatch``.
    The choices are host ``if``s on registers, which are host values."""
    xp = as_pair(x)
    if _full_size(rt, fft_cfg):
        if ca_like(rt, cfar_cfg):
            return chain_ca(xp, rt, fft_cfg, cfar_cfg)
        return chain_gos(xp, rt, fft_cfg, cfar_cfg)
    return fused_mag_gos_dispatch(fft_op(xp, rt.log2_fft_size, fft_cfg), rt,
                                  cfar_cfg)


def wire_ca_reference(words, rt: RuntimeConfig, fft_cfg: FftConfig,
                      cfar_cfg: CfarConfig) -> torch.Tensor:
    """The plain PyTorch version of ``wire_ca``: ``unpack_iq_pair``, then
    ``chain_ca_reference``, then ``pack_cfar_words``."""
    out = chain_ca_reference(unpack_iq_pair(words), rt, fft_cfg, cfar_cfg)
    return pack_cfar_words(out.threshold, out.peaks, fft_cfg.log2_max)


def wire_ca(words, rt: RuntimeConfig, fft_cfg: FftConfig,
            cfar_cfg: CfarConfig) -> torch.Tensor:
    """FFT + magnitude + CA-family CFAR at the full elaborated FFT size over
    packed IQ beat words ``[..., N]`` (int32 view, or uint32), N =
    ``fft_cfg.max_size`` in {256, 512, 1024}. Returns the packed CFAR words
    as an int32 view."""
    w = as_words(words)
    n = w.shape[-1]
    _check_fusable("wire_ca", n, fft_cfg)
    check_window_bounds(cfar_cfg)
    if takes_plain_path(w, "wire_ca"):
        return wire_ca_reference(w, rt, fft_cfg, cfar_cfg)
    check_cuda_operands(w, dtype=torch.int32)
    out = torch.empty_like(w)
    frames = w.numel() // n
    if frames:
        fn = entry("rsp_wire_ca", ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_float, CaRegs, pointers=2)
        call_entry("wire_ca", w.device, fn,
                   (w.data_ptr(), out.data_ptr(), frames),
                   (_row_twiddles(n, w.device).data_ptr(), n.bit_length() - 1,
                    fft_scale(n, fft_cfg), ca_registers(rt, cfar_cfg, n)))
    return out


def fused_wire_chain_op(words, rt: RuntimeConfig, fft_cfg: FftConfig,
                        cfar_cfg: CfarConfig) -> torch.Tensor:
    """The wire chain stage: the full-size FFT register runs ``wire_ca``; a
    smaller runtime size unpacks, runs ``fft_op`` and ``mag_cfar``, and packs
    with the elaborated bin width. A host ``if`` on the register."""
    w = as_words(words)
    if _full_size(rt, fft_cfg):
        return wire_ca(w, rt, fft_cfg, cfar_cfg)
    out = mag_cfar(fft_op(unpack_iq_pair(w), rt.log2_fft_size, fft_cfg), rt,
                   cfar_cfg)
    return pack_cfar_words(out.threshold, out.peaks, fft_cfg.log2_max)


def pc_ca_reference(x: CLike, rt: RuntimeConfig, fft_cfg: FftConfig,
                    cfar_cfg: CfarConfig, h: torch.Tensor) -> CfarOutput:
    """The plain PyTorch version of ``pc_ca``: the full-size ``fft_op``, the
    product with ``h`` ([2, N] re / im planes), then
    ``mag_cfar_reference``."""
    s = join(fft_op(as_pair(x), None, fft_cfg)) * torch.complex(h[0], h[1])
    return mag_cfar_reference(C(s.real, s.imag), rt, cfar_cfg)


def pc_ca(x: CLike, rt: RuntimeConfig, fft_cfg: FftConfig,
          cfar_cfg: CfarConfig, h: torch.Tensor) -> CfarOutput:
    """FFT, product with the matched filter's reference spectrum ``h``
    ([2, N] float32 re / im planes in natural bin order, ``ops.matched_filter.
    h_planes``), magnitude and CA-family CFAR at the full elaborated FFT size
    over IQ frames ``[..., N]``, N = ``fft_cfg.max_size`` in {256, ...,
    4096}: the collapsed pulse compression. Returns threshold float32 and
    peaks bool. The kernel takes ``h`` in ``row_order``, permuted once per
    ``h`` tensor (``_permuted``): write a new tensor rather than changing
    ``h`` in place."""
    xp = as_pair(x)
    n = xp.shape[-1]
    if n != fft_cfg.max_size or n not in PC_SIZES:
        raise ValueError(f"pc_ca takes frames of max_size in {PC_SIZES}, got "
                         f"{n} (max_size {fft_cfg.max_size})")
    if fft_cfg.window is not None or not fft_cfg.use_bit_reverse:
        raise ValueError("pc_ca computes no window and emits natural order")
    check_keep_msb(fft_cfg)
    check_window_bounds(cfar_cfg)
    if tuple(h.shape) != (2, n):
        raise ValueError(f"h must be [2, {n}], got {tuple(h.shape)}")
    if takes_plain_path(xp, "pc_ca"):
        return pc_ca_reference(xp, rt, fft_cfg, cfar_cfg, h)
    if h.dtype != torch.float32:
        raise ValueError(f"h must be float32, got {h.dtype}")
    if h.device != xp.device:
        raise ValueError("h must lie on the frames' device")
    fn = entry("rsp_pc_ca", ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
               ctypes.c_float, CaRegs)
    return launch("pc_ca", xp, fn, _row_twiddles(n, xp.device).data_ptr(),
                  _permuted(h).data_ptr(), n.bit_length() - 1,
                  fft_scale(n, fft_cfg), ca_registers(rt, cfar_cfg, n))
