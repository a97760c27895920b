"""Kernel A, ``chain_ca``: the whole CA chain (FFT, scale, magnitude, CA/GO/SO
CFAR) in one kernel, and ``fused_chain_ca_op``, the stage that honours the
FFT-size register.

Replaces ``rsp_chains_tpu/kernels/chain_pallas.py::fused_chain_ca`` (:841,
``pallas_call`` :1013) and its dispatch ``fused_chain_ca_op`` (:1402). The CUDA
source is ``csrc/chain_ca.cu``; it says what bounds the kernel on the H100 and
how its design answers. The kernel moves 13 bytes per complex sample: 8 in,
4 + 1 out; the spectrum stays in shared memory.

``chain_ca`` launches the kernel for CUDA tensors and uses the plain version,
``chain_ca_reference``, only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..configs import CfarConfig, FftConfig, RuntimeConfig
from ..cplx import CLike, as_pair
from ..ops.cfar import CfarOutput
from ..ops.fft import check_keep_msb, fft_op, fft_scale
from . import _build
from .cfar import (
    CaRegs, ca_registers, check_cuda_operands, check_launch,
    check_window_bounds, launch_stream, mag_cfar, mag_cfar_reference,
)

FUSABLE_SIZES = (256, 512, 1024)

# Launches of the CUDA kernel in this process; the plain path never adds.
LAUNCHES = 0


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, device: torch.device) -> torch.Tensor:
    """[n/2, 2] float32 (cos, sin) of exp(-2 pi i k / n), computed in float64."""
    ang = -2.0 * np.pi * np.arange(n // 2) / n
    tw = np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)
    return torch.from_numpy(tw).to(device)


@functools.lru_cache(maxsize=1)
def _entry():
    fn = _build.library().rsp_chain_ca
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_float, CaRegs,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_fusable(n: int, fft_cfg: FftConfig) -> None:
    """The JAX package's ``presets._fusable_fft`` gate, as errors."""
    if n != fft_cfg.max_size or n not in FUSABLE_SIZES:
        raise ValueError(f"chain_ca takes frames of max_size in "
                         f"{FUSABLE_SIZES}, got {n} (max_size "
                         f"{fft_cfg.max_size})")
    if fft_cfg.window is not None or not fft_cfg.use_bit_reverse:
        raise ValueError("chain_ca computes no window and emits natural order")
    check_keep_msb(fft_cfg)


def chain_ca_reference(x: CLike, rt: RuntimeConfig, fft_cfg: FftConfig,
                       cfar_cfg: CfarConfig) -> CfarOutput:
    """The plain PyTorch version of ``chain_ca``: the full-size ``fft_op``
    (``torch.fft``) and then ``mag_cfar_reference``."""
    return mag_cfar_reference(fft_op(as_pair(x), None, fft_cfg), rt, cfar_cfg)


def chain_ca(x: CLike, rt: RuntimeConfig, fft_cfg: FftConfig,
             cfar_cfg: CfarConfig) -> CfarOutput:
    """FFT + magnitude + CA-family CFAR at the full elaborated FFT size over IQ
    frames ``[..., N]``, N = ``fft_cfg.max_size`` in {256, 512, 1024}. Returns
    threshold float32 and peaks bool."""
    global LAUNCHES
    xp = as_pair(x)
    n = xp.shape[-1]
    _check_fusable(n, fft_cfg)
    check_window_bounds(cfar_cfg)
    if xp.device.type == "cpu":
        return chain_ca_reference(xp, rt, fft_cfg, cfar_cfg)
    if xp.device.type != "cuda":
        raise ValueError(f"chain_ca takes CPU or CUDA tensors, not {xp.device}")
    check_cuda_operands(xp.re, xp.im)
    regs = ca_registers(rt, cfar_cfg, n)
    thr = torch.empty(xp.shape, dtype=torch.float32, device=xp.device)
    pk = torch.empty(xp.shape, dtype=torch.uint8, device=xp.device)
    frames = xp.re.numel() // n
    if frames:
        tw = _twiddles(n, xp.device)
        with torch.cuda.device(xp.device):
            rc = _entry()(xp.re.data_ptr(), xp.im.data_ptr(), tw.data_ptr(),
                          thr.data_ptr(), pk.data_ptr(), frames,
                          n.bit_length() - 1, fft_scale(n, fft_cfg), regs,
                          launch_stream(xp.device))
        check_launch("chain_ca", rc)
        LAUNCHES += 1
    return CfarOutput(threshold=thr, peaks=pk.view(torch.bool))


def fused_chain_ca_op(x: CLike, rt: RuntimeConfig, fft_cfg: FftConfig,
                      cfar_cfg: CfarConfig) -> CfarOutput:
    """The chain stage: the full-size FFT register (the deployment hot path)
    runs ``chain_ca``; a smaller runtime size runs ``fft_op`` and then
    ``mag_cfar`` on the spectrum. The choice is a host ``if`` on the
    register, which is a host value."""
    xp = as_pair(x)
    if not fft_cfg.runtime_size or rt.log2_fft_size >= fft_cfg.log2_max:
        return chain_ca(xp, rt, fft_cfg, cfar_cfg)
    return mag_cfar(fft_op(xp, rt.log2_fft_size, fft_cfg), rt, cfar_cfg)
