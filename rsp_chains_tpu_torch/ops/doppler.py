"""Doppler (slow-time) FFT over the pulse axis of a CPI, the port of
``rsp_chains_tpu.ops.doppler``. The JAX package computes it outside any Pallas
kernel, so the port uses ``torch.fft`` on complex64 over axis -2 of a
``[..., P, N]`` block."""

from __future__ import annotations

import numpy as np
import torch

from ..configs import DopplerConfig, FftScaling
from ..cplx import C, CLike, as_pair, join, like
from .windows import window as make_window


def doppler_scale(p: int, scaling: FftScaling) -> float:
    if scaling is FftScaling.DIV_N:
        return 1.0 / p
    if scaling is FftScaling.SQRT_N:
        return float(1.0 / np.sqrt(p))
    return 1.0


def doppler_fft(cpi: CLike, cfg: DopplerConfig = DopplerConfig()) -> CLike:
    """The Doppler transform of ``cpi`` [..., P, N] over axis -2 (P pulses, a
    power of two): the window multiplies the pulses, then the transform, the
    scaling, and with ``fft_shift`` zero Doppler centred at row P/2."""
    xp = as_pair(cpi)
    p = xp.shape[-2]
    if p & (p - 1):
        raise ValueError(f"num_pulses {p} is not a power of two")
    xa = join(xp)
    if cfg.window is not None:
        w = torch.from_numpy(make_window(cfg.window, p)).to(xa.device)
        xa = xa * w[:, None]
    y = torch.fft.fft(xa, dim=-2) * doppler_scale(p, cfg.scaling)
    if cfg.fft_shift:
        y = torch.roll(y, p // 2, dims=-2)
    return like(cpi, C(y.real.contiguous(), y.imag.contiguous()))
