"""Fixed-point fidelity, the port of ``rsp_chains_tpu.numerics``: rounding
modes, quantization onto the ``FixedPoint(width, bin_point)`` grid with
saturation, and the SNR of a fixed-point stream against a float one."""

from __future__ import annotations

import numpy as np
import torch

from .configs import FixedPointConfig, Rounding
from .cplx import C


def round_to_int(x: torch.Tensor, mode: Rounding) -> torch.Tensor:
    """Round float values to integers under the fixed-point rounding mode:
    HALF_UP is floor(x + 0.5) (dsptools RoundHalfUp), HALF_EVEN rounds ties to
    even, TRUNCATE rounds toward zero."""
    if mode is Rounding.HALF_UP:
        return torch.floor(x + 0.5)
    if mode is Rounding.HALF_EVEN:
        return torch.round(x)
    if mode is Rounding.TRUNCATE:
        return torch.trunc(x)
    raise ValueError(f"unknown rounding mode {mode}")


def quantize(x, cfg: FixedPointConfig):
    """Snap a real or complex float tensor (or a ``C`` pair) onto the grid
    2^-bin_point, saturating at the two's-complement ``width`` range. Values
    stay floats; the identity when ``cfg.enabled`` is False."""
    if not cfg.enabled:
        return x
    if isinstance(x, C):
        return C(quantize(x.re, cfg), quantize(x.im, cfg))
    if x.is_complex():
        return torch.complex(quantize(x.real, cfg), quantize(x.imag, cfg))
    q = round_to_int(x * cfg.scale, cfg.rounding)
    return torch.clamp(q, cfg.min_int, cfg.max_int) / cfg.scale


def saturate_int(x: torch.Tensor, width: int) -> torch.Tensor:
    """Saturate integer values to the signed ``width``-bit range."""
    return torch.clamp(x, -(2 ** (width - 1)), 2 ** (width - 1) - 1)


def snr_db(reference, test) -> float:
    """Signal-to-noise ratio of ``test`` against ``reference`` in dB (host
    arrays or tensors)."""
    def host(v):
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, dtype=np.complex128)

    reference, test = host(reference), host(test)
    p_sig = float(np.sum(np.abs(reference) ** 2))
    p_err = float(np.sum(np.abs(reference - test) ** 2))
    if p_err == 0.0:
        return float("inf")
    return 10.0 * float(np.log10(p_sig / p_err))
