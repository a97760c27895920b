"""Pulse integration over axis -2 of ``[..., P, N]`` blocks (coherent,
non-coherent, binary m-of-n), the port of ``rsp_chains_tpu.ops.integrate``."""

from __future__ import annotations

import torch


def coherent_integration(iq: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Complex (or per-plane) sum over pulses: +10 log10(P) SNR for
    phase-stable returns."""
    return iq.sum(dim=axis)


def noncoherent_integration(mag: torch.Tensor, axis: int = -2,
                            average: bool = True) -> torch.Tensor:
    """Magnitude sum (or mean) over pulses."""
    s = mag.sum(dim=axis)
    return s / mag.shape[axis] if average else s


def binary_integration(peaks: torch.Tensor, m: int,
                       axis: int = -2) -> torch.Tensor:
    """m-of-n fusion: a cell detects where at least ``m`` of the per-pulse
    CFAR decisions fired."""
    return peaks.to(torch.int32).sum(dim=axis) >= m
