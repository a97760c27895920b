"""Beamforming over the channel axis ``-2`` of ``[..., C, T]`` blocks, the port
of ``rsp_chains_tpu.ops.beamform``: conventional (Bartlett) beams as one
complex matrix product, or the DFT beam space. The JAX package computes both
outside any Pallas kernel, so the port uses ``torch.matmul`` and ``torch.fft``
on complex64."""

from __future__ import annotations

import numpy as np
import torch

from ..cplx import C, CLike, as_pair, join, like


def ula_steering(num_channels: int, angles_rad,
                 spacing_wavelengths: float = 0.5) -> np.ndarray:
    """Steering matrix A [beams, channels] of a uniform linear array:
    A[b, c] = exp(-j 2 pi d c sin(theta_b))."""
    angles = np.atleast_1d(np.asarray(angles_rad, np.float64))
    c = np.arange(num_channels)
    phase = -2j * np.pi * spacing_wavelengths * np.outer(np.sin(angles), c)
    return np.exp(phase).astype(np.complex64)


def beamform(x: CLike, weights: np.ndarray) -> CLike:
    """Beams ``conj(weights) @ x``: ``x`` [..., C, T], ``weights`` [B, C]
    host complex. Returns [..., B, T]."""
    xa = join(as_pair(x))
    w = torch.from_numpy(np.conj(np.asarray(weights)).astype(np.complex64))
    y = torch.matmul(w.to(xa.device), xa)
    return like(x, C(y.real.contiguous(), y.imag.contiguous()))


def fft_beamform(x: CLike) -> CLike:
    """The DFT across the channel axis: C beams at spatial frequencies k/C.
    ``x`` [..., C, T] -> [..., C, T]."""
    xa = join(as_pair(x))
    y = torch.fft.fft(xa, dim=-2)
    return like(x, C(y.real.contiguous(), y.imag.contiguous()))
