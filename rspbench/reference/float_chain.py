"""Plain reference of the float chain: FFT (scaled 1/N) -> JPL magnitude ->
CFAR (CA sums or GOS rank statistics, PARTIAL edges, linear threshold).

A frozen copy of the semantics of the port's golden models
(``golden/models.py``: ``fft_golden``, ``jpl_mag``, ``cfar_golden``),
vectorised over frames and computed in blocks of frames so that a CPI of
a hundred million samples fits on the card. It imports torch alone and
takes only the CPI that the benchmark made and the registers of the
configuration.

``dtype`` float64 is the reference. ``dtype`` bfloat16 is the control: the
same chain with the input, the spectrum, the magnitude, the statistics and
the threshold rounded to bfloat16 (the FFT itself runs in float32, as a
bfloat16 datapath would accumulate), which the comparison has to reject.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

SUPPORTED = {"mag_mode": (2,), "cfar_mode": (0, 1, 2),
             "cfar_algorithm": (0, 1), "log_or_linear": (1,),
             "peak_grouping": (0,)}


def check_registers(regs: dict, n: int) -> None:
    """Raise for a register setting this reference does not compute."""
    for key, ok in SUPPORTED.items():
        if int(regs[key]) not in ok:
            raise ValueError(f"the float reference computes {key} in {ok}, "
                             f"not {regs[key]}")
    if int(regs["fft_size"]) != n:
        raise ValueError("the float reference computes the full FFT size only")


def _jpl(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    u = torch.maximum(re.abs(), im.abs())
    v = torch.minimum(re.abs(), im.abs())
    return torch.maximum(u + v / 8.0, 7.0 * u / 8.0 + v / 2.0)


def _windows(mag: torch.Tensor, w: int, g: int, fill: float):
    """Each cell's lag (cells i-g-w .. i-g-1) and lead (i+g+1 .. i+g+w)
    windows as ``[B, N, w]`` views over a row padded with ``fill``."""
    n = mag.shape[-1]
    pad = g + w
    row = F.pad(mag, (pad, pad), value=fill)
    win = row.unfold(-1, w, 1)                       # [B, N + 2g + w + 1, w]
    lag = win[:, 0:n]
    lead = win[:, 2 * g + w + 1: 2 * g + w + 1 + n]
    return lag, lead


def _gos_side(win: torch.Tensor, rank: int) -> torch.Tensor:
    """The min(rank, nv - 1)-th smallest valid (finite) cell of each window;
    0 where the window holds none."""
    valid = torch.isfinite(win)
    nv = valid.sum(-1)
    s = torch.sort(win, dim=-1).values
    idx = torch.clamp(torch.minimum(torch.full_like(nv, int(rank)), nv - 1), 0)
    got = s.gather(-1, idx[..., None])[..., 0]
    return torch.where(nv > 0, got, torch.zeros_like(got))


def _combine(mode: int, lag: torch.Tensor, lead: torch.Tensor) -> torch.Tensor:
    if mode == 1:
        return torch.maximum(lag, lead)
    if mode == 2:
        return torch.minimum(lag, lead)
    return (lag + lead) / 2.0


def _block(re: torch.Tensor, im: torch.Tensor, regs: dict,
           dtype: torch.dtype):
    n = re.shape[-1]
    fft_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    q = (lambda t: t.to(dtype))
    x = torch.complex(q(re).to(fft_dtype), q(im).to(fft_dtype))
    spec = torch.fft.fft(x, dim=-1) / n
    mag = _jpl(q(spec.real), q(spec.imag))
    w = int(regs["ref_window_size"])
    g = int(regs["guard_window_size"])
    mode = int(regs["cfar_mode"])
    if int(regs["cfar_algorithm"]) == 1:
        lag, lead = _windows(mag, w, g, math.inf)
        noise = _combine(mode, _gos_side(lag, regs["index_lagg"]),
                         _gos_side(lead, regs["index_lead"]))
    else:
        lag, lead = _windows(mag, w, g, 0.0)
        div = 2.0 ** int(regs["div_sum"])
        noise = _combine(mode, lag.sum(-1) / div, lead.sum(-1) / div)
    thr = noise * float(regs["threshold_scaler"])
    return thr, mag > thr


def chain(re: torch.Tensor, im: torch.Tensor, regs: dict,
          dtype: torch.dtype = torch.float64, block_frames: int = 2048):
    """``(threshold, peaks)`` of the CPI planes ``re``, ``im``
    ``[..., N]``: the threshold in ``dtype`` (float64 for the reference),
    peaks bool, both of the CPI's shape, on its device."""
    shape = re.shape
    n = shape[-1]
    check_registers(regs, n)
    re2, im2 = re.reshape(-1, n), im.reshape(-1, n)
    thr = torch.empty(re2.shape, dtype=dtype, device=re.device)
    peaks = torch.empty(re2.shape, dtype=torch.bool, device=re.device)
    for lo in range(0, re2.shape[0], block_frames):
        hi = lo + block_frames
        t, p = _block(re2[lo:hi], im2[lo:hi], regs, dtype)
        thr[lo:hi], peaks[lo:hi] = t, p
    return thr.reshape(shape), peaks.reshape(shape)
