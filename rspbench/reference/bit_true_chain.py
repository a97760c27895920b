"""Plain reference of the bit-true integer chain: the 16-bit fixed-point
radix-2 DIF FFT (keepMSB halving on every stage, 1.15 twiddles, products
rounded half up), the integer JPL magnitude, and the integer CFAR (CA sums
``>> divSum`` or GOS rank statistics, PARTIAL edges, the noise
``(lag + lead) >> 1`` or max or min, the threshold
``(noise * round(scaler * 64) + 32) >> 6``), exact.

A frozen copy of the semantics of the port's golden models
(``golden/int_models.py``: ``int_fft_golden``, ``int_jpl_golden``,
``int_gosca_cfar_golden``), each stage vectorised over frames and computed in
int64 in blocks of frames. At 16-bit inputs, w <= 64 and the configuration's
scaler no int32 sum or product of the contract wraps, so int64 gives the same
integers. It imports torch and numpy alone and takes only the CPI that the
benchmark made and the registers of the configuration.

``fft="float_rounded"`` is the control: the spectrum from a float64 FFT
scaled 1/N and rounded to the integer grid, in place of the bit-true
butterflies, which the exact comparison has to reject.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

SUPPORTED = {"mag_mode": (2,), "cfar_mode": (0, 1, 2),
             "cfar_algorithm": (0, 1), "log_or_linear": (1,),
             "peak_grouping": (0,)}
INVALID = 1 << 62


def check_registers(regs: dict, n: int) -> None:
    """Raise for a register setting this reference does not compute."""
    for key, ok in SUPPORTED.items():
        if int(regs[key]) not in ok:
            raise ValueError(f"the bit-true reference computes {key} in {ok}, "
                             f"not {regs[key]}")
    if int(regs["fft_size"]) != n:
        raise ValueError("the bit-true reference computes the full FFT size "
                         "only")


def _rhu(v: torch.Tensor, k: int) -> torch.Tensor:
    return (v + (1 << (k - 1))) >> k


@functools.lru_cache(maxsize=None)
def _twiddles(m: int) -> tuple:
    """1.15 twiddles W_m^j, j < m / 2, as in ``int_fft_golden``."""
    j = np.arange(m // 2)
    w = np.exp(-2j * np.pi * j / m)
    return (np.round(w.real * 32768.0).astype(np.int64),
            np.round(w.imag * 32768.0).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _bitrev(n: int) -> np.ndarray:
    p = n.bit_length() - 1
    return np.array([int(format(k, f"0{p}b")[::-1], 2) for k in range(n)])


def bit_true_fft(xr: torch.Tensor, xi: torch.Tensor):
    """The integer FFT of int64 frames ``[B, N]``, natural order out."""
    b, n = xr.shape
    m = n
    while m > 1:
        half = m // 2
        vr = xr.reshape(b, n // m, 2, half)
        vi = xi.reshape(b, n // m, 2, half)
        sr = _rhu(vr[:, :, 0] + vr[:, :, 1], 1)
        si = _rhu(vi[:, :, 0] + vi[:, :, 1], 1)
        dr = _rhu(vr[:, :, 0] - vr[:, :, 1], 1)
        di = _rhu(vi[:, :, 0] - vi[:, :, 1], 1)
        wr, wi = (torch.from_numpy(t).to(xr.device) for t in _twiddles(m))
        yr = _rhu(dr * wr - di * wi, 15)
        yi = _rhu(dr * wi + di * wr, 15)
        xr = torch.stack([sr, yr], dim=2).reshape(b, n)
        xi = torch.stack([si, yi], dim=2).reshape(b, n)
        m = half
    rev = torch.from_numpy(_bitrev(n)).to(xr.device)
    return xr[:, rev], xi[:, rev]


def float_rounded_fft(xr: torch.Tensor, xi: torch.Tensor):
    """The control's spectrum: float64 FFT / N rounded to integers."""
    n = xr.shape[-1]
    y = torch.fft.fft(torch.complex(xr.double(), xi.double()), dim=-1) / n
    return torch.round(y.real).long(), torch.round(y.imag).long()


def _jpl(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    u = torch.maximum(re.abs(), im.abs())
    v = torch.minimum(re.abs(), im.abs())
    return torch.maximum(u + (v >> 3), u - (u >> 3) + (v >> 1))


def _windows(mag: torch.Tensor, w: int, g: int, fill: int):
    """Each cell's lag and lead windows as ``[B, N, w]`` views over a row
    padded with ``fill``."""
    n = mag.shape[-1]
    pad = g + w
    row = F.pad(mag, (pad, pad), value=fill)
    win = row.unfold(-1, w, 1)
    return win[:, 0:n], win[:, 2 * g + w + 1: 2 * g + w + 1 + n]


def _gos_side(win: torch.Tensor, rank: int) -> torch.Tensor:
    valid = win != INVALID
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
    return (lag + lead) >> 1


def _block(re: torch.Tensor, im: torch.Tensor, regs: dict, fft: str):
    xr, xi = re.long(), im.long()
    if fft == "bit_true":
        sr, si = bit_true_fft(xr, xi)
    elif fft == "float_rounded":
        sr, si = float_rounded_fft(xr, xi)
    else:
        raise ValueError(f"unknown fft {fft!r}")
    mag = _jpl(sr, si)
    w = int(regs["ref_window_size"])
    g = int(regs["guard_window_size"])
    mode = int(regs["cfar_mode"])
    if int(regs["cfar_algorithm"]) == 1:
        lag, lead = _windows(mag, w, g, INVALID)
        noise = _combine(mode, _gos_side(lag, regs["index_lagg"]),
                         _gos_side(lead, regs["index_lead"]))
    else:
        lag, lead = _windows(mag, w, g, 0)
        d = int(regs["div_sum"])
        noise = _combine(mode, lag.sum(-1) >> d, lead.sum(-1) >> d)
    # np.round rounds half to even, as the golden rounds the scaler
    q = int(np.round(np.float32(regs["threshold_scaler"]) * 64.0))
    thr = _rhu(noise * q, 6)
    return thr, mag > thr


def chain(re: torch.Tensor, im: torch.Tensor, regs: dict,
          fft: str = "bit_true", block_frames: int = 2048):
    """``(threshold, peaks)`` of the integer CPI planes ``re``, ``im``
    ``[..., N]``: int64 threshold and bool peaks of the CPI's shape, on its
    device."""
    shape = re.shape
    n = shape[-1]
    check_registers(regs, n)
    re2, im2 = re.reshape(-1, n), im.reshape(-1, n)
    thr = torch.empty(re2.shape, dtype=torch.int64, device=re.device)
    peaks = torch.empty(re2.shape, dtype=torch.bool, device=re.device)
    for lo in range(0, re2.shape[0], block_frames):
        hi = lo + block_frames
        t, p = _block(re2[lo:hi], im2[lo:hi], regs, fft)
        thr[lo:hi], peaks[lo:hi] = t, p
    return thr.reshape(shape), peaks.reshape(shape)
