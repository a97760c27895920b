"""Matched filter (pulse compression), the port of
``rsp_chains_tpu.ops.matched_filter``.

The JAX package computes these outside any Pallas kernel, so the port uses
``torch.fft`` on complex64:

* ``matched_filter``: circular correlation with the transmit replica along the
  last axis, ``ifft(fft(x) * H)``, H = ``h_natural(taps)``;
* ``overlap_save_fir``: linear convolution of a long last axis by overlap-save
  blocks (each block reads an (M-1)-sample left history);
* ``matched_filter_os``: linear pulse compression through ``overlap_save_fir``
  (zero-extended edges instead of the frame's wraparound).

``h_natural`` is the host constant the kernels and the collapsed
pulse-compression stage multiply into a spectrum (``rd_pallas.py:112-123``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..configs import MatchedFilterConfig
from ..cplx import C, CLike, as_pair, join, like, to_numpy


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _host_taps(taps) -> np.ndarray:
    """The replica as a host complex array: numpy or a list as given, a pair
    or a tensor copied to the host."""
    if isinstance(taps, C):
        return to_numpy(taps)
    if isinstance(taps, torch.Tensor):
        return to_numpy(as_pair(taps))
    return np.asarray(taps)


def h_natural(taps, n: int, normalize: bool) -> np.ndarray:
    """The matched-filter reference spectrum H = conj(FFT_n(pad(taps))),
    divided by ||taps|| when ``normalize``, in natural bin order (complex128,
    computed in float64)."""
    t = np.asarray(taps).astype(np.complex128)
    if t.ndim != 1 or t.shape[0] > n:
        raise ValueError(f"matched-filter replica of shape {t.shape} does not "
                         f"fit a frame of {n}")
    h = np.conj(np.fft.fft(t, n))
    if normalize:
        h = h / max(np.sqrt(np.sum(np.abs(t) ** 2)), 1e-30)
    return h


@functools.lru_cache(maxsize=64)
def _h_cached(key: bytes, dtype: str, count: int, n: int, normalize: bool,
              device: str) -> torch.Tensor:
    taps = np.frombuffer(key, dtype=np.dtype(dtype))[:count]
    h = h_natural(taps, n, normalize)
    return torch.from_numpy(np.stack([h.real, h.imag]).astype(np.float32)).to(
        device)


def h_planes(taps, n: int, normalize: bool,
             device: torch.device) -> torch.Tensor:
    """``h_natural`` as a [2, n] float32 tensor (re, im) on ``device``,
    computed once per replica, size and device."""
    t = np.ascontiguousarray(_host_taps(taps))
    return _h_cached(t.tobytes(), t.dtype.str, t.size, n, bool(normalize),
                     str(device))


def matched_filter(x: CLike, taps,
                   cfg: MatchedFilterConfig = MatchedFilterConfig()) -> CLike:
    """Circular pulse compression along the last axis: ``x`` [..., N] frames
    (N a power of two), ``taps`` [M] the transmit replica, M <= N. The output
    peaks at the target delay (``golden.matched_filter_golden(mode=
    'circular')``)."""
    xp = as_pair(x)
    n = xp.shape[-1]
    if n & (n - 1):
        raise ValueError(f"frame length {n} is not a power of two")
    h = h_planes(taps, n, cfg.normalize, xp.device)
    y = torch.fft.ifft(torch.fft.fft(join(xp), dim=-1)
                       * torch.complex(h[0], h[1]), dim=-1)
    return like(x, C(y.real.contiguous(), y.imag.contiguous()))


def overlap_save_fir(x: CLike, taps, block_size: int | None = None) -> CLike:
    """Linear convolution of the last axis of ``x`` [..., T] with ``taps``
    [M] by overlap-save blocks: y[t] = sum_m taps[m] x[t - m], zero history.
    Block i covers the padded samples [i*b, i*b + b + M - 1): its (M-1)-sample
    left history, then b new samples."""
    xp = as_pair(x)
    tp = torch.from_numpy(np.asarray(_host_taps(taps), np.complex64)).to(
        xp.device)
    m = tp.shape[-1]
    t = xp.shape[-1]
    b = block_size or max(_next_pow2(4 * m), 256)
    b = max(b, _next_pow2(m - 1) if m > 1 else 1)
    nfft = _next_pow2(b + m - 1)
    nblk = -(-t // b)
    xpad = torch.nn.functional.pad(join(xp), (m - 1, nblk * b - t))
    blocks = xpad.unfold(-1, b + m - 1, b)            # [..., nblk, b + m - 1]
    yf = torch.fft.fft(blocks, n=nfft, dim=-1) * torch.fft.fft(tp, n=nfft)
    y = torch.fft.ifft(yf, dim=-1)[..., m - 1: m - 1 + b]
    y = y.reshape(xp.shape[:-1] + (nblk * b,))[..., :t]
    return like(x, C(y.real.contiguous(), y.imag.contiguous()))


def mf_reference_taps(chirp: np.ndarray) -> np.ndarray:
    """Matched-filter taps for a transmit replica: the time-reversed
    conjugate."""
    return np.conj(chirp[::-1]).astype(np.complex64)


def matched_filter_os(x: CLike, taps,
                      cfg: MatchedFilterConfig = MatchedFilterConfig()) -> CLike:
    """Linear pulse compression by overlap-save blocks of ``cfg.fft_size``
    points (``MatchedFilterConfig.method = 'overlap_save'``): the circular
    form's interior alignment, corr[tau] = sum_j conj(taps[j]) x[tau + j],
    with zero-extended edges (``golden.matched_filter_golden(mode='full')
    [..., M-1 : M-1+T]``)."""
    xp = as_pair(x)
    t = xp.shape[-1]
    h = mf_reference_taps(_host_taps(taps))
    m = h.shape[-1]
    if cfg.normalize:
        h = h / max(float(np.sqrt(np.sum(np.abs(h) ** 2))), 1e-30)
    block = max(cfg.fft_size - (m - 1), 1) if cfg.fft_size else None
    xe = C(torch.nn.functional.pad(xp.re, (0, m - 1)),
           torch.nn.functional.pad(xp.im, (0, m - 1)))
    y = overlap_save_fir(xe, h, block)
    return like(x, C(y.re[..., m - 1: m - 1 + t].contiguous(),
                     y.im[..., m - 1: m - 1 + t].contiguous()))
