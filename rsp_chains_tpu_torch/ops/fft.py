"""Runtime-sized FFT stage, the port of ``rsp_chains_tpu.ops.fft.fft_op``.

The JAX package leaves this FFT to XLA outside any Pallas kernel, so the port
uses ``torch.fft.fft`` on complex64. The semantics are the register's: the
first n = 2^clip(log2_fft_size, min_log2_size, log2(max_size)) samples of each
frame are transformed, scaled, and bins >= n are zero.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ..configs import FftConfig, FftScaling
from ..cplx import C, CLike, as_pair, like
from .windows import window as make_window


def fft_scale(n: int, cfg: FftConfig) -> float:
    """The output scale of an n-point transform: ``expand_logic`` over the
    first log2(n) stages (each non-expanding stage halves), else the
    ``scaling`` policy."""
    if cfg.expand_logic is not None:
        stages = cfg.expand_logic[: n.bit_length() - 1]
        return float(2.0 ** -sum(1 for e in stages if not e))
    if cfg.scaling is FftScaling.DIV_N:
        return 1.0 / n
    if cfg.scaling is FftScaling.SQRT_N:
        return 1.0 / float(np.sqrt(n))
    return 1.0


def check_keep_msb(cfg: FftConfig) -> None:
    """LSB-keep stages (wraparound overflow) have no float analog; the error
    names the bit-true route that reproduces them, as the JAX package's
    ``ops.fft.fft_op`` does."""
    if cfg.keep_msb_or_lsb is not None and not all(cfg.keep_msb_or_lsb):
        raise ValueError(
            "keepMSBorLSB = LSB stages (wraparound overflow) have no float "
            "analog; elaborate the bit-true integer pipeline instead "
            "(FixedPointConfig(enabled=True, bit_true=True) routes the chain "
            "through ops.bit_true.fft_int_op, which reproduces them exactly)")


def transform_size(log2_fft_size: Optional[int], cfg: FftConfig) -> int:
    """The transform size the FFT-size register selects:
    2^clip(log2_fft_size, min_log2_size, log2(max_size)), or max_size for a
    static-size elaboration or no register."""
    if not cfg.runtime_size or log2_fft_size is None:
        return cfg.max_size
    return 1 << min(max(int(log2_fft_size), cfg.min_log2_size), cfg.log2_max)


@functools.lru_cache(maxsize=None)
def _bitrev_idx(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    k = np.arange(n)
    r = np.zeros(n, np.int64)
    for b in range(bits):
        r |= ((k >> b) & 1) << (bits - 1 - b)
    return r


def fft_op(x: CLike, log2_fft_size: Optional[int] = None,
           cfg: FftConfig = FftConfig()) -> CLike:
    """The FFT stage over frames ``[..., max_size]``. A ``C`` in gives a ``C``
    out; a complex tensor or array gives a complex tensor."""
    xp = as_pair(x)
    if xp.shape[-1] != cfg.max_size:
        raise ValueError(f"frame length {xp.shape[-1]} != elaborated "
                         f"max_size {cfg.max_size}")
    check_keep_msb(cfg)
    n = transform_size(log2_fft_size, cfg)
    xa = torch.complex(xp.re[..., :n].float(), xp.im[..., :n].float())
    if cfg.window is not None:
        xa = xa * torch.from_numpy(make_window(cfg.window, n)).to(xa.device)
    y = torch.fft.fft(xa, dim=-1) * fft_scale(n, cfg)
    if not cfg.use_bit_reverse:
        # the raw SDF datapath's order: bin k emerges at slot bitrev(k)
        y = y[..., torch.from_numpy(_bitrev_idx(n)).to(y.device)]
    pad = cfg.max_size - n
    if pad:
        y = torch.nn.functional.pad(y, (0, pad))
    return like(x, C(y.real.contiguous(), y.imag.contiguous()))


def ifft_op(x: CLike, n: Optional[int] = None) -> CLike:
    """Inverse FFT of the last axis, scaled by 1/n: a ``C`` in gives a ``C``
    out, a complex tensor or array a complex tensor; ``n`` is the axis
    length by default. The JAX package computes it with its XLA four-step
    matmuls, outside any Pallas kernel, so ``torch.fft.ifft`` is its
    port."""
    xp = as_pair(x)
    y = torch.fft.ifft(torch.complex(xp.re.float(), xp.im.float()), n=n,
                       dim=-1)
    return like(x, C(y.real.contiguous(), y.imag.contiguous()))


def rfft_op(x, pair: bool = False):
    """Real frames ``[..., n]`` (n a power of two; a tensor, or numpy on the
    CPU) -> the n // 2 + 1 bins of their FFT, unscaled, as a ``C`` when
    ``pair``, else complex64. The JAX package computes it with XLA ops (the
    pack trick over an n/2-point transform), so ``torch.fft.rfft`` is its
    port."""
    x = torch.as_tensor(x, dtype=torch.float32)
    n = x.shape[-1]
    if n <= 0 or n & (n - 1):
        raise ValueError(f"rfft length {n} is not a power of two")
    y = torch.fft.rfft(x, dim=-1)
    return C(y.real.contiguous(), y.imag.contiguous()) if pair else y
