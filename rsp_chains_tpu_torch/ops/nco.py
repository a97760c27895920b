"""NCO, the numerically controlled oscillator: frequency words -> IQ samples.

The port of ``rsp_chains_tpu.ops.nco`` (``AXI4NCOLazyModuleBlock``). A
``phase_width``-bit phase accumulator, driven by the PLFG's word stream,
indexes a sine/cosine table of ``4 * table_size`` positions; a constant word
``s`` steps the phase by ``s / 2^phase_width`` cycles a sample, so the tone
lands at FFT bin ``s * N / (4 * table_size)`` in the tested configuration
(``phase_width = log2(4 * table_size)``). The output is ``(cos, sin)`` at
amplitude ``2^(table_width - 2)``, the first sample after one accumulation
step. Every option of ``NcoConfig`` is carried in float32, as in JAX:
``phase_acc_enable`` (an inclusive cumulative sum), ``rasterized_mode``
(integer phase modulo 2^phase_width), ``dither_enable``, ``quantized_lut``
with and without ``n_interpolation_terms``, and the float path.

The dither is the JAX package's stream bit for bit:
``jax.random.uniform(jax.random.key(seed), shape, minval=-0.5,
maxval=0.5)``, which with ``jax_threefry_partitionable`` is threefry2x32 of
the key ``(seed >> 32, seed & 0xFFFFFFFF)`` over the flat index split into
high and low 32-bit words, the two outputs xor-ed, the top 23 bits made a
float in [1, 2). ``dither_stream`` computes it in int64 torch ops on the
tensor's own device, so the card builds it with no host round trip;
``dither_stream_np`` is the same function in numpy.

On the card ``torch.cumsum`` over float32 is a parallel scan: for
fractional words (LFM ramps) its rounding differs from the CPU's sequential
sum by a few ulps of the phase. Integer-valued words below 2^24 sum exactly
in any order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..configs import NcoConfig
from ..cplx import C

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _threefry2x32(k0: int, k1: int, x0, x1, rotl, mask):
    """20 rounds of threefry2x32 on the counter words ``x0``, ``x1``
    (unsigned 32-bit values in a wider integer type): ``rotl`` rotates,
    ``mask`` keeps 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = mask(x0 + ks[0]), mask(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = mask(x0 + x1)
            x1 = rotl(x1, r) ^ x0
        x0 = mask(x0 + ks[(i + 1) % 3])
        x1 = mask(x1 + ks[(i + 2) % 3] + i + 1)
    return x0, x1


def dither_stream_np(seed: int, shape: tuple) -> np.ndarray:
    """``jax.random.uniform(jax.random.key(seed), shape, minval=-0.5,
    maxval=0.5)`` in numpy (float32): the bits as a float v in [1, 2), then
    ``(v - 1) - 0.5``. Both steps are exact in float32, so JAX's
    ``max(minval, .)`` and its product by ``maxval - minval = 1`` change
    nothing."""
    m = np.uint64(_M32)
    idx = np.arange(int(np.prod(shape, dtype=np.int64)), dtype=np.uint64)

    def rotl(x, r):
        return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & m

    b0, b1 = _threefry2x32(np.uint64(seed >> 32), np.uint64(seed & _M32),
                           idx >> np.uint64(32), idx & m, rotl,
                           lambda v: v & m)
    bits = ((b0 ^ b1) >> np.uint64(9)) | np.uint64(0x3F800000)
    ones = bits.astype(np.uint32).view(np.float32)
    return ((ones - np.float32(1)) - np.float32(0.5)).reshape(shape)


@functools.lru_cache(maxsize=8)
def dither_stream(seed: int, shape: tuple,
                  device: torch.device) -> torch.Tensor:
    """``dither_stream_np`` as a float32 tensor built on ``device`` in int64
    torch ops (values below 2^32, shifted values below 2^58). It depends
    only on its arguments, so it is built once for each and shared: callers
    must not write into it."""
    idx = torch.arange(int(np.prod(shape, dtype=np.int64)), dtype=torch.int64,
                       device=device)

    def mask(v):
        return v & _M32

    def rotl(x, r):
        return ((x << r) | (x >> (32 - r))) & _M32

    b0, b1 = _threefry2x32(seed >> 32, seed & _M32, idx >> 32, mask(idx),
                           rotl, mask)
    bits = ((b0 ^ b1) >> 9) | 0x3F800000
    ones = bits.to(torch.int32).view(torch.float32)
    return ((ones - 1.0) - 0.5).reshape(shape)


@functools.lru_cache(maxsize=None)
def _lut_np(table_size: int, table_width: int) -> np.ndarray:
    """The full-cycle table of 4 * table_size positions, values truncated to
    integers at amplitude 2^(table_width - 2) like the hardware table."""
    n = 4 * table_size
    amp = 2.0 ** (table_width - 2)
    ph = 2 * np.pi * np.arange(n) / n
    return (np.trunc(amp * np.cos(ph)) + 1j * np.trunc(amp * np.sin(ph))).astype(
        np.complex64
    )


@functools.lru_cache(maxsize=None)
def _lut_planes(table_size: int, table_width: int,
                device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    lut = _lut_np(table_size, table_width)
    return (torch.from_numpy(np.ascontiguousarray(lut.real)).to(device),
            torch.from_numpy(np.ascontiguousarray(lut.imag)).to(device))


def _mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.mod`` of float32 ``x`` by a positive ``m``: the truncated
    remainder, plus ``m`` where it is negative."""
    r = torch.fmod(x, m)
    return torch.where(r < 0, r + m, r)


def nco(
    freq_words,
    cfg: NcoConfig = NcoConfig(),
    phase_offset: float = 0.0,
    dither_seed: int = 0x5EED,
    pair: bool = False,
):
    """Frequency words ``[..., T]`` (a tensor, or numpy on the CPU) -> IQ
    samples ``[..., T]`` at amplitude 2^(table_width - 2) on the words'
    device: a ``C`` when ``pair``, else complex64. ``phase_offset`` is in
    phase-accumulator units (``RuntimeConfig.phase_offset``)."""
    words = torch.as_tensor(freq_words, dtype=torch.float32)
    modulus = float(2 ** cfg.phase_width)
    phase = torch.cumsum(words, dim=-1) if cfg.phase_acc_enable else words
    phase = phase + float(np.float32(phase_offset))

    if cfg.rasterized_mode:
        # integer phase arithmetic, no float modular error
        phase = torch.remainder(torch.round(phase).to(torch.int32),
                                int(modulus)).to(torch.float32)

    if cfg.dither_enable:
        phase = phase + dither_stream(dither_seed, tuple(phase.shape),
                                      phase.device)

    if cfg.quantized_lut:
        lut_re, lut_im = _lut_planes(cfg.table_size, cfg.table_width,
                                     phase.device)
        nlut = 4 * cfg.table_size
        # the top log2(nlut) bits of the accumulator index the table
        lut_per_phase = float(np.float32(nlut / modulus))
        if cfg.n_interpolation_terms > 0:
            pm = _mod(phase, modulus) * lut_per_phase
            base = torch.floor(pm)
            frac = pm - base
            i0 = torch.remainder(base.to(torch.int32), nlut).long()
            i1 = torch.remainder(i0 + 1, nlut)
            out = C(lut_re[i0] + (lut_re[i1] - lut_re[i0]) * frac,
                    lut_im[i0] + (lut_im[i1] - lut_im[i0]) * frac)
        else:
            idx = _mod(torch.round(phase * lut_per_phase), float(nlut)).long()
            out = C(lut_re[idx], lut_im[idx])
    else:
        # the float32 constant times float32 phases, as XLA multiplies
        angle = _mod(phase, modulus) * float(np.float32(2.0 * np.pi / modulus))
        out = C(cfg.amplitude * torch.cos(angle),
                cfg.amplitude * torch.sin(angle))
    return out if pair else torch.complex(out.re, out.im)
