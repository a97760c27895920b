"""Deterministic synthetic-signal fixtures (numpy only).

The same generators as ``rsp_chains_tpu.golden.fixtures`` (reference
``RspChainTesterUtils.scala:48-91``), copied because importing the JAX
package's golden imports jax. Same seed, same numbers."""

from __future__ import annotations

import numpy as np

DEFAULT_SEED = 11110


def complex_tone(num_samples: int, f: float, scale: int = 1,
                 amplitude: float = 2**13) -> np.ndarray:
    """Complex sinusoid, integer-truncated, amplitude 2^13/scale."""
    i = np.arange(num_samples)
    re = np.trunc(np.cos(2 * np.pi * f * i) * amplitude / scale)
    im = np.trunc(np.sin(2 * np.pi * f * i) * amplitude / scale)
    return re + 1j * im


def three_tone_signal(
    num_samples: int,
    f1: float = 0.125,
    f2: float = 0.25,
    f3: float = 0.5,
    shift_range_factor: int = 0,
    scale: int = 1,
    seed: int = DEFAULT_SEED,
) -> np.ndarray:
    """Three complex tones (amplitudes 0.4/0.2/0.1) plus sqrt-uniform noise,
    scaled by 2^shift_range_factor and integer-truncated: the reference's
    canonical chain test vector (``FftMagCfarChainTester.scala:53``)."""
    rng = np.random.RandomState(seed)
    i = np.arange(num_samples)
    shift = int(2**shift_range_factor / scale)
    s = np.sqrt(rng.rand(num_samples) + rng.rand(num_samples)) + 0j
    for amp, f in ((0.4, f1), (0.2, f2), (0.1, f3)):
        s = s + amp * np.exp(2j * np.pi * f * i)
    return np.trunc(s.real * shift) + 1j * np.trunc(s.imag * shift)


def random_signal(num_samples: int, scale: int = 1, bin_point: int = 13,
                  seed: int = DEFAULT_SEED, complex_: bool = True) -> np.ndarray:
    """Seeded random signal."""
    rng = np.random.RandomState(seed)
    amp = 2**bin_point / scale
    if complex_:
        return np.trunc(rng.rand(num_samples) * amp) + 1j * np.trunc(
            rng.rand(num_samples) * amp
        )
    return np.trunc(rng.rand(num_samples) * amp)
