"""Deterministic synthetic-signal fixtures (numpy only).

The same generators as ``rsp_chains_tpu.golden.fixtures`` (reference
``RspChainTesterUtils.scala:48-91``), copied because importing the JAX
package's golden imports jax. Same seed, same numbers."""

from __future__ import annotations

import numpy as np

DEFAULT_SEED = 11110


def real_tone(num_samples: int, f: float, scale: int = 1,
              amplitude: float = 2**14) -> np.ndarray:
    """Real sinusoid, integer-truncated, amplitude 2^14/scale."""
    i = np.arange(num_samples)
    return np.trunc(np.sin(2 * np.pi * f * i) * amplitude / scale)


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


def lfm_chirp(num_samples: int, f0: float = 0.0, f1: float = 0.25,
              amplitude: float = 1.0) -> np.ndarray:
    """Linear-FM chirp sweeping normalized frequency f0 -> f1 over the
    pulse."""
    t = np.arange(num_samples, dtype=np.float64)
    k = (f1 - f0) / num_samples
    phase = 2 * np.pi * (f0 * t + 0.5 * k * t * t)
    return amplitude * np.exp(1j * phase)


BARKER_CODES = {
    2: [1, -1], 3: [1, 1, -1], 4: [1, 1, -1, 1], 5: [1, 1, 1, -1, 1],
    7: [1, 1, 1, -1, -1, 1, -1], 11: [1, 1, 1, -1, -1, -1, 1, -1, -1, 1, -1],
    13: [1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1],
}


def barker_code(length: int, chip_samples: int = 1) -> np.ndarray:
    """Barker phase code (a binary-phase pulse-compression waveform),
    oversampled by ``chip_samples``."""
    if length not in BARKER_CODES:
        raise ValueError(f"no Barker code of length {length}; "
                         f"choose from {sorted(BARKER_CODES)}")
    code = np.asarray(BARKER_CODES[length], np.complex128)
    return np.repeat(code, chip_samples)


def frank_code(m: int) -> np.ndarray:
    """Frank poly-phase code of length m^2."""
    i, j = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
    return np.exp(2j * np.pi * i * j / m).reshape(-1)


def chirp_with_targets(
    num_pulses: int,
    num_samples: int,
    chirp: np.ndarray,
    targets: list[tuple[int, float, float]],
    noise_db: float = -40.0,
    seed: int = DEFAULT_SEED,
) -> np.ndarray:
    """A CPI of chirp returns, [num_pulses, num_samples] complex: each target
    is (delay_samples, amplitude, normalized_doppler), plus complex Gaussian
    noise at ``noise_db``. The pulse-compression and range-Doppler test
    vector."""
    rng = np.random.RandomState(seed)
    m = len(chirp)
    cpi = np.zeros((num_pulses, num_samples), np.complex128)
    for delay, amp, fd in targets:
        pulse_phase = np.exp(2j * np.pi * fd * np.arange(num_pulses))
        end = min(delay + m, num_samples)
        for p in range(num_pulses):
            cpi[p, delay:end] += amp * pulse_phase[p] * chirp[: end - delay]
    sigma = 10 ** (noise_db / 20.0)
    cpi += sigma * (rng.randn(num_pulses, num_samples) +
                    1j * rng.randn(num_pulses, num_samples)) / np.sqrt(2)
    return cpi
