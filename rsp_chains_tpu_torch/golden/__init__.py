"""Test-vector fixtures shared with the JAX package (numpy only)."""

from .fixtures import (
    DEFAULT_SEED, chirp_with_targets, complex_tone, lfm_chirp, random_signal,
    three_tone_signal,
)

__all__ = ["DEFAULT_SEED", "chirp_with_targets", "complex_tone", "lfm_chirp",
           "random_signal", "three_tone_signal"]
