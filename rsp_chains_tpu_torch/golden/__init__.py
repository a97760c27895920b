"""Test-vector fixtures shared with the JAX package (numpy only)."""

from .fixtures import (
    BARKER_CODES, DEFAULT_SEED, barker_code, chirp_with_targets, complex_tone,
    frank_code, lfm_chirp, random_signal, real_tone, three_tone_signal,
)

__all__ = ["BARKER_CODES", "DEFAULT_SEED", "barker_code", "chirp_with_targets",
           "complex_tone", "frank_code", "lfm_chirp", "random_signal",
           "real_tone", "three_tone_signal"]
