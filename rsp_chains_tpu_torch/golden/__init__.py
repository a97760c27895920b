"""Test-vector fixtures shared with the JAX package (numpy only)."""

from .fixtures import DEFAULT_SEED, complex_tone, random_signal, three_tone_signal

__all__ = ["DEFAULT_SEED", "complex_tone", "random_signal", "three_tone_signal"]
