"""Golden models and test-vector fixtures shared with the JAX package (numpy
only): the float reference models (``models``), the bit-true integer ones
(``int_models``) and the fixtures, each the port's own copy."""

from .models import (
    jpl_mag,
    sqr_mag,
    log2_mag,
    abs_mag,
    fft_golden,
    nco_golden,
    cfar_golden,
    cfar_2d_golden,
    matched_filter_golden,
    range_doppler_golden,
)
from .fixtures import (
    BARKER_CODES, DEFAULT_SEED, barker_code, chirp_with_targets, complex_tone,
    frank_code, lfm_chirp, random_signal, real_tone, three_tone_signal,
)
from . import models

__all__ = ["BARKER_CODES", "DEFAULT_SEED", "abs_mag", "barker_code",
           "cfar_2d_golden", "cfar_golden", "chirp_with_targets",
           "complex_tone", "fft_golden", "frank_code", "jpl_mag",
           "lfm_chirp", "log2_mag", "matched_filter_golden", "models",
           "nco_golden", "random_signal", "range_doppler_golden",
           "real_tone", "sqr_mag", "three_tone_signal"]
