"""rsp_chains_tpu_torch: the PyTorch and CUDA port of ``rsp_chains_tpu``.

This slice carries the main path, ``fft_mag_cfar_chain``, for the CA, GOS,
GOSCA and CASH CFAR (the default ``ChainConfig()`` is GOSCA + CASH) in float
and in the bit-true integer pipeline, and the served wire top
``rx_fft_mag_cfar_tx_chain``, on hand-written CUDA kernels for Hopper
(``csrc/``), each with a plain PyTorch version that CPU tensors take. The
package imports torch and numpy, never jax.
"""

from .configs import (
    CfarAlgorithm,
    CfarConfig,
    CfarMode,
    CfarVariant,
    ChainConfig,
    DopplerConfig,
    EdgePolicy,
    FftConfig,
    FftScaling,
    FixedPointConfig,
    LogMagConfig,
    MagMode,
    MatchedFilterConfig,
    NcoConfig,
    PlfgConfig,
    Rounding,
    RuntimeConfig,
)
from .chain import Chain, Stage
from .cplx import C, as_pair, to_numpy
from .ops.cfar import CfarOutput
from .presets import fft_mag_cfar_chain, rx_fft_mag_cfar_tx_chain
from . import golden, packing
