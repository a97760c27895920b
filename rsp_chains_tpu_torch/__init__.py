"""rsp_chains_tpu_torch: the PyTorch and CUDA port of ``rsp_chains_tpu``.

The port carries the main path, ``fft_mag_cfar_chain``, for the CA, GOS,
GOSCA and CASH CFAR (the default ``ChainConfig()`` is GOSCA + CASH) in float
and in the bit-true integer pipeline, the served wire top
``rx_fft_mag_cfar_tx_chain``, the signal sources (the PLFG chirp programs,
``PlfgProgram``, ``Segment``, ``lfm_program``; the NCO with the JAX
package's dither stream; the self-stimulus tops ``rsp_chain_vanilla`` and
``chain_with_mem``, and ``real_rx_chain`` for real ADC frames), and the 2-D
family: pulse compression, the range-Doppler chain and its wire top, the
2-D map detector, beamforming and pulse integration. ``rsp_chains_tpu_torch.parallel`` shards the chains over
a ``(ch, rng)`` mesh of devices, with the range halo exchanged between
neighbouring shards; as in the JAX package, this module does not import it.
The kernels are hand-written CUDA for Hopper (``csrc/``), each with a plain
PyTorch version that CPU tensors take. The package imports torch and numpy,
never jax.
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
from .cplx import C, as_pair, join, to_numpy
from .ops.cfar import CfarOutput
from .ops.cfar_2d import Cfar2dConfig, Cfar2dRuntime, cfar_2d_op, rd_2d_cfar_chain
from .ops.plfg import PlfgProgram, Segment, lfm_program
from .presets import (
    beamformed_rd_chain,
    chain_with_mem,
    fft_mag_cfar_chain,
    integrated_search_chain,
    pulse_compression_chain,
    range_doppler_chain,
    real_rx_chain,
    rsp_chain_vanilla,
    rx_fft_mag_cfar_tx_chain,
    rx_rd_tx_chain,
)
from . import golden, packing
