"""Preset chain topologies, the port of ``rsp_chains_tpu.presets``. This slice
carries ``fft_mag_cfar_chain`` (the reference's ``FftMagCfarChainVanilla``
core) for CA-family elaborations, with the JAX package's routing gates
(``presets.py:223-286``):

* a CA elaboration with a fusable FFT runs one stage, ``fused_chain_ca_op``
  (Kernel A, or the FFT and Kernel B for a shrunken FFT-size register);
* another CA elaboration that the JAX package sends to its fused tail runs the
  FFT stage and Kernel B, ``mag_cfar``;
* the rest run the plain ops ``fft_stage`` + ``mag_stage`` + ``cfar_stage``;
* GOS/GOSCA/CASH, WRAP/REFLECT edges, fixed-point and bit-true elaborations
  raise ``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

from typing import Optional

from .chain import Chain, Stage
from .configs import ChainConfig
from .kernels.cfar import fused_tail_kind, mag_cfar
from .kernels.chain import FUSABLE_SIZES, fused_chain_ca_op
from .ops.cfar import cfar_op, require_ca_family
from .ops.fft import fft_op
from .ops.logmag import logmag


def fft_stage(cfg: ChainConfig) -> Stage:
    return Stage("fft", lambda x, rt: fft_op(x, rt.log2_fft_size, cfg.fft))


def mag_stage(cfg: ChainConfig) -> Stage:
    return Stage("logmag", lambda x, rt: logmag(x, rt.mag_mode, cfg.mag))


def cfar_stage(cfg: ChainConfig) -> Stage:
    return Stage("cfar", lambda x, rt: cfar_op(x, rt, cfg.cfar))


def tail_stages(cfg: ChainConfig) -> list[Stage]:
    """The magnitude + CFAR tail: Kernel B where the JAX package runs its
    fused CA tail, else the plain ops."""
    if fused_tail_kind(cfg) == "ca" and cfg.fft.max_size % 128 == 0:
        return [Stage("mag_cfar_fused",
                      lambda x, rt: mag_cfar(x, rt, cfg.cfar))]
    return [mag_stage(cfg), cfar_stage(cfg)]


def _fusable_fft(cfg: ChainConfig) -> bool:
    """Whether the FFT can run inside Kernel A: a kernel size, no window,
    natural order and no LSB-keep stage. ``use_mxu`` is read because the JAX
    package's gate reads it."""
    return (
        cfg.fft.max_size in FUSABLE_SIZES
        and cfg.fft.window is None
        and cfg.fft.use_mxu
        and cfg.fft.use_bit_reverse
        and (cfg.fft.keep_msb_or_lsb is None or all(cfg.fft.keep_msb_or_lsb))
    )


def fft_mag_cfar_chain(cfg: Optional[ChainConfig] = None) -> Chain:
    """``process(iq, rt) -> CfarOutput`` over complex frames
    ``[..., max_size]`` (a ``C`` pair or a complex tensor)."""
    cfg = cfg or ChainConfig()
    require_ca_family(cfg.cfar)
    if fused_tail_kind(cfg) == "ca" and _fusable_fft(cfg):
        return Chain(cfg, [Stage(
            "fft_mag_cfar_fused",
            lambda x, rt: fused_chain_ca_op(x, rt, cfg.fft, cfg.cfar),
        )])
    return Chain(cfg, [fft_stage(cfg), *tail_stages(cfg)])
