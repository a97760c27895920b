"""Preset chain topologies, the port of ``rsp_chains_tpu.presets``. This slice
carries ``fft_mag_cfar_chain`` (the reference's ``FftMagCfarChainVanilla``
core), with the JAX package's routing gates (``presets.py:141-147``,
``:223-286``):

* a CA elaboration with a fusable FFT runs one stage, ``fft_mag_cfar_fused``:
  ``fused_chain_ca_op`` (Kernel A, or the FFT and Kernel B for a shrunken
  FFT-size register);
* a GOS or GOSCA elaboration (the default ``ChainConfig()``: GOSCA + CASH)
  with a fusable FFT runs one stage, ``fft_mag_gos_cfar_fused``:
  ``fused_chain_gos_op`` (Kernel A or D by the algorithm and mode registers,
  or the FFT and Kernel B or C for a shrunken FFT-size register);
* another elaboration that the JAX package sends to its fused tail runs the
  FFT stage and ``mag_cfar_fused`` (Kernel B) or ``mag_gos_cfar_fused``
  (Kernel B or C, ``fused_mag_gos_dispatch``);
* the rest (CA + CASH, WRAP/REFLECT edges, emitted noise or cell under test,
  the LUT log2) run the plain ops ``fft_stage`` + ``mag_stage`` +
  ``cfar_stage``;
* fixed-point and bit-true elaborations raise ``NotImplementedError`` naming
  their ROADMAP item (``chain.Chain``).
"""

from __future__ import annotations

from typing import Optional

from .chain import Chain, Stage
from .configs import ChainConfig
from .kernels.cfar import (
    GOS_TILE, fused_mag_gos_dispatch, fused_tail_kind, mag_cfar,
)
from .kernels.chain import FUSABLE_SIZES, fused_chain_ca_op, fused_chain_gos_op
from .ops.cfar import cfar_op
from .ops.fft import fft_op
from .ops.logmag import logmag


def fft_stage(cfg: ChainConfig) -> Stage:
    return Stage("fft", lambda x, rt: fft_op(x, rt.log2_fft_size, cfg.fft))


def mag_stage(cfg: ChainConfig) -> Stage:
    return Stage("logmag", lambda x, rt: logmag(x, rt.mag_mode, cfg.mag))


def cfar_stage(cfg: ChainConfig) -> Stage:
    return Stage("cfar", lambda x, rt: cfar_op(x, rt, cfg.cfar))


def tail_stages(cfg: ChainConfig) -> list[Stage]:
    """The magnitude + CFAR tail: the kernels where the JAX package runs its
    fused tails (Kernel B for CA; Kernel B or C for GOS/GOSCA), else the plain
    ops."""
    kind = fused_tail_kind(cfg)
    if kind == "ca" and cfg.fft.max_size % 128 == 0:
        return [Stage("mag_cfar_fused",
                      lambda x, rt: mag_cfar(x, rt, cfg.cfar))]
    if kind == "gos" and cfg.fft.max_size % GOS_TILE == 0:
        return [Stage("mag_gos_cfar_fused",
                      lambda x, rt: fused_mag_gos_dispatch(x, rt, cfg.cfar))]
    return [mag_stage(cfg), cfar_stage(cfg)]


def _fusable_fft(cfg: ChainConfig) -> bool:
    """Whether the FFT can run inside Kernels A and D: a kernel size, no window,
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
    kind = fused_tail_kind(cfg)
    if kind == "ca" and _fusable_fft(cfg):
        return Chain(cfg, [Stage(
            "fft_mag_cfar_fused",
            lambda x, rt: fused_chain_ca_op(x, rt, cfg.fft, cfg.cfar),
        )])
    if kind == "gos" and _fusable_fft(cfg):
        return Chain(cfg, [Stage(
            "fft_mag_gos_cfar_fused",
            lambda x, rt: fused_chain_gos_op(x, rt, cfg.fft, cfg.cfar),
        )])
    return Chain(cfg, [fft_stage(cfg), *tail_stages(cfg)])
