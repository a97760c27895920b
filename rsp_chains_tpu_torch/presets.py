"""Preset chain topologies, the port of ``rsp_chains_tpu.presets``, with the
JAX package's routing gates (``presets.py:44-168``, ``:223-286``,
``:354-379``).

``fft_mag_cfar_chain`` (the reference's ``FftMagCfarChainVanilla`` core):

* a bit-true elaboration that ``int_chain_fusable`` admits runs one stage,
  ``fft_mag_cfar_int_fused``: ``fused_chain_int_op`` (Kernel F or G, or the
  integer ops for the registers outside their datapaths); another bit-true
  elaboration runs the integer ops as three stages;
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
  the LUT log2, fixed-point fidelity) run the plain ops ``fft_stage`` +
  ``mag_stage`` + ``cfar_stage``.

``rx_fft_mag_cfar_tx_chain`` (the served ``RxFftMagCfarTxChain`` top):
packed IQ beat words in, packed CFAR words out. A CA elaboration with a
fusable FFT runs one stage, ``rx_fft_mag_cfar_tx_fused``:
``fused_wire_chain_op`` (Kernel E); any other elaboration runs ``rx_unpack``,
the stages of ``fft_mag_cfar_chain`` and ``tx_pack``.

Every preset takes ``device``: where numpy input goes, CUDA unless the
caller passes ``device="cpu"`` (``chain.Chain``).
"""

from __future__ import annotations

from typing import Optional

from . import packing
from .chain import Chain, Stage
from .configs import ChainConfig
from .kernels.cfar import (
    GOS_TILE, fused_mag_gos_dispatch, fused_tail_kind, mag_cfar,
)
from .kernels.chain import (
    FUSABLE_SIZES, fused_chain_ca_op, fused_chain_gos_op, fused_wire_chain_op,
)
from .kernels.int_chain import fused_chain_int_op, int_chain_fusable
from .ops.bit_true import cfar_int, fft_int_op, mag_int_op
from .ops.cfar import cfar_op
from .ops.fft import fft_op
from .ops.logmag import logmag


def _bit_true(cfg: ChainConfig) -> bool:
    return cfg.fixed_point.enabled and cfg.fixed_point.bit_true


def fft_stage(cfg: ChainConfig) -> Stage:
    if _bit_true(cfg):
        return Stage("fft_int",
                     lambda x, rt: fft_int_op(x, rt.log2_fft_size, cfg.fft))
    return Stage("fft", lambda x, rt: fft_op(x, rt.log2_fft_size, cfg.fft))


def mag_stage(cfg: ChainConfig) -> Stage:
    if _bit_true(cfg):
        return Stage("logmag_int",
                     lambda x, rt: mag_int_op(x, rt.mag_mode, cfg.mag))
    return Stage("logmag", lambda x, rt: logmag(x, rt.mag_mode, cfg.mag))


def cfar_stage(cfg: ChainConfig) -> Stage:
    if _bit_true(cfg):
        return Stage("cfar_int", lambda x, rt: cfar_int(x, rt, cfg.cfar),
                     terminal=True)
    return Stage("cfar", lambda x, rt: cfar_op(x, rt, cfg.cfar), terminal=True)


def _int_fused_stage(cfg: ChainConfig) -> Optional[Stage]:
    """The one-stage bit-true FFT + magnitude + CFAR where the elaboration
    fits the integer kernels, else None; shared by every preset whose core is
    the FFT -> MAG -> CFAR subchain."""
    if not _bit_true(cfg) or not int_chain_fusable(cfg):
        return None
    return Stage("fft_mag_cfar_int_fused",
                 lambda x, rt: fused_chain_int_op(x, rt, cfg), terminal=True)


def tail_stages(cfg: ChainConfig) -> list[Stage]:
    """The magnitude + CFAR tail: the kernels where the JAX package runs its
    fused tails (Kernel B for CA; Kernel B or C for GOS/GOSCA), else the plain
    ops."""
    kind = fused_tail_kind(cfg)
    if kind == "ca" and cfg.fft.max_size % 128 == 0:
        return [Stage("mag_cfar_fused",
                      lambda x, rt: mag_cfar(x, rt, cfg.cfar), terminal=True)]
    if kind == "gos" and cfg.fft.max_size % GOS_TILE == 0:
        return [Stage("mag_gos_cfar_fused",
                      lambda x, rt: fused_mag_gos_dispatch(x, rt, cfg.cfar),
                      terminal=True)]
    return [mag_stage(cfg), cfar_stage(cfg)]


def core_stages(cfg: ChainConfig) -> list[Stage]:
    """The FFT -> MAG -> CFAR core: the fused integer stage for a fusable
    bit-true elaboration, else the FFT stage and the tail."""
    st = _int_fused_stage(cfg)
    return [st] if st is not None else [fft_stage(cfg), *tail_stages(cfg)]


def _fusable_fft(cfg: ChainConfig) -> bool:
    """Whether the FFT can run inside Kernels A, D and E: a kernel size, no
    window, natural order and no LSB-keep stage. ``use_mxu`` is read because
    the JAX package's gate reads it."""
    return (
        cfg.fft.max_size in FUSABLE_SIZES
        and cfg.fft.window is None
        and cfg.fft.use_mxu
        and cfg.fft.use_bit_reverse
        and (cfg.fft.keep_msb_or_lsb is None or all(cfg.fft.keep_msb_or_lsb))
    )


def fft_mag_cfar_chain(cfg: Optional[ChainConfig] = None,
                       device=None) -> Chain:
    """``process(iq, rt) -> CfarOutput`` over complex frames
    ``[..., max_size]`` (a ``C`` pair or a complex tensor; integer-valued for
    a bit-true elaboration, whose threshold is int32)."""
    cfg = cfg or ChainConfig()
    int_st = _int_fused_stage(cfg)
    if int_st is not None:
        return Chain(cfg, [int_st], device)
    kind = fused_tail_kind(cfg)
    if kind == "ca" and _fusable_fft(cfg):
        return Chain(cfg, [Stage(
            "fft_mag_cfar_fused",
            lambda x, rt: fused_chain_ca_op(x, rt, cfg.fft, cfg.cfar),
            terminal=True)], device)
    if kind == "gos" and _fusable_fft(cfg):
        return Chain(cfg, [Stage(
            "fft_mag_gos_cfar_fused",
            lambda x, rt: fused_chain_gos_op(x, rt, cfg.fft, cfg.cfar),
            terminal=True)], device)
    return Chain(cfg, [fft_stage(cfg), *tail_stages(cfg)], device)


def _wire_rx_stage() -> Stage:
    """Packed beat words -> IQ pair (the serving ingress)."""
    return Stage("rx_unpack", lambda words, rt: packing.unpack_iq_pair(words))


def _wire_tx_stage(cfg: ChainConfig) -> Stage:
    """CfarOutput -> packed ``{threshold | bin | peak}`` words with the
    elaborated bin width, the cell under test in the bin field where
    ``send_cut`` is elaborated (the serving egress)."""
    def tx(out, rt):
        cut = out.cut if cfg.cfar.send_cut else None
        return packing.pack_cfar_words(out.threshold, out.peaks,
                                       cfg.fft.log2_max, cut=cut)

    return Stage("tx_pack", tx, terminal=True)


def rx_fft_mag_cfar_tx_chain(cfg: Optional[ChainConfig] = None,
                             device=None) -> Chain:
    """The served top, ``process(words, rt) -> words``: packed IQ beat words
    ``[..., max_size]`` in (uint32 numpy, or an int32 view) and packed CFAR
    words out as an int32 view (``RspChainTesterUtils.scala:105-109`` in,
    ``RspChainVanillaTester.scala:164-172`` out)."""
    cfg = cfg or ChainConfig()
    if fused_tail_kind(cfg) == "ca" and _fusable_fft(cfg):
        return Chain(cfg, [Stage(
            "rx_fft_mag_cfar_tx_fused",
            lambda words, rt: fused_wire_chain_op(words, rt, cfg.fft,
                                                  cfg.cfar),
            terminal=True)], device)
    core = fft_mag_cfar_chain(cfg)
    return Chain(cfg, [_wire_rx_stage(), *core.stages, _wire_tx_stage(cfg)],
                 device)
