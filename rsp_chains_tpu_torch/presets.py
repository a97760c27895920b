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

``pulse_compression_chain`` (BASELINE config 2: matched filter -> range FFT
-> magnitude -> CFAR per pulse): the circular matched filter and the FFT
collapse to FFT(x) * H at the full FFT size. A CA elaboration of a kernel
size runs one stage, ``pc_fused`` (Kernel I, or the matched filter, the FFT
and Kernel B for a shrunken FFT-size register); another collapsible
elaboration runs ``spectral_mf`` and the tail; the rest the four stages.

``range_doppler_chain`` (BASELINE config 3: matched filter -> Doppler FFT ->
magnitude -> CFAR along range per Doppler bin), over CPI blocks
``[..., P, N]``: a CA elaboration that ``rd_fusable`` admits runs one stage,
``rd_fused`` (Kernel H); a GOS / GOSCA one ``rd_map_fused`` (Kernel H's map)
and ``mag_gos_cfar_fused`` (Kernel B or C); the rest the matched-filter and
Doppler stages and the tail. ``rx_rd_tx_chain`` wraps it in the wire format;
``beamformed_rd_chain`` puts beams in front of it; ``integrated_search_chain``
integrates pulses instead of a Doppler filter bank.

The self-stimulus tops make their own input (call them with ``x = None``)
and, as in JAX, run ``core_stages``, never Kernels A or D:
``rsp_chain_vanilla`` (``RspChainVanilla``: PLFG -> NCO -> FFT -> magnitude
-> CFAR; its default fixed-point elaboration takes the plain ops, a float
CA one Kernel B, a GOSCA one Kernel B or C, a bit-true one
``fft_mag_cfar_int_fused``) and ``chain_with_mem`` (a stored ROM frame,
gated by ``mem_start_reading``). ``real_rx_chain`` takes real ADC frames
through ``rfft_op`` and runs the tail (Kernel B or C) at N / 2.

Every preset takes ``device``: where numpy input goes, CUDA unless the
caller passes ``device="cpu"`` (``chain.Chain``). The source tops build their
tensors there when they are built, and so raise without a card unless
``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import packing
from .chain import Chain, Stage, source_chain, source_device
from .configs import (
    ChainConfig, DopplerConfig, FftConfig, FixedPointConfig,
    MatchedFilterConfig, RuntimeConfig,
)
from .cplx import C, as_pair, join
from .golden.fixtures import lfm_chirp, three_tone_signal
from .kernels.cfar import (
    GOS_TILE, fused_mag_gos_dispatch, fused_tail_kind, mag_cfar,
)
from .kernels.chain import (
    FUSABLE_SIZES, PC_SIZES, _full_size, fused_chain_ca_op, fused_chain_gos_op,
    fused_wire_chain_op, pc_ca,
)
from .kernels.int_chain import fused_chain_int_op, int_chain_fusable
from .kernels.rd import fused_rd_chain, rd_fusable
from .ops.beamform import beamform, fft_beamform, ula_steering
from .ops.bit_true import cfar_int, fft_int_op, mag_int_op
from .ops.cfar import CfarOutput, cfar_op
from .ops.doppler import doppler_fft
from .ops.fft import fft_op, fft_scale, rfft_op
from .ops.integrate import (
    binary_integration, coherent_integration, noncoherent_integration,
)
from .ops.logmag import logmag
from .ops.matched_filter import h_planes, matched_filter, matched_filter_os
from .ops.nco import nco
from .ops.plfg import PlfgProgram, Segment, compile_program


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


def matched_filter_stage(cfg: ChainConfig, taps) -> Stage:
    mf_cfg = cfg.matched_filter or MatchedFilterConfig()
    taps_np = np.asarray(taps)
    if mf_cfg.method == "overlap_save":
        return Stage("matched_filter_os",
                     lambda x, rt: matched_filter_os(x, taps_np, mf_cfg))
    return Stage("matched_filter",
                 lambda x, rt: matched_filter(x, taps_np, mf_cfg))


def doppler_stage(cfg: ChainConfig) -> Stage:
    dop_cfg = cfg.doppler or DopplerConfig()
    return Stage("doppler_fft", lambda x, rt: doppler_fft(x, dop_cfg))


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


def plfg_nco_stage(cfg: ChainConfig, program: PlfgProgram,
                   device) -> Stage:
    """The self-stimulus source: the PLFG profile plus the start register
    ``rt.nco_freq_word``, through the NCO (``nco.freq := plfg.streamNode``,
    ``RspChain.scala:57``). The program is compiled once, to one frame on
    ``device``; ``rt.plfg_profile``, where given, replaces it like a
    chirp-RAM write on a running chain. Its last axis is the frame, its
    leading axes the batch, and a tensor there is used where it lies when
    that is ``device``. Returns a ``C`` of ``[..., max_size]``."""
    n = cfg.fft.max_size
    profile = torch.from_numpy(compile_program(program, cfg.plfg, n)).to(device)

    def fn(_, rt: RuntimeConfig):
        prof = profile
        if rt.plfg_profile is not None:
            if rt.plfg_profile.shape[-1] != n:
                raise ValueError(
                    "plfg_profile must be compiled to the elaborated frame "
                    f"length ({n}); use ops.plfg.compile_program")
            prof = torch.as_tensor(rt.plfg_profile, dtype=torch.float32,
                                   device=device)
        return nco(prof + float(rt.nco_freq_word), cfg.nco,
                   phase_offset=rt.phase_offset, pair=True)

    return Stage("plfg_nco", fn)


def rsp_chain_vanilla(cfg: Optional[ChainConfig] = None,
                      program: Optional[PlfgProgram] = None,
                      device=None) -> Chain:
    """The self-stimulus chain PLFG -> NCO -> FFT -> magnitude -> CFAR
    (``RspChainVanilla``, ``RspChain.scala:39-61``), called with ``x = None``.
    The default elaboration is the reference's integer fixed point
    (``FixedPointConfig(enabled=True, width=16, bin_point=0)``), whose
    16-bit grid floors the float noise under a pure tone; the default
    program is one constant segment of 2^max_num_samples_width samples,
    repeated to fill the frame."""
    if cfg is None:
        cfg = ChainConfig(
            fixed_point=FixedPointConfig(enabled=True, width=16, bin_point=0))
    if program is None:
        seg = 1 << cfg.plfg.max_num_samples_width
        program = PlfgProgram(
            chirps=((Segment(num_samples=min(seg, cfg.fft.max_size)),),),
            repeat_counts=(max(1, cfg.fft.max_size // seg),),
            chirp_ordinals=(0,))
    device = source_device(device)
    return source_chain(
        cfg, [plfg_nco_stage(cfg, program, device), *core_stages(cfg)], device)


def chain_with_mem(cfg: Optional[ChainConfig] = None, rom=None,
                   device=None) -> Chain:
    """The ROM-stimulus top (``ChainWithMem`` + ``MemForTestingFFT``): a
    stored frame, by default the three tones at 1/8, 1/4 and 1/2 with noise
    at 2^13, through the core chain; called with ``x = None``. The ROM, of
    any leading shape ``[..., max_size]``, goes to ``device`` once.
    ``rt.mem_start_reading`` gates it: at 0 the stage gives a zero frame,
    so no detections (``MemForTesting.scala:81-85``)."""
    cfg = cfg or ChainConfig()
    if rom is None:
        rom = three_tone_signal(cfg.fft.max_size, shift_range_factor=13)
    device = source_device(device)
    stored = as_pair(rom, device=device)

    def mem_fn(_, rt: RuntimeConfig):
        if rt.mem_start_reading != 0:
            return stored
        return C(torch.zeros_like(stored.re), torch.zeros_like(stored.im))

    return source_chain(cfg, [Stage("mem_rom", mem_fn), *core_stages(cfg)],
                        device)


def real_rx_chain(cfg: Optional[ChainConfig] = None, device=None) -> Chain:
    """Real ADC frames ``[..., N]`` -> ``rfft_op`` -> the tail at N / 2
    cells: the Nyquist bin is dropped so the CFAR frame stays a power of two,
    and the bins are scaled as ``cfg.fft.scaling`` scales an N-point FFT.
    ``RuntimeConfig.make(fft_size=N, cfar_fft_size=N // 2)`` is the matching
    register setting. The transform has a static size; a window, expanding
    stages and LSB-keep stages are refused, as JAX refuses them."""
    cfg = cfg or ChainConfig()
    n = cfg.fft.max_size
    if cfg.fft.window is not None:
        raise ValueError("real_rx_chain does not window the rfft; elaborate "
                         "window=None (or pre-window the ADC frames)")
    if cfg.fft.expand_logic is not None or _lsb_keep(cfg):
        raise ValueError("per-stage expand/LSB-keep scaling has no analog in "
                         "the rfft front end; use FftScaling")
    half_cfg = dataclasses.replace(cfg, fft=dataclasses.replace(
        cfg.fft, max_size=n // 2))
    scale = fft_scale(n, cfg.fft)
    device = source_device(device)

    def rx(x, rt: RuntimeConfig):
        y = rfft_op(x, pair=True)
        re, im = y.re[..., : n // 2], y.im[..., : n // 2]
        if scale != 1.0:
            re, im = re * scale, im * scale
        return C(re.contiguous(), im.contiguous())

    return Chain(cfg, [Stage("rfft", rx), *tail_stages(half_cfg)], device)


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


def _lsb_keep(cfg: ChainConfig) -> bool:
    return (cfg.fft.keep_msb_or_lsb is not None
            and not all(cfg.fft.keep_msb_or_lsb))


def pulse_compression_chain(cfg: Optional[ChainConfig] = None, taps=None,
                            device=None) -> Chain:
    """BASELINE config 2, ``process(iq, rt) -> CfarOutput`` over frames
    ``[..., N]``: matched filter -> range FFT -> magnitude -> CFAR, with the
    JAX package's routing (``presets.py:427-526``). At the full FFT-size
    register the circular matched filter and the FFT collapse to
    FFT(x) * H, exactly; a smaller runtime size changes the matched filter
    itself and keeps the literal composition (a host ``if``)."""
    cfg = cfg or ChainConfig(fft=FftConfig(max_size=4096),
                             matched_filter=MatchedFilterConfig(fft_size=4096))
    if taps is None:
        taps = lfm_chirp(cfg.matched_filter.num_taps if cfg.matched_filter
                         else 128)
    mf_cfg = cfg.matched_filter or MatchedFilterConfig()
    taps_np = np.asarray(taps)
    n = cfg.fft.max_size
    collapsible = (
        mf_cfg.method == "freq"
        and cfg.fft.window is None
        and cfg.fft.use_bit_reverse
        and not _bit_true(cfg)
        and taps_np.shape[-1] <= n
        and not _lsb_keep(cfg))

    def small(xp, rt):
        return fft_op(matched_filter(xp, taps_np, mf_cfg), rt.log2_fft_size,
                      cfg.fft)

    if (collapsible and fused_tail_kind(cfg) == "ca" and n in PC_SIZES
            and cfg.fft.use_mxu):
        def pc_fused(x, rt: RuntimeConfig):
            xp = as_pair(x)
            if _full_size(rt, cfg.fft):
                return pc_ca(xp, rt, cfg.fft, cfg.cfar,
                             h_planes(taps_np, n, mf_cfg.normalize, xp.device))
            return mag_cfar(small(xp, rt), rt, cfg.cfar)

        return Chain(cfg, [Stage("pc_fused", pc_fused, terminal=True)], device)
    if collapsible:
        def spectral_mf(x, rt: RuntimeConfig):
            xp = as_pair(x)
            if not _full_size(rt, cfg.fft):
                return small(xp, rt)
            h = h_planes(taps_np, n, mf_cfg.normalize, xp.device)
            s = join(fft_op(xp, None, cfg.fft)) * torch.complex(h[0], h[1])
            return C(s.real.contiguous(), s.imag.contiguous())

        return Chain(cfg, [Stage("spectral_mf", spectral_mf),
                           *tail_stages(cfg)], device)
    return Chain(cfg, [matched_filter_stage(cfg, taps_np), fft_stage(cfg),
                       mag_stage(cfg), cfar_stage(cfg)], device)


def range_doppler_chain(cfg: Optional[ChainConfig] = None, taps=None,
                        device=None) -> Chain:
    """BASELINE config 3 (the flagship), ``process(cpi, rt) -> CfarOutput``
    over CPI blocks ``[..., P, N]`` (P pulses, N range samples): matched
    filter along range -> Doppler FFT over the pulses -> magnitude -> CFAR
    along range per Doppler bin, with the JAX package's routing
    (``presets.py:529-610``). With no ``MatchedFilterConfig`` elaborated
    there is no filter stage."""
    cfg = cfg or ChainConfig(doppler=DopplerConfig())
    if _lsb_keep(cfg):
        raise ValueError(
            "keepMSBorLSB = LSB has no analog in the range-Doppler chain (its "
            "matched filter is a float frequency-domain correlation, not the "
            "register-mapped FFT stage); elaborate all-MSB")
    if cfg.matched_filter is None:
        if taps is not None:
            raise ValueError(
                "taps given but cfg.matched_filter is None: elaborate a "
                "MatchedFilterConfig for the filter stage to exist")
        return Chain(cfg, [doppler_stage(cfg), *tail_stages(cfg)], device)
    if taps is None:
        taps = lfm_chirp(cfg.matched_filter.num_taps)
    taps_np = np.asarray(taps)
    kind = fused_tail_kind(cfg)
    if kind is not None and rd_fusable(cfg, taps_np):
        if kind == "ca":
            return Chain(cfg, [Stage(
                "rd_fused", lambda x, rt: fused_rd_chain(x, rt, taps_np, cfg),
                terminal=True)], device)
        if kind == "gos" and cfg.fft.max_size % GOS_TILE == 0:
            return Chain(cfg, [
                Stage("rd_map_fused",
                      lambda x, rt: fused_rd_chain(x, rt, taps_np, cfg,
                                                   emit="map")),
                Stage("mag_gos_cfar_fused",
                      lambda x, rt: fused_mag_gos_dispatch(x, rt, cfg.cfar),
                      terminal=True)], device)
    return Chain(cfg, [matched_filter_stage(cfg, taps_np), doppler_stage(cfg),
                       *tail_stages(cfg)], device)


def rx_rd_tx_chain(cfg: Optional[ChainConfig] = None, taps=None,
                   device=None) -> Chain:
    """The served range-Doppler top: packed IQ beat words ``[..., P, N]`` in,
    packed ``{threshold | bin | peak}`` words of every map cell out (an
    int32 view), around ``range_doppler_chain``."""
    cfg = cfg or ChainConfig(doppler=DopplerConfig())
    core = range_doppler_chain(cfg, taps=taps)
    return Chain(cfg, [_wire_rx_stage(), *core.stages, _wire_tx_stage(cfg)],
                 device)


def beamformed_rd_chain(cfg: Optional[ChainConfig] = None, taps=None,
                        angles_rad=None, num_channels: int = 8,
                        fft_beams: bool = False, device=None) -> Chain:
    """Element-space CPIs ``[..., C, P, N]`` -> beams -> range-Doppler:
    ``CfarOutput`` over ``[..., B, P, N]``. Conventional beams steered at
    ``angles_rad`` for a half-wavelength ULA, or with ``fft_beams`` the DFT
    beam space (C beams)."""
    cfg = cfg or ChainConfig(doppler=DopplerConfig())
    if angles_rad is None:
        angles_rad = np.deg2rad(np.linspace(-60, 60, 8))
    weights = None if fft_beams else ula_steering(num_channels, angles_rad)

    def bf(x, rt):
        xp = as_pair(x)
        c, p, n = xp.shape[-3:]
        if c != num_channels:
            raise ValueError(f"{c} channels, the chain was built for "
                             f"{num_channels}")
        flat = C(xp.re.reshape(xp.shape[:-2] + (p * n,)),
                 xp.im.reshape(xp.shape[:-2] + (p * n,)))
        y = fft_beamform(flat) if fft_beams else beamform(flat, weights)
        return C(y.re.reshape(y.shape[:-1] + (p, n)),
                 y.im.reshape(y.shape[:-1] + (p, n)))

    rd = range_doppler_chain(cfg, taps=taps)
    return Chain(cfg, [Stage("fft_beamform" if fft_beams else "beamform", bf),
                       *rd.stages], device)


def integrated_search_chain(cfg: Optional[ChainConfig] = None, taps=None,
                            mode: str = "noncoherent", m_of_n: int = 0,
                            device=None) -> Chain:
    """Search-mode pulse integration over CPIs ``[..., P, N]`` (no Doppler
    filter bank): the matched filter per pulse, then ``noncoherent``
    (magnitude mean over pulses before the CFAR), ``coherent`` (complex sum
    before the magnitude) or ``binary`` (per-pulse CFAR decisions fused
    m-of-n; the threshold is the per-pulse mean). ``CfarOutput`` over
    ``[..., N]``."""
    cfg = cfg or ChainConfig()
    if taps is None:
        taps = lfm_chirp((cfg.matched_filter or MatchedFilterConfig()).num_taps)
    if mode not in ("noncoherent", "coherent", "binary"):
        raise ValueError(f"mode {mode!r} (choose 'noncoherent', 'coherent' "
                         "or 'binary')")
    if mode == "binary" and m_of_n < 1:
        raise ValueError("binary integration needs m_of_n >= 1")
    mf, mag, cfar = matched_filter_stage(cfg, taps), mag_stage(cfg), cfar_stage(cfg)
    if mode == "coherent":
        def integ(x, rt):
            xp = as_pair(x)
            return C(coherent_integration(xp.re), coherent_integration(xp.im))

        stages = [mf, Stage("coherent_integration", integ), mag, cfar]
    elif mode == "noncoherent":
        stages = [mf, mag, Stage("noncoherent_integration",
                                 lambda m, rt: noncoherent_integration(m)),
                  cfar]
    else:
        def fuse(out, rt):
            return CfarOutput(threshold=out.threshold.mean(dim=-2),
                              peaks=binary_integration(out.peaks, m_of_n))

        stages = [mf, mag, cfar,
                  Stage("binary_integration", fuse, terminal=True)]
    return Chain(cfg, stages, device)
