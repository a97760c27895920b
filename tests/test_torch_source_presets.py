"""``rsp_chain_vanilla``, the self-stimulus top (PLFG -> NCO -> FFT ->
magnitude -> CFAR), in the port against the JAX package's, on the CPU, over
the start words of ``tests/test_rsp_chain.py``, profiles written through
``rt.plfg_profile`` (seeded, LFM, the reprogramming test's) and the fixed-
point, float CA, GOSCA + CASH and bit-true elaborations. The JAX presets run
as the JAX package's own tests run them, Pallas in interpret mode, except
where a GOS point would take seconds a frame there: those run its XLA
composition, the semantics the kernel is held to.

Bar: the bench's, max|dthr| / max|thr| < 1e-4 and peak flips <= 1e-5 of
the cells; exactly under the fixed-point default and the bit-true
elaboration.

A float elaboration fed a pure NCO tone has no noise floor: every cell
away from the tone holds only the rounding of the NCO and the FFT, whose
bits differ between XLA and torch, so the CFAR's decisions there are
decisions on rounding noise. On such frames the peaks are held at every
cell whose magnitude is farther than the threshold bar (1e-4 of max|thr|)
from its threshold on the JAX side, and the tone's bin must be a peak on
both sides."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.ops import plfg as RP
from rsp_chains_tpu.ops.fft import fft_op as fft_j
from rsp_chains_tpu.ops.logmag import logmag as logmag_j

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.convert import (
    chain_config_from_reference, runtime_from_reference,
)
from rsp_chains_tpu_torch.ops import plfg as TP

from test_torch_sources import CPU, N, _both

REL, FLIPS = 1e-4, 1e-5

def _ca(use_pallas=True, fixed_point=None):
    """tests/test_rsp_chain.py's elaboration (float CA)."""
    return R.ChainConfig(
        nco=R.NcoConfig(table_size=128, phase_width=9),
        fft=R.FftConfig(max_size=N),
        cfar=R.CfarConfig(max_ref_window=64, variant=R.CfarVariant.CA,
                          include_cash=False, use_pallas=use_pallas),
        fixed_point=fixed_point or R.FixedPointConfig())


FIXED = R.FixedPointConfig(enabled=True, width=16, bin_point=0)
GOS_REGS = dict(cfar_algorithm=1, index_lagg=16, index_lead=16)


def _rt(**kw):
    return R.RuntimeConfig.make(**{
        "fft_size": N, "ref_window_size": 32, "guard_window_size": 4,
        "threshold_scaler": 3.5, "div_sum": 5, **kw})


def _port_rt(rt_j, profile=None):
    return dataclasses.replace(runtime_from_reference(rt_j.peek()),
                               plfg_profile=profile)


@functools.lru_cache(maxsize=None)
def _vanilla_j(cfg_j, program=None):
    return R.rsp_chain_vanilla(cfg_j, program).jit()


def _vanilla_pair(cfg_j, program_spec=None):
    prog_j = prog_t = None
    if program_spec is not None:
        prog_j, prog_t = _both(program_spec)
    chain = T.rsp_chain_vanilla(
        None if cfg_j is None else chain_config_from_reference(cfg_j),
        prog_t, device="cpu")
    assert chain.device == CPU
    return _vanilla_j(cfg_j, prog_j), chain


def _hold(got, want, floor=None):
    """The bench bar; with ``floor`` (the JAX magnitude of a noiseless
    frame) flips count only at cells outside the threshold bar."""
    thr_w = np.asarray(want.threshold)
    thr_g = got.threshold.numpy()
    assert got.peaks.dtype == torch.bool and thr_g.shape == thr_w.shape
    scale = np.abs(thr_w).max()
    rel = np.abs(thr_g - thr_w).max() / scale
    assert rel < REL, rel
    flips = got.peaks.numpy() != np.asarray(want.peaks)
    if floor is not None:
        flips &= np.abs(np.asarray(floor) - thr_w) > REL * scale
    assert flips.sum() <= FLIPS * flips.size, int(flips.sum())


@pytest.mark.parametrize("start", [8, 16, 64])
def test_rsp_chain_vanilla_default_is_exact_and_keeps_the_peak_bin(start):
    """The default elaboration (16-bit fixed point, plain ops) at the start
    words of tests/test_rsp_chain.py: equal to JAX, and one detection, at
    s * N / (4 * table_size)."""
    chain_j, chain_t = _vanilla_pair(None)
    assert chain_t.stage_names == R.rsp_chain_vanilla().stage_names == (
        "plfg_nco", "fft", "logmag", "cfar")
    rt_j = _rt(nco_freq_word=start)
    want = chain_j(None, rt_j)
    got = chain_t(None, _port_rt(rt_j))
    np.testing.assert_array_equal(got.threshold.numpy(),
                                  np.asarray(want.threshold))
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))
    assert np.flatnonzero(got.peaks.numpy()).tolist() == [start * N // 512]


@pytest.mark.parametrize("start", [8, 16, 64])
def test_rsp_chain_vanilla_float_ca_matches_jax(start):
    """tests/test_rsp_chain.py's float CA elaboration at its start words:
    Kernel B's route (``mag_cfar_fused``), the tone's bin a peak on both
    sides."""
    cfg_j = _ca()
    chain_j, chain_t = _vanilla_pair(cfg_j)
    assert chain_t.stage_names == R.rsp_chain_vanilla(cfg_j).stage_names == (
        "plfg_nco", "fft", "mag_cfar_fused")
    rt_j = _rt(nco_freq_word=start)
    want = chain_j(None, rt_j)
    got = chain_t(None, _port_rt(rt_j))
    floor = logmag_j(fft_j(R.rsp_chain_vanilla(cfg_j).stages[0].fn(None, rt_j),
                           rt_j.log2_fft_size, cfg_j.fft), rt_j.mag_mode)
    _hold(got, want, floor=floor)
    peak = start * N // 512
    assert got.peaks[peak] and np.asarray(want.peaks)[peak]


def _profiles(kind):
    rng = np.random.RandomState(11110)
    if kind == "seeded walk, 3 frames":
        return (rng.randn(3, N) * 40).astype(np.float32)
    if kind == "seeded walk, 2 x 2 frames":
        return (rng.randn(2, 2, N) * 25).astype(np.float32)
    return RP.compile_program(RP.lfm_program(N, 64.0), None, N)


@pytest.mark.parametrize("kind", ["seeded walk, 3 frames",
                                  "seeded walk, 2 x 2 frames", "lfm"])
@pytest.mark.parametrize("elab, regs", [
    ("CA", {}), ("GOSCA", GOS_REGS), ("GOSCA", {}),
    ("GOSCA", dict(GOS_REGS, cfar_mode=3, sub_window_size=8))])
def test_rsp_chain_vanilla_with_a_profile_matches_jax(elab, regs, kind):
    """Profiles written through ``rt.plfg_profile`` (numpy and a tensor),
    leading axes the batch, through the float CA and the default GOSCA +
    CASH elaborations: the bench bar."""
    cfg_j = _ca() if elab == "CA" else R.ChainConfig()
    if elab == "GOSCA" and kind != "lfm":
        # the JAX GOS kernel in interpret mode takes seconds a frame; its
        # XLA composition is the semantics it is held to
        cfg_j = dataclasses.replace(cfg_j, cfar=dataclasses.replace(
            cfg_j.cfar, use_pallas=False))
    chain_j, chain_t = _vanilla_pair(cfg_j)
    prof = _profiles(kind)
    rt_j = _rt(nco_freq_word=16, plfg_profile=prof, **regs)
    want = chain_j(None, rt_j)
    for p in (prof, torch.from_numpy(prof)):
        got = chain_t(None, _port_rt(rt_j, p))
        assert got.threshold.shape == prof.shape
        _hold(got, want)


def test_runtime_plfg_reprogramming_matches_jax():
    """tests/test_rsp_chain.py's reprogramming: programs A and B written as
    profiles into one chain move the tone from bin 32 to 48, and B's profile
    equals B compiled in; under the fixed-point default every output is
    JAX's exactly."""
    chain_j, chain_t = _vanilla_pair(None)
    for spec, peak in (("constant tone repeated", 32), ("held offset", 48)):
        prog_j, prog_t = _both(spec)
        prof = TP.compile_program(prog_t, T.PlfgConfig(), N)
        rt_j = _rt(nco_freq_word=16, plfg_profile=RP.compile_program(
            prog_j, R.PlfgConfig(), N))
        want = chain_j(None, rt_j)
        got = chain_t(None, _port_rt(rt_j, torch.from_numpy(prof)))
        np.testing.assert_array_equal(got.threshold.numpy(),
                                      np.asarray(want.threshold))
        np.testing.assert_array_equal(got.peaks.numpy(),
                                      np.asarray(want.peaks))
        bins = np.flatnonzero(got.peaks.numpy()).tolist()
        assert peak in bins and (peak == 32 or 32 not in bins), bins
        compiled_in = T.rsp_chain_vanilla(program=prog_t, device="cpu")
        same = compiled_in(None, _port_rt(_rt(nco_freq_word=16)))
        assert torch.equal(same.threshold, got.threshold)
    # the float CA elaboration keeps the peak bins of the JAX test
    prog_j, prog_t = _both("held offset")
    chain_j, chain_t = _vanilla_pair(_ca())
    rt_j = _rt(nco_freq_word=16, plfg_profile=RP.compile_program(
        prog_j, R.PlfgConfig(), N))
    got = np.flatnonzero(chain_t(None, _port_rt(
        rt_j, rt_j.plfg_profile)).peaks.numpy()).tolist()
    want = np.flatnonzero(np.asarray(chain_j(None, rt_j).peaks)).tolist()
    assert 48 in got and 32 not in got and 48 in want and 32 not in want


def test_a_profile_of_another_frame_length_is_refused_with_the_jax_message():
    chain_t = T.rsp_chain_vanilla(device="cpu")
    rt_j = _rt(plfg_profile=np.zeros(512, np.float32))
    with pytest.raises(AssertionError) as jax_err:
        R.rsp_chain_vanilla()(None, rt_j)
    with pytest.raises(ValueError) as port_err:
        chain_t(None, _port_rt(rt_j, torch.zeros(512)))
    assert str(port_err.value) == str(jax_err.value)


def test_a_bit_true_vanilla_takes_the_integer_stage_and_matches_jax():
    """A bit-true elaboration with the quantized (integer) NCO table runs
    ``fft_mag_cfar_int_fused``, exactly as JAX."""
    cfg_j = dataclasses.replace(
        _ca(fixed_point=R.FixedPointConfig(enabled=True, bit_true=True)),
        nco=R.NcoConfig(quantized_lut=True))
    chain_j, chain_t = _vanilla_pair(cfg_j)
    assert chain_t.stage_names == R.rsp_chain_vanilla(cfg_j).stage_names == (
        "plfg_nco", "fft_mag_cfar_int_fused")
    rt_j = _rt(nco_freq_word=64)
    want = chain_j(None, rt_j)
    got = chain_t(None, _port_rt(rt_j))
    np.testing.assert_array_equal(got.threshold.numpy(),
                                  np.asarray(want.threshold))
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))
    assert got.peaks[128]
