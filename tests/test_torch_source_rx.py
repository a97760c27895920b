"""``chain_with_mem`` (the ROM-stimulus top) and ``real_rx_chain`` (real
ADC frames through ``rfft_op`` and the tail at N / 2) in the port against
the JAX package's, on the CPU: the default ROM and a seeded ROM of leading
shape ``[2, 3]``, with the read gate off and on; the real tones of
``tests/test_chain.py`` and the SQRT_N point of
``tests/test_presets_extra.py``; the refusals. Bar: the bench's (see
``test_torch_source_presets.py``)."""

import dataclasses
import functools

import numpy as np
import pytest

import rsp_chains_tpu as R

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.convert import chain_config_from_reference

from test_torch_source_presets import FIXED, GOS_REGS, N, _ca, _hold, _port_rt, _rt

def _rom(shape):
    """Three tones and sqrt-uniform noise at 2^13, as the default ROM, on
    every frame of ``shape``, each frame's noise seeded apart."""
    frames = int(np.prod(shape[:-1]))
    rows = [T.golden.three_tone_signal(shape[-1], shift_range_factor=13,
                                       seed=11110 + i) for i in range(frames)]
    return np.stack(rows).reshape(shape)


@functools.lru_cache(maxsize=None)
def _mem_j(cfg_j, rom_shape):
    return R.chain_with_mem(cfg_j, None if rom_shape is None
                            else _rom(rom_shape)).jit()


@pytest.mark.parametrize("rom_shape", [None, (2, 3, N)])
@pytest.mark.parametrize("elab, regs, stages", [
    ("default", GOS_REGS, ("mem_rom", "fft", "mag_gos_cfar_fused")),
    ("default", {}, ("mem_rom", "fft", "mag_gos_cfar_fused")),
    ("default", dict(GOS_REGS, cfar_mode=3, sub_window_size=8),
     ("mem_rom", "fft", "mag_gos_cfar_fused")),
    ("CA", {}, ("mem_rom", "fft", "mag_cfar_fused")),
    ("fixed point", {}, ("mem_rom", "fft", "logmag", "cfar"))])
def test_chain_with_mem_matches_jax(elab, regs, stages, rom_shape):
    cfg_j = {"default": R.ChainConfig(), "CA": _ca(),
             "fixed point": R.ChainConfig(fixed_point=FIXED)}[elab]
    if elab == "default" and rom_shape is not None:
        cfg_j = dataclasses.replace(cfg_j, cfar=dataclasses.replace(
            cfg_j.cfar, use_pallas=False))  # interpret mode: see above
    chain_j = _mem_j(cfg_j, rom_shape)
    chain_t = T.chain_with_mem(
        chain_config_from_reference(cfg_j),
        None if rom_shape is None else _rom(rom_shape), device="cpu")
    if cfg_j.cfar.use_pallas:
        assert chain_t.stage_names == stages
    assert chain_t.stage_names == R.chain_with_mem(cfg_j).stage_names
    rt_j = _rt(**regs)
    want = chain_j(None, rt_j)
    got = chain_t(None, _port_rt(rt_j))
    assert got.threshold.shape == (rom_shape or (N,))
    _hold(got, want)
    if rom_shape is None and elab != "fixed point":
        assert {128, 256, 512} <= set(np.flatnonzero(got.peaks.numpy()))
    # the read gate: a zero frame, no detections on both sides
    off = _rt(mem_start_reading=0, **regs)
    want_off, got_off = chain_j(None, off), chain_t(None, _port_rt(off))
    assert not np.asarray(want_off.peaks).any()
    assert not got_off.peaks.any() and not got_off.threshold.any()


def _real_frames(n, frames, seed=9):
    rng = np.random.RandomState(seed)
    i = np.arange(n)
    tones = 3000 * np.cos(2 * np.pi * i / 8) + 2000 * np.cos(2 * np.pi * i / 4)
    return (tones + 20 * rng.randn(frames, n)).astype(np.float32)


def test_real_rx_chain_sqrt_n_point_matches_jax():
    """test_presets_extra.py::test_real_rx_chain_honors_sqrt_n_scaling_and_rejects_window:
    SQRT_N scaling at N = 512, the plain tail."""
    n = 512
    cfg_j = R.ChainConfig(
        fft=R.FftConfig(max_size=n, scaling=R.FftScaling.SQRT_N),
        cfar=R.CfarConfig(max_ref_window=16, max_guard_window=4,
                          max_fft_size=n // 2, variant=R.CfarVariant.CA,
                          include_cash=False, use_pallas=False))
    x = np.random.RandomState(11110).randn(2, n).astype(np.float32)
    rt_j = R.RuntimeConfig.make(fft_size=n, cfar_fft_size=n // 2,
                                ref_window_size=8, guard_window_size=2,
                                threshold_scaler=3.0, div_sum=3)
    want = R.real_rx_chain(cfg_j).jit()(x, rt_j)
    chain_t = T.real_rx_chain(chain_config_from_reference(cfg_j), device="cpu")
    assert chain_t.stage_names == ("rfft", "logmag", "cfar")
    got = chain_t(x, _port_rt(rt_j))
    assert got.threshold.shape == (2, n // 2)
    _hold(got, want)


@pytest.mark.parametrize("elab, regs, stages", [
    ("default", GOS_REGS, ("rfft", "mag_gos_cfar_fused")),
    ("default", {}, ("rfft", "mag_gos_cfar_fused")),
    ("CA", {}, ("rfft", "mag_cfar_fused")),
    ("fixed point", {}, ("rfft", "logmag", "cfar"))])
def test_real_rx_chain_matches_jax(elab, regs, stages):
    """tests/test_chain.py's real tones at 1/8 and 1/4 with noise, three
    frames at N = 1024; the tail runs at 512 cells (Kernel B or C's
    route)."""
    cfg_j = {"default": R.ChainConfig(), "CA": _ca(),
             "fixed point": R.ChainConfig(fixed_point=FIXED)}[elab]
    chain_t = T.real_rx_chain(chain_config_from_reference(cfg_j), device="cpu")
    assert chain_t.stage_names == R.real_rx_chain(cfg_j).stage_names == stages
    if elab == "default":
        cfg_j = dataclasses.replace(cfg_j, cfar=dataclasses.replace(
            cfg_j.cfar, use_pallas=False))  # interpret mode: see above
    x = _real_frames(N, 3)
    rt_j = _rt(cfar_fft_size=N // 2, **regs)
    want = R.real_rx_chain(cfg_j).jit()(x, rt_j)
    got = chain_t(x, _port_rt(rt_j))
    assert got.threshold.shape == (3, N // 2)
    _hold(got, want)
    if elab != "fixed point":
        assert {128, 256} <= set(np.flatnonzero(got.peaks.numpy()[0]))


@pytest.mark.parametrize("fft", [
    dict(window="hann"),
    dict(scaling=R.FftScaling.NONE, expand_logic=(1,) * 10),
    dict(keep_msb_or_lsb=(True,) * 9 + (False,))])
def test_real_rx_chain_refuses_what_the_rfft_cannot_honor(fft):
    cfg_j = R.ChainConfig(fft=R.FftConfig(max_size=N, **fft))
    with pytest.raises(ValueError) as jax_err:
        R.real_rx_chain(cfg_j)
    with pytest.raises(ValueError) as port_err:
        T.real_rx_chain(chain_config_from_reference(cfg_j), device="cpu")
    assert str(port_err.value) == str(jax_err.value)
