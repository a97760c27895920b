"""The PyTorch port's main path, ``fft_mag_cfar_chain``, against the JAX
package's, for CA elaborations, for the default ``ChainConfig()`` (GOSCA +
CASH) and for the fixed-point elaborations, plus the mirrored configs and the
state conversion.

The JAX side runs its XLA composition (``use_pallas=False``, one compile for
the whole register sweep); the port runs its kernel route, which on CPU tensors
takes the kernels' plain versions. Bar: max|dthr| / max|thr| < 1e-4, the
bench's; peaks equal."""

import dataclasses
import enum
import functools
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu import configs as RC

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch import configs as TC
from rsp_chains_tpu_torch.convert import (
    chain_config_from_reference, runtime_from_reference,
)

REL = 1e-4
REPO = Path(__file__).resolve().parent.parent


def _cfg_j(use_pallas=False, **fft):
    return R.ChainConfig(
        fft=R.FftConfig(**{"max_size": 1024, **fft}),
        cfar=R.CfarConfig(max_ref_window=64, variant=R.CfarVariant.CA,
                          include_cash=False, use_pallas=use_pallas))


@functools.lru_cache(maxsize=None)
def _jax_chain(cfg_j):
    return R.fft_mag_cfar_chain(cfg_j).jit()


def _frames():
    """The three-tone test vector and three noisy frames with tones."""
    rng = np.random.RandomState(11110)
    noise = (rng.randn(3, 1024) + 1j * rng.randn(3, 1024)) * 30
    tones = 900 * np.exp(2j * np.pi * 0.13 * np.arange(1024))
    x = np.concatenate([
        T.golden.three_tone_signal(1024, shift_range_factor=12)[None],
        noise + tones])
    return x.astype(np.complex64)


def _compare(cfg_j, rt_j, cfg_t=None):
    """Run the JAX chain (XLA) and the port's chain on the same frames."""
    x = _frames()
    want = _jax_chain(dataclasses.replace(
        cfg_j, cfar=dataclasses.replace(cfg_j.cfar, use_pallas=False)))(
            R.as_pair(x), rt_j)
    chain = T.fft_mag_cfar_chain(cfg_t or chain_config_from_reference(cfg_j))
    got = chain(T.as_pair(x), runtime_from_reference(rt_j.peek()))
    thr_w = np.asarray(want.threshold)
    rel = np.abs(got.threshold.numpy() - thr_w).max() / np.abs(thr_w).max()
    assert rel < REL, rel
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))
    return chain, got


# the CA entries of the 13-register sweep of tests/test_no_recompile.py, plus
# registers it leaves out (its GOS and CASH entries are in DEFAULT_SWEEP)
SWEEP = [
    dict(),
    dict(fft_size=256),
    dict(fft_size=64),
    dict(mag_mode=R.MagMode.SQR),
    dict(mag_mode=R.MagMode.LOG2, log_or_linear=0, threshold_scaler=2.0),
    dict(cfar_mode=R.CfarMode.GREATEST_OF),
    dict(cfar_mode=R.CfarMode.SMALLEST_OF),
    dict(ref_window_size=16, guard_window_size=2, div_sum=4),
    dict(ref_window_size=64, guard_window_size=8, div_sum=6),
    dict(peak_grouping=1),
    dict(threshold_scaler=10.0),
    dict(mag_mode=R.MagMode.ABS),
    dict(ref_window_size=2, guard_window_size=1, div_sum=1),
    dict(cfar_fft_size=768),
    dict(cfar_mode=R.CfarMode.CASH),   # CASH not elaborated: degrades to CA
]


@pytest.mark.parametrize("regs", SWEEP)
def test_chain_matches_jax_over_register_sweep(regs):
    rt_j = R.RuntimeConfig.make(**{"fft_size": 1024, "ref_window_size": 32,
                                   "guard_window_size": 4, **regs})
    chain, _ = _compare(_cfg_j(use_pallas=True), rt_j)
    assert chain.stage_names == ("fft_mag_cfar_fused",)


GOSCA = dict(variant=R.CfarVariant.GOSCA, include_cash=True)
GOS = dict(variant=R.CfarVariant.GOS, include_cash=False)


@pytest.mark.parametrize("fft, cfar, stages", [
    (dict(window="hann"), {}, ("fft", "mag_cfar_fused")),
    (dict(use_bit_reverse=False), {}, ("fft", "mag_cfar_fused")),
    (dict(max_size=2048), dict(max_fft_size=2048), ("fft", "mag_cfar_fused")),
    ({}, dict(use_pallas=False), ("fft", "logmag", "cfar")),
    ({}, dict(emit_noise=True), ("fft", "logmag", "cfar")),
    ({}, dict(max_ref_window=128), ("fft", "logmag", "cfar")),
    ({}, GOSCA, ("fft_mag_gos_cfar_fused",)),
    ({}, GOS, ("fft_mag_gos_cfar_fused",)),
    (dict(window="hann"), GOSCA, ("fft", "mag_gos_cfar_fused")),
    (dict(use_bit_reverse=False), GOS, ("fft", "mag_gos_cfar_fused")),
    (dict(max_size=2048), dict(max_fft_size=2048, **GOSCA),
     ("fft", "mag_gos_cfar_fused")),
    ({}, dict(variant=R.CfarVariant.CA, include_cash=True),
     ("fft", "logmag", "cfar")),
    ({}, dict(edge_policy=R.EdgePolicy.WRAP, **GOSCA),
     ("fft", "logmag", "cfar")),
    ({}, dict(send_cut=True, **GOS), ("fft", "logmag", "cfar")),
])
def test_routing_follows_the_jax_gates(fft, cfar, stages):
    n = fft.get("max_size", 1024)
    cfg_j = R.ChainConfig(
        fft=R.FftConfig(**{"max_size": 1024, **fft}),
        cfar=R.CfarConfig(**{"max_ref_window": 64, "variant": R.CfarVariant.CA,
                             "include_cash": False, **cfar}))
    chain = T.fft_mag_cfar_chain(chain_config_from_reference(cfg_j))
    assert chain.stage_names == stages
    if n == 1024:
        _compare(cfg_j, R.RuntimeConfig.make(fft_size=1024, peak_grouping=1))


def test_lut_log_takes_the_plain_ops_and_matches_jax():
    cfg_j = dataclasses.replace(_cfg_j(use_pallas=True),
                                mag=R.LogMagConfig(use_lut_log=True))
    chain, _ = _compare(cfg_j, R.RuntimeConfig.make(
        fft_size=1024, mag_mode=3, log_or_linear=0, threshold_scaler=4.0))
    assert chain.stage_names == ("fft", "logmag", "cfar")


def test_three_tone_detections():
    chain = T.fft_mag_cfar_chain(chain_config_from_reference(
        _cfg_j(use_pallas=True)))
    iq = T.golden.three_tone_signal(1024, shift_range_factor=12)
    rt = T.RuntimeConfig.make(fft_size=1024, ref_window_size=32,
                              guard_window_size=4, threshold_scaler=3.5,
                              div_sum=5)
    out = chain.jit()(T.as_pair(iq), rt)
    assert np.flatnonzero(out.peaks.numpy()).tolist() == [0, 128, 256, 512]
    # a complex tensor gives the same answer as the pair
    out_c = chain(torch.from_numpy(iq.astype(np.complex64)), rt)
    assert torch.equal(out_c.peaks, out.peaks)


# the default elaboration at full width: GOS registers of the JAX bench
# (bench.py:600-603), modes, ranks, CASH sub-windows, the CA algorithm, the
# FFT-size and CFAR-size registers
DEFAULT_SWEEP = [
    (dict(), {}),
    (dict(cfar_algorithm=1, index_lagg=16, index_lead=16), {}),
    (dict(cfar_algorithm=1, cfar_mode=1, index_lagg=8, index_lead=24), {}),
    (dict(cfar_algorithm=1, cfar_mode=2, index_lagg=0, index_lead=0,
          peak_grouping=1), {}),
    (dict(cfar_algorithm=1, ref_window_size=64, guard_window_size=8,
          div_sum=6, index_lagg=63, index_lead=40), {}),
    (dict(cfar_algorithm=1, index_lagg=16, index_lead=16),
     dict(index_lagg=50, index_lead=64)),               # ranks >= the window
    (dict(cfar_mode=3, sub_window_size=8), {}),
    (dict(cfar_mode=3, cfar_algorithm=1, sub_window_size=2), {}),
    (dict(cfar_algorithm=1, index_lagg=16, index_lead=16, mag_mode=3,
          log_or_linear=0, threshold_scaler=2.0), {}),
    # sub_w > w: the noise is 0 and the threshold the log-domain scaler
    (dict(cfar_mode=3, sub_window_size=8, mag_mode=3, log_or_linear=0,
          threshold_scaler=2.0), dict(sub_window_size=64)),
    (dict(cfar_algorithm=1, fft_size=512, index_lagg=16, index_lead=16), {}),
    (dict(cfar_mode=3, cfar_fft_size=768, sub_window_size=4), {}),
]


@pytest.mark.parametrize("regs, raw", DEFAULT_SWEEP)
def test_default_chain_matches_jax_at_full_width(regs, raw):
    """``fft_mag_cfar_chain()`` with the default ``ChainConfig()`` (GOSCA +
    CASH, N = 1024, max_ref_window 64) against the JAX package's default chain
    on its XLA composition."""
    rt_j = R.RuntimeConfig.make(**{"fft_size": 1024, "ref_window_size": 32,
                                   "guard_window_size": 4, **regs})
    rt_j = dataclasses.replace(rt_j, **{k: np.int32(v) for k, v in raw.items()})
    chain, _ = _compare(R.ChainConfig(), rt_j, T.ChainConfig())
    assert T.fft_mag_cfar_chain().stage_names == ("fft_mag_gos_cfar_fused",)
    assert chain.stage_names == ("fft_mag_gos_cfar_fused",)


def _fixed_point_frames():
    """Integer frames at a scale where the fixed-point grid bites (binPoint
    0: the DIV_N spectrum of these frames is a few units)."""
    rng = np.random.RandomState(11111)
    x = (rng.randn(3, 1024) + 1j * rng.randn(3, 1024)) * 300
    x += 20000 * np.exp(2j * np.pi * 0.13 * np.arange(1024))
    return (np.round(x.real) + 1j * np.round(x.imag)).astype(np.complex64)


@pytest.mark.parametrize("cfg_j, stages", [
    (R.ChainConfig(cfar=R.CfarConfig(variant=R.CfarVariant.CA,
                                     include_cash=False),
                   fixed_point=R.FixedPointConfig(enabled=True)),
     ("fft", "logmag", "cfar")),
    (R.ChainConfig(cfar=R.CfarConfig(variant=R.CfarVariant.CA,
                                     include_cash=False),
                   fixed_point=R.FixedPointConfig(enabled=True,
                                                  bit_true=True)),
     ("fft_mag_cfar_int_fused",)),
    (R.ChainConfig(fixed_point=R.FixedPointConfig(enabled=True)),
     ("fft", "logmag", "cfar")),
])
def test_fixed_point_elaborations_match_jax(cfg_j, stages):
    """Float fidelity (boundary quantization after each non-terminal stage)
    and the bit-true integer chain, each against the JAX chain of the same
    elaboration: the bit-true one exactly, the float fidelity one at the
    bench's bar."""
    chain = T.fft_mag_cfar_chain(chain_config_from_reference(cfg_j))
    assert chain.stage_names == stages
    assert chain.stage_names == R.fft_mag_cfar_chain(cfg_j).stage_names
    x = _fixed_point_frames()
    rt_j = R.RuntimeConfig.make(fft_size=1024, ref_window_size=32,
                                guard_window_size=4, cfar_algorithm=1,
                                index_lagg=16, index_lead=16)
    plain_j = dataclasses.replace(cfg_j, cfar=dataclasses.replace(
        cfg_j.cfar, use_pallas=False))
    want = _jax_chain(plain_j)(R.as_pair(x), rt_j)
    got = chain(T.as_pair(x), runtime_from_reference(rt_j.peek()))
    thr_w = np.asarray(want.threshold)
    if cfg_j.fixed_point.bit_true:
        np.testing.assert_array_equal(got.threshold.numpy(), thr_w)
    else:
        rel = np.abs(got.threshold.numpy() - thr_w).max() / np.abs(thr_w).max()
        assert rel < REL, rel
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))


def test_package_imports_no_jax():
    code = ("import sys, rsp_chains_tpu_torch; "
            "import rsp_chains_tpu_torch.ops.nco, rsp_chains_tpu_torch.ops.plfg; "
            "import rsp_chains_tpu_torch.io, rsp_chains_tpu_torch.io.cpi, "
            "rsp_chains_tpu_torch.io.server, rsp_chains_tpu_torch.cli, "
            "rsp_chains_tpu_torch.ops.detect, "
            "rsp_chains_tpu_torch.utils.profiling, "
            "rsp_chains_tpu_torch.parallel.multihost, "
            "rsp_chains_tpu_torch.golden.models, "
            "rsp_chains_tpu_torch.golden.int_models; "
            "assert 'jax' not in sys.modules, 'jax imported'; "
            "assert 'rsp_chains_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


def test_chains_compose_and_keep_their_stages():
    cfg = chain_config_from_reference(_cfg_j(use_pallas=False))
    head = T.Chain(cfg, [T.Stage("fft", lambda x, rt: x)])
    tail = T.Chain(cfg, [T.Stage("cfar", lambda x, rt: x)])
    both = head + tail
    assert both.stage_names == ("fft", "cfar")
    assert both.jit() is both
    with pytest.raises(TypeError):
        head + 1


_MIRRORED = ["MagMode", "CfarMode", "CfarAlgorithm", "CfarVariant",
             "FftScaling", "Rounding", "EdgePolicy", "FixedPointConfig",
             "PlfgConfig", "NcoConfig", "FftConfig", "LogMagConfig",
             "CfarConfig", "MatchedFilterConfig", "DopplerConfig",
             "RuntimeConfig", "ChainConfig"]


@pytest.mark.parametrize("name", _MIRRORED)
def test_configs_mirror_the_jax_package(name):
    ref, port = getattr(RC, name), getattr(TC, name)
    if issubclass(ref, enum.Enum):
        assert [(m.name, m.value) for m in ref] == \
            [(m.name, m.value) for m in port]
        return
    ref_fields = [(f.name, f.default) for f in dataclasses.fields(ref)]
    port_fields = [(f.name, f.default) for f in dataclasses.fields(port)]
    assert [n for n, _ in ref_fields] == [n for n, _ in port_fields]
    for (n, a), (_, b) in zip(ref_fields, port_fields):
        if isinstance(a, enum.Enum):
            assert (a.name, a.value) == (b.name, b.value), n
        elif a is not dataclasses.MISSING:
            assert a == b, n


def test_chain_config_converts_field_for_field():
    cfg_j = R.ChainConfig(
        fft=R.FftConfig(max_size=512, scaling=R.FftScaling.SQRT_N,
                        expand_logic=(1, 0) * 4 + (1,), window="hann"),
        cfar=R.CfarConfig(variant=R.CfarVariant.CA, include_cash=False,
                          edge_policy=R.EdgePolicy.REFLECT),
        doppler=R.DopplerConfig(num_pulses=64),
        fixed_point=R.FixedPointConfig(rounding=R.Rounding.TRUNCATE))
    got = chain_config_from_reference(cfg_j)
    assert isinstance(got, T.ChainConfig)
    assert got.fft == T.FftConfig(max_size=512, scaling=T.FftScaling.SQRT_N,
                                  expand_logic=(1, 0) * 4 + (1,),
                                  window="hann")
    assert got.cfar.edge_policy is T.EdgePolicy.REFLECT
    assert got.doppler == T.DopplerConfig(num_pulses=64)
    assert got.fixed_point.rounding is T.Rounding.TRUNCATE
    assert chain_config_from_reference(R.ChainConfig()) == T.ChainConfig()


@pytest.mark.parametrize("kw", [
    dict(), dict(fft_size=64, ref_window_size=8, guard_window_size=2),
    dict(mag_mode=3, threshold_scaler=0.1, phase_offset=0.3),
    dict(ref_window_size=2, guard_window_size=1, cfar_fft_size=300),
])
def test_registers_carry_over_and_match_make(kw):
    rt_j = R.RuntimeConfig.make(**kw)
    rt_t = runtime_from_reference(rt_j.peek())
    assert rt_t.peek() == rt_j.peek()
    assert rt_t == T.RuntimeConfig.make(**kw)
    assert rt_t.fft_size == int(rt_j.fft_size)


@pytest.mark.parametrize("kw", [
    dict(fft_size=1000), dict(cfar_fft_size=0), dict(ref_window_size=24),
    dict(guard_window_size=0), dict(ref_window_size=4, guard_window_size=4),
    dict(ref_window_size=8, sub_window_size=8),
    dict(ref_window_size=8, index_lead=8), dict(ref_window_size=8,
                                                index_lagg=9),
])
def test_make_refuses_what_jax_refuses(kw):
    with pytest.raises(ValueError):
        R.RuntimeConfig.make(**kw)
    with pytest.raises(ValueError):
        T.RuntimeConfig.make(**kw)


def test_merge_regs_writes_only_named_registers():
    rt = T.RuntimeConfig.make(ref_window_size=16, guard_window_size=2,
                              plfg_profile=np.arange(4))
    got = rt.merge_regs(cfar_mode=2)
    assert got.cfar_mode == 2 and got.ref_window_size == 16
    np.testing.assert_array_equal(got.plfg_profile, np.arange(4))
    want = R.RuntimeConfig.make(ref_window_size=16,
                                guard_window_size=2).merge_regs(cfar_mode=2)
    assert got.peek() == want.peek()
    with pytest.raises(ValueError, match="unknown registers"):
        rt.merge_regs(no_such_register=1)
    small = T.CfarConfig(max_ref_window=8, max_guard_window=1)
    with pytest.raises(ValueError):
        rt.merge_regs(validate_against=small)


def test_as_pair_and_to_numpy_round_trip():
    x = _frames()[:2, :8]
    pair = T.as_pair(x)
    assert pair.re.dtype == torch.float32 and pair.re.is_contiguous()
    np.testing.assert_array_equal(T.to_numpy(pair), x)
    from_tensor = T.as_pair(torch.from_numpy(x))
    assert torch.equal(from_tensor.re, pair.re)
    assert torch.equal(from_tensor.im, pair.im)
    real = T.as_pair(np.ones(4))
    assert torch.equal(real.im, torch.zeros(4))
