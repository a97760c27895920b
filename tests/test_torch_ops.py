"""The PyTorch port's plain ops against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through both. Bar: relative
error max|d| / max|want| < 1e-4, the bench's threshold bar; torch.fft against
the JAX four-step FFT measures ~1e-6. Peaks must be equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.golden.models import cfar_golden
from rsp_chains_tpu.ops.cfar import cfar_op as cfar_jax
from rsp_chains_tpu.ops.fft import fft_op as fft_jax
from rsp_chains_tpu.ops.logmag import logmag as logmag_jax

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.convert import (
    chain_config_from_reference, runtime_from_reference,
)
from rsp_chains_tpu_torch.ops.cfar import cfar_op
from rsp_chains_tpu_torch.ops.fft import fft_op
from rsp_chains_tpu_torch.ops.logmag import logmag

REL = 1e-4


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _pairs(x):
    """The same complex numpy frames as a JAX pair and a port pair."""
    x = x.astype(np.complex64)
    return R.as_pair(x), T.as_pair(x)


def _frames(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) + 1j * rng.randn(*shape)) * 50
    x[..., 40] = 4000 + 100j
    x[..., 200] = 2500 - 500j
    return x


def _fft_cfg(n, scaling, **kw):
    log2n = n.bit_length() - 1
    if scaling == "expand":
        kw["expand_logic"] = tuple(k % 3 == 0 for k in range(log2n))
    else:
        kw["scaling"] = R.FftScaling(scaling)
    return R.FftConfig(max_size=n, **kw)


@functools.lru_cache(maxsize=None)
def _fft_jax_jit(cfg):
    # one compile per elaboration: the size register is traced
    return jax.jit(lambda x, log2: fft_jax(x, log2, cfg))


def _check_fft(cfg_j, size, seed=0):
    n = cfg_j.max_size
    xj, xt = _pairs(_frames((3, n), seed))
    log2 = size.bit_length() - 1
    want = _fft_jax_jit(cfg_j)(xj, jnp.int32(log2))
    got = fft_op(xt, log2, chain_config_from_reference(
        R.ChainConfig(fft=cfg_j)).fft)
    want_c = np.asarray(want.re) + 1j * np.asarray(want.im)
    got_c = got.re.numpy() + 1j * got.im.numpy()
    assert _rel(got_c, want_c) < REL
    active = min(max(log2, cfg_j.min_log2_size), cfg_j.log2_max)
    assert not np.any(got_c[..., 1 << active:])


@pytest.mark.parametrize("scaling", ["div_n", "sqrt_n", "none", "expand"])
@pytest.mark.parametrize("size", [64, 256, "N"])
@pytest.mark.parametrize("n", [256, 512, 1024])
def test_fft_op_matches_jax(n, size, scaling):
    _check_fft(_fft_cfg(n, scaling), n if size == "N" else size)


@pytest.mark.parametrize("size", [64, 256])
def test_fft_op_bit_reversed_order_matches_jax(size):
    _check_fft(_fft_cfg(256, "div_n", use_bit_reverse=False), size)


@pytest.mark.parametrize("window", ["hann", "taylor"])
def test_fft_op_window_matches_jax(window):
    _check_fft(_fft_cfg(512, "div_n", window=window), 512)


def test_fft_op_size_register_clips_to_elaborated_range():
    # 2^2 is below min_log2_size 3, 2^12 above max: both clip, as in JAX
    _check_fft(_fft_cfg(256, "div_n"), 4)
    _check_fft(_fft_cfg(256, "div_n"), 4096)


def test_fft_op_refuses_lsb_keep_like_jax():
    keep = (True,) * 7 + (False,)
    xj, xt = _pairs(_frames((1, 256)))
    with pytest.raises(ValueError):
        fft_jax(xj, None, R.FftConfig(max_size=256, keep_msb_or_lsb=keep))
    with pytest.raises(ValueError):
        fft_op(xt, None, T.FftConfig(max_size=256, keep_msb_or_lsb=keep))


def test_lsb_keep_error_names_the_bit_true_route():
    """The refusal names the route that reproduces LSB-keep stages, the
    bit-true pipeline, as the JAX message does, and no longer calls it
    unported."""
    keep = (True,) * 7 + (False,)
    _, xt = _pairs(_frames((1, 256)))
    route = "FixedPointConfig(enabled=True, bit_true=True)"
    with pytest.raises(ValueError) as want:
        fft_jax(R.as_pair(_frames((1, 256)).astype(np.complex64)), None,
                R.FftConfig(max_size=256, keep_msb_or_lsb=keep))
    with pytest.raises(ValueError) as got:
        fft_op(xt, None, T.FftConfig(max_size=256, keep_msb_or_lsb=keep))
    assert route in str(want.value) and route in str(got.value)
    assert "fft_int_op" in str(got.value)
    assert "not ported" not in str(got.value)


def test_fft_op_complex_tensor_in_complex_tensor_out():
    x = _frames((2, 256)).astype(np.complex64)
    got = fft_op(torch.from_numpy(x), None, T.FftConfig(max_size=256))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), np.fft.fft(x) / 256,
                               rtol=0, atol=1e-4 * np.abs(np.fft.fft(x)).max())


@pytest.mark.parametrize("mode", [0, 1, 2, 3, 7])
def test_logmag_matches_jax(mode):
    x = _frames((4, 256), seed=3)
    x[..., :8] *= 1e-12  # tiny values exercise the log2 floor
    xj, xt = _pairs(x)
    want = np.asarray(logmag_jax(xj, jnp.int32(mode)))
    got = logmag(xt, mode).numpy()
    assert _rel(got, want) < REL


def test_logmag_lut_path_matches_jax():
    """The LUT path floors log2 to a 2^-9 grid; where torch's and XLA's log2
    differ by an ulp at a grid edge the floors differ by one step, so the bar
    is one step of the output grid."""
    x = _frames((4, 256), seed=4)
    xj, xt = _pairs(x)
    cfg_j = R.LogMagConfig(use_lut_log=True)
    want = np.asarray(logmag_jax(xj, jnp.int32(3), cfg_j))
    got = logmag(xt, 3, T.LogMagConfig(use_lut_log=True)).numpy()
    assert np.abs(got - want).max() <= 2.0 ** -cfg_j.bin_point_log
    assert np.mean(got == want) > 0.99


CFAR_J = R.CfarConfig(max_ref_window=64, max_guard_window=8,
                      variant=R.CfarVariant.CA, include_cash=False)


def _check_cfar(rt_j, seed=0, shape=(4, 256), cfg_j=CFAR_J, **active):
    mag = np.array(logmag_jax(R.as_pair(_frames(shape, seed).astype(
        np.complex64)), rt_j.mag_mode))
    want = cfar_jax(jnp.asarray(mag), rt_j, cfg_j,
                    **{k: jnp.int32(v) for k, v in active.items()})
    got = cfar_op(torch.from_numpy(mag), runtime_from_reference(rt_j.peek()),
                  chain_config_from_reference(R.ChainConfig(cfar=cfg_j)).cfar,
                  **active)
    assert _rel(got.threshold.numpy(), want.threshold) < REL
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))
    return got, mag


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("w,g", [(32, 4), (16, 2), (64, 8), (2, 1)])
def test_cfar_op_matches_jax(mode, w, g):
    _check_cfar(R.RuntimeConfig.make(fft_size=256, cfar_mode=mode,
                                     ref_window_size=w, guard_window_size=g,
                                     threshold_scaler=3.5))


def test_cfar_op_peak_grouping_matches_jax():
    out, _ = _check_cfar(R.RuntimeConfig.make(fft_size=256, ref_window_size=16,
                                              guard_window_size=2,
                                              peak_grouping=1))
    assert out.peaks.any()


def test_cfar_op_log_mode_matches_jax():
    _check_cfar(R.RuntimeConfig.make(fft_size=256, mag_mode=3,
                                     log_or_linear=0, threshold_scaler=2.0,
                                     ref_window_size=16, guard_window_size=2))


@pytest.mark.parametrize("cfar_fft_size", [128, 200])
def test_cfar_op_shrunken_active_range_matches_jax(cfar_fft_size):
    out, _ = _check_cfar(R.RuntimeConfig.make(fft_size=256,
                                              cfar_fft_size=cfar_fft_size,
                                              ref_window_size=16,
                                              guard_window_size=2,
                                              peak_grouping=1))
    assert not out.threshold[..., cfar_fft_size:].any()
    assert not out.peaks[..., cfar_fft_size:].any()


def test_cfar_op_explicit_active_bounds_match_jax():
    _check_cfar(R.RuntimeConfig.make(fft_size=256, ref_window_size=8,
                                     guard_window_size=2, peak_grouping=1),
                active_lo=17, active_hi=230)


def test_cfar_op_clamps_windows_to_elaborated_maxima_like_jax():
    # guard 12 > max_guard 8: both packages clamp to 8
    _check_cfar(R.RuntimeConfig.make(fft_size=256, ref_window_size=32,
                                     guard_window_size=12))


def _cfar_cfg(variant="GOSCA", cash=True, edge="PARTIAL", wmax=64, gmax=8):
    return R.CfarConfig(max_ref_window=wmax, max_guard_window=gmax,
                        variant=R.CfarVariant[variant], include_cash=cash,
                        edge_policy=R.EdgePolicy[edge])


def _raw(rt_j, **writes):
    """Registers written raw, past ``make()``'s rules, as a register write on
    a running chain can write them."""
    return dataclasses.replace(
        rt_j, **{k: jnp.asarray(v, jnp.int32) for k, v in writes.items()})


def _golden(mag, rt_j, cfg_j):
    """``cfar_golden`` at the registers as the elaboration resolves them: the
    algorithm register is read only by GOSCA, CASH mode only where CASH is
    elaborated, the sub-window clamped to [min_sub_window, max_ref_window]."""
    r = {k: np.asarray(v).item() for k, v in rt_j.peek().items()}
    mode = min(max(r["cfar_mode"], 0), 3)
    if mode == 3 and not cfg_j.include_cash:
        mode = 0
    if cfg_j.variant is R.CfarVariant.GOSCA:
        algorithm = int(r["cfar_algorithm"] == 1)
    else:
        algorithm = int(cfg_j.variant is R.CfarVariant.GOS)
    return cfar_golden(
        mag, ref_window=r["ref_window_size"], guard_window=r["guard_window_size"],
        threshold_scaler=r["threshold_scaler"], mode=mode, algorithm=algorithm,
        div_sum=r["div_sum"], index_lagg=r["index_lagg"],
        index_lead=r["index_lead"],
        sub_window=min(max(r["sub_window_size"], cfg_j.min_sub_window),
                       cfg_j.max_ref_window),
        log_or_linear=r["log_or_linear"], peak_grouping=r["peak_grouping"],
        edge_policy=cfg_j.edge_policy.value)


# (elaboration, registers, raw register writes): modes x algorithm x ranks
# (clamped ones too) x CASH sub-windows x edge policies
GOS_CASES = [
    ({}, dict(cfar_algorithm=1, ref_window_size=16, guard_window_size=2,
              index_lagg=5, index_lead=5), {}),
    ({}, dict(cfar_algorithm=1, cfar_mode=1, index_lagg=8, index_lead=24), {}),
    ({}, dict(cfar_algorithm=1, cfar_mode=2, ref_window_size=8,
              guard_window_size=2, index_lagg=0, index_lead=0), {}),
    ({}, dict(cfar_algorithm=1, ref_window_size=16, guard_window_size=2),
     dict(index_lagg=40, index_lead=63)),             # ranks >= the window
    ({}, dict(cfar_algorithm=1, ref_window_size=64, guard_window_size=8,
              index_lagg=60, index_lead=3), {}),
    ({}, dict(cfar_algorithm=1, mag_mode=3, log_or_linear=0,
              threshold_scaler=2.0, ref_window_size=16, guard_window_size=2,
              peak_grouping=1), {}),
    ({}, dict(cfar_algorithm=0, cfar_mode=1, ref_window_size=16,
              guard_window_size=2), {}),                # CA in GOSCA
    ({}, dict(cfar_mode=3, ref_window_size=16, guard_window_size=2,
              sub_window_size=4), {}),
    ({}, dict(cfar_mode=3, cfar_algorithm=1, ref_window_size=64,
              guard_window_size=8, sub_window_size=2), {}),
    ({}, dict(cfar_mode=3, ref_window_size=8, guard_window_size=2,
              sub_window_size=4), dict(sub_window_size=16)),  # sub_w > w
    (dict(cash=False), dict(cfar_mode=3, ref_window_size=16,
                            guard_window_size=2), {}),   # CASH -> CA
    (dict(cash=False), dict(cfar_mode=3, cfar_algorithm=1,
                            ref_window_size=16, guard_window_size=2), {}),
    (dict(variant="GOS", cash=False), dict(cfar_mode=1, ref_window_size=16,
                                           guard_window_size=2), {}),
    (dict(variant="GOS"), dict(cfar_mode=3, ref_window_size=16,
                               guard_window_size=2, sub_window_size=8), {}),
    (dict(variant="CA"), dict(cfar_mode=3, ref_window_size=16,
                              guard_window_size=2, sub_window_size=4), {}),
    (dict(variant="CA"), dict(cfar_mode=2, ref_window_size=16,
                              guard_window_size=2), {}),
    (dict(variant="CA", cash=False, edge="WRAP"), dict(ref_window_size=16,
                                                       guard_window_size=2), {}),
    (dict(variant="CA", cash=False, edge="REFLECT"),
     dict(cfar_mode=1, ref_window_size=32, guard_window_size=4), {}),
    (dict(edge="WRAP"), dict(cfar_algorithm=1, cfar_mode=2,
                             ref_window_size=16, guard_window_size=2), {}),
    (dict(edge="REFLECT"), dict(cfar_mode=3, ref_window_size=16,
                                guard_window_size=2, sub_window_size=4), {}),
    (dict(edge="REFLECT"), dict(cfar_algorithm=1, ref_window_size=64,
                                guard_window_size=8, index_lagg=20,
                                index_lead=50, peak_grouping=1), {}),
]


@pytest.mark.parametrize("elab, regs, raw", GOS_CASES)
def test_cfar_op_gos_cash_edges_match_jax_and_golden(elab, regs, raw):
    cfg_j = _cfar_cfg(**elab)
    rt_j = _raw(R.RuntimeConfig.make(**{"fft_size": 256, **regs}), **raw)
    got, mag = _check_cfar(rt_j, cfg_j=cfg_j)
    thr_g, pk_g = _golden(mag, rt_j, cfg_j)
    assert _rel(got.threshold.numpy(), thr_g) < REL
    np.testing.assert_array_equal(got.peaks.numpy(), pk_g)


@pytest.mark.parametrize("regs", [
    dict(cfar_algorithm=1, cfar_fft_size=200, peak_grouping=1),
    dict(cfar_algorithm=1, cfar_mode=2, cfar_fft_size=130),
    dict(cfar_mode=3, sub_window_size=4, cfar_fft_size=200),
])
def test_cfar_op_gos_shrunken_active_range_matches_jax(regs):
    out, _ = _check_cfar(R.RuntimeConfig.make(
        **{"fft_size": 256, "ref_window_size": 16, "guard_window_size": 2,
           **regs}), cfg_j=_cfar_cfg())
    hi = regs["cfar_fft_size"]
    assert not out.threshold[..., hi:].any()
    assert not out.peaks[..., hi:].any()


@pytest.mark.parametrize("regs", [
    dict(cfar_algorithm=1, index_lagg=3, index_lead=12, peak_grouping=1),
    dict(cfar_mode=3, sub_window_size=4),
])
def test_cfar_op_gos_explicit_active_bounds_match_jax(regs):
    _check_cfar(R.RuntimeConfig.make(**{"fft_size": 256, "ref_window_size": 16,
                                        "guard_window_size": 2, **regs}),
                cfg_j=_cfar_cfg(), active_lo=17, active_hi=230)


def test_cfar_op_pure_gos_ignores_the_algorithm_register():
    """A pure-GOS elaboration has no CA datapath, so the algorithm register's
    default 0 still gives order statistics: the port follows JAX ``cfar_op``
    and the golden model with ``algorithm=1`` (the JAX package's float Pallas
    GOS kernels read the register and give CA statistics here)."""
    cfg_j = _cfar_cfg(variant="GOS", cash=False, wmax=16, gmax=4)
    regs = dict(fft_size=256, ref_window_size=8, guard_window_size=2,
                index_lagg=6, index_lead=6, threshold_scaler=3.0)
    rt_j = R.RuntimeConfig.make(cfar_algorithm=0, **regs)
    got, mag = _check_cfar(rt_j, shape=(2, 256), cfg_j=cfg_j)
    thr_g, pk_g = cfar_golden(mag, ref_window=8, guard_window=2,
                              threshold_scaler=3.0, algorithm=1,
                              index_lagg=6, index_lead=6)
    assert _rel(got.threshold.numpy(), thr_g) < REL
    np.testing.assert_array_equal(got.peaks.numpy(), pk_g)
    gos, _ = _check_cfar(R.RuntimeConfig.make(cfar_algorithm=1, **regs),
                         shape=(2, 256), cfg_j=cfg_j)
    assert torch.equal(got.threshold, gos.threshold)


def test_cfar_op_emits_noise_and_cut_when_elaborated():
    cfg = T.CfarConfig(variant=T.CfarVariant.CA, include_cash=False,
                       emit_noise=True, send_cut=True)
    mag = torch.rand(2, 256)
    out = cfar_op(mag, T.RuntimeConfig.make(fft_size=256), cfg)
    assert out.noise.shape == mag.shape and torch.equal(out.cut, mag)
    torch.testing.assert_close(out.threshold, out.noise * 3.5)
