"""The PyTorch port's plain ops against the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through both. Bar: relative
error max|d| / max|want| < 1e-4, the bench's threshold bar; torch.fft against
the JAX four-step FFT measures ~1e-6. Peaks must be equal."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
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


def _check_cfar(rt_j, seed=0, shape=(4, 256), **active):
    mag = np.array(logmag_jax(R.as_pair(_frames(shape, seed).astype(
        np.complex64)), rt_j.mag_mode))
    want = cfar_jax(jnp.asarray(mag), rt_j, CFAR_J,
                    **{k: jnp.int32(v) for k, v in active.items()})
    got = cfar_op(torch.from_numpy(mag), runtime_from_reference(rt_j.peek()),
                  chain_config_from_reference(R.ChainConfig(cfar=CFAR_J)).cfar,
                  **active)
    assert _rel(got.threshold.numpy(), want.threshold) < REL
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))
    return got


@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("w,g", [(32, 4), (16, 2), (64, 8), (2, 1)])
def test_cfar_op_matches_jax(mode, w, g):
    _check_cfar(R.RuntimeConfig.make(fft_size=256, cfar_mode=mode,
                                     ref_window_size=w, guard_window_size=g,
                                     threshold_scaler=3.5))


def test_cfar_op_peak_grouping_matches_jax():
    out = _check_cfar(R.RuntimeConfig.make(fft_size=256, ref_window_size=16,
                                           guard_window_size=2,
                                           peak_grouping=1))
    assert out.peaks.any()


def test_cfar_op_log_mode_matches_jax():
    _check_cfar(R.RuntimeConfig.make(fft_size=256, mag_mode=3,
                                     log_or_linear=0, threshold_scaler=2.0,
                                     ref_window_size=16, guard_window_size=2))


@pytest.mark.parametrize("cfar_fft_size", [128, 200])
def test_cfar_op_shrunken_active_range_matches_jax(cfar_fft_size):
    out = _check_cfar(R.RuntimeConfig.make(fft_size=256,
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


@pytest.mark.parametrize("cfg", [
    T.CfarConfig(variant=T.CfarVariant.GOS, include_cash=False),
    T.CfarConfig(variant=T.CfarVariant.GOSCA),
    T.CfarConfig(variant=T.CfarVariant.CA, include_cash=True),
    T.CfarConfig(variant=T.CfarVariant.CA, include_cash=False,
                 edge_policy=T.EdgePolicy.WRAP),
    T.CfarConfig(variant=T.CfarVariant.CA, include_cash=False,
                 edge_policy=T.EdgePolicy.REFLECT),
])
def test_cfar_op_refuses_what_is_not_ported(cfg):
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 4"):
        cfar_op(torch.zeros(2, 256), T.RuntimeConfig.make(fft_size=256), cfg)


def test_cfar_op_emits_noise_and_cut_when_elaborated():
    cfg = T.CfarConfig(variant=T.CfarVariant.CA, include_cash=False,
                       emit_noise=True, send_cut=True)
    mag = torch.rand(2, 256)
    out = cfar_op(mag, T.RuntimeConfig.make(fft_size=256), cfg)
    assert out.noise.shape == mag.shape and torch.equal(out.cut, mag)
    torch.testing.assert_close(out.threshold, out.noise * 3.5)
