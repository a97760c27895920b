"""The port's 2-D map detector against the JAX package on the CPU:
``cfar_2d_op`` (CA and OS) against JAX ``cfar_2d_op`` and the index-wise
numpy golden ``cfar_2d_golden``, the register records, Kernel J's plain
version against the JAX ``fused_rd_2d_chain`` (Pallas in interpret mode, as
the JAX package's own tests run it), and ``rd_2d_cfar_chain`` on its fused
and composed routes. The CUDA kernel itself is checked on the card by
tests/test_torch_cuda.py.

Same seeded numpy inputs through both packages, maps of 8 x 32 and CPIs of
P = 16, N = 256. Bar: threshold max|dthr| / max|thr| < 1e-4, and peaks equal
except at cells with |mag - thr| / max|thr| < 1e-4, where the two FFT
formulations (~1e-6 relative) may fall on either side of the threshold; on a
map given to both detectors the peaks are equal."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.golden import cfar_2d_golden
from rsp_chains_tpu.kernels.rd_pallas import fused_rd_2d_chain as rd_2d_jax
from rsp_chains_tpu.kernels.rd_pallas import fused_rd_chain as fused_rd_jax
from rsp_chains_tpu.ops.cfar_2d import (
    Cfar2dConfig as JCfg, Cfar2dRuntime as JRt, cfar_2d_op as cfar_2d_jax,
    rd_2d_cfar_chain as rd_2d_chain_jax,
)

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.convert import (
    cfar2d_config_from_reference, cfar2d_runtime_from_reference,
    chain_config_from_reference, runtime_from_reference,
)
from rsp_chains_tpu_torch.kernels import _build
from rsp_chains_tpu_torch.kernels import rd as krd
from rsp_chains_tpu_torch.ops.doppler import doppler_fft
from rsp_chains_tpu_torch.ops.logmag import logmag
from rsp_chains_tpu_torch.ops.matched_filter import (
    matched_filter, matched_filter_os,
)

REL = 1e-4
P, N = 16, 256
TAPS = R.golden.lfm_chirp(32, 0.0, 0.25)
CFG2 = dict(max_ref_range=6, max_guard_range=2, max_ref_doppler=4,
            max_guard_doppler=2)    # an OS stack of 220 (<= 256)


def _cfg2(include_os=False, **kw):
    c = JCfg(**{**CFG2, **kw}, include_os=include_os)
    return c, cfar2d_config_from_reference(c)


def _rt2(**kw):
    regs = dict(ref_range=4, guard_range=1, ref_doppler=2, guard_doppler=1,
                threshold_scaler=3.0)
    regs.update(kw)
    rt_j = JRt.make(**regs)
    return rt_j, cfar2d_runtime_from_reference(rt_j)


def _map(shape=(8, 32), seed=0):
    rng = np.random.RandomState(seed)
    m = np.abs(rng.randn(*shape)).astype(np.float32)
    m[..., 3, 11] *= 30
    m[..., 6, 27] *= 12
    return m


def _golden(m, rt2, active_range=None):
    return cfar_2d_golden(
        m, ref_range=rt2.ref_range, guard_range=rt2.guard_range,
        ref_doppler=rt2.ref_doppler, guard_doppler=rt2.guard_doppler,
        threshold_scaler=rt2.threshold_scaler,
        log_or_linear=rt2.log_or_linear, peak_grouping=rt2.peak_grouping,
        active_range=active_range, algorithm=rt2.algorithm,
        os_rank=rt2.os_rank)


def _assert_cfar_close(got, want, mag):
    thr_w = np.asarray(want.threshold)
    scale = np.abs(thr_w).max()
    assert got.threshold.shape == thr_w.shape
    assert np.abs(got.threshold.numpy() - thr_w).max() / scale < REL
    assert got.peaks.dtype == torch.bool
    diff = got.peaks.numpy() != np.asarray(want.peaks)
    near = np.abs(np.asarray(mag) - thr_w) / scale < REL
    assert not (diff & ~near).any(), int((diff & ~near).sum())


# ---- the records ----

def test_records_mirror_jax():
    assert [f.name for f in dataclasses.fields(T.Cfar2dConfig)] == [
        f.name for f in dataclasses.fields(JCfg)]
    assert [f.name for f in dataclasses.fields(T.Cfar2dRuntime)] == [
        f.name for f in dataclasses.fields(JRt)]
    assert T.Cfar2dConfig() == cfar2d_config_from_reference(JCfg())
    for kw in [dict(), CFG2, dict(CFG2, include_os=True)]:
        assert (T.Cfar2dConfig(**kw).os_stack
                == JCfg(**kw).os_stack)
    rt_j, rt_t = _rt2(threshold_scaler=0.1, peak_grouping=1,
                      active_range=200, algorithm=1, os_rank=5)
    assert rt_t == T.Cfar2dRuntime.make(
        ref_range=4, guard_range=1, ref_doppler=2, guard_doppler=1,
        threshold_scaler=0.1, peak_grouping=1, active_range=200, algorithm=1,
        os_rank=5)
    assert rt_t.threshold_scaler == float(np.asarray(rt_j.threshold_scaler))


@pytest.mark.parametrize("kw, match", [
    (dict(ref_range=0), "reference extents"),
    (dict(guard_doppler=-1), "guard extents"),
    (dict(algorithm=2), "algorithm"),
    (dict(os_rank=-1), "os_rank"),
    (dict(ref_range=7, validate=True), "maxima"),
    (dict(algorithm=1, validate=True), "include_os"),
    (dict(algorithm=1, os_rank=1000, validate="os"), "annulus"),
])
def test_runtime_make_refuses_as_jax_does(kw, match):
    validate = kw.pop("validate", None)
    regs = dict(ref_range=4, guard_range=1, ref_doppler=2, guard_doppler=1,
                threshold_scaler=3.0)
    regs.update(kw)
    if validate is not None:
        cj, ct = _cfg2(include_os=validate == "os")
        regs_j, regs_t = dict(regs, validate_against=cj), dict(
            regs, validate_against=ct)
    else:
        regs_j = regs_t = regs
    with pytest.raises(ValueError, match=match):
        JRt.make(**regs_j)
    with pytest.raises(ValueError, match=match):
        T.Cfar2dRuntime.make(**regs_t)


def test_config_refuses_a_large_os_stack():
    with pytest.raises(ValueError, match="stack"):
        JCfg(include_os=True)
    with pytest.raises(ValueError, match="stack"):
        T.Cfar2dConfig(include_os=True)
    with pytest.raises(ValueError):
        T.Cfar2dConfig(max_ref_range=0)


# ---- cfar_2d_op against JAX and the golden ----

CA_REGS = [
    dict(),
    dict(ref_range=6, guard_range=2, ref_doppler=4, guard_doppler=2),
    dict(ref_range=1, guard_range=0, ref_doppler=1, guard_doppler=0),
    dict(log_or_linear=0, threshold_scaler=1.5),
    dict(peak_grouping=1),
    dict(active_range=20, peak_grouping=1),
]


@pytest.mark.parametrize("regs", CA_REGS)
def test_cfar_2d_op_ca_matches_jax_and_golden(regs):
    cj, ct = _cfg2()
    rt_j, rt_t = _rt2(**regs)
    m = _map()
    got = T.cfar_2d_op(torch.from_numpy(m), rt_t, ct)
    want = cfar_2d_jax(jnp.asarray(m), rt_j, cj)
    np.testing.assert_allclose(got.threshold.numpy(),
                               np.asarray(want.threshold), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))
    thr_g, pk_g = _golden(m, rt_t, regs.get("active_range"))
    np.testing.assert_allclose(got.threshold.numpy(), thr_g, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got.peaks.numpy(), pk_g)


@pytest.mark.parametrize("regs", [
    dict(algorithm=1, os_rank=0),
    dict(algorithm=1, os_rank=7, peak_grouping=1),
    dict(algorithm=1, os_rank=40, active_range=24),
    dict(algorithm=1, os_rank=3, ref_range=1, guard_range=0, ref_doppler=1,
         guard_doppler=0, log_or_linear=0, threshold_scaler=0.5),
    dict(algorithm=0),          # CA on an include_os elaboration
])
def test_cfar_2d_op_os_matches_jax_and_golden(regs):
    cj, ct = _cfg2(include_os=True, max_ref_range=4, max_guard_range=1,
                   max_ref_doppler=2, max_guard_doppler=1)
    rt_j, rt_t = _rt2(**regs)
    m = _map((2, 8, 32), seed=1)
    got = T.cfar_2d_op(torch.from_numpy(m), rt_t, ct)
    want = cfar_2d_jax(jnp.asarray(m), rt_j, cj)
    np.testing.assert_allclose(got.threshold.numpy(),
                               np.asarray(want.threshold), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))
    for i in range(m.shape[0]):
        thr_g, pk_g = _golden(m[i], rt_t, regs.get("active_range"))
        np.testing.assert_allclose(got.threshold[i].numpy(), thr_g,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_array_equal(got.peaks[i].numpy(), pk_g)


def test_os_register_is_inert_without_the_os_body():
    cj, ct = _cfg2()
    rt_j, rt_t = _rt2()
    rt_t = dataclasses.replace(rt_t, algorithm=1, os_rank=3)
    rt_j = dataclasses.replace(rt_j, algorithm=jnp.int32(1),
                               os_rank=jnp.int32(3))
    m = _map(seed=2)
    got = T.cfar_2d_op(torch.from_numpy(m), rt_t, ct)
    want = cfar_2d_jax(jnp.asarray(m), rt_j, cj)
    np.testing.assert_allclose(got.threshold.numpy(),
                               np.asarray(want.threshold), rtol=1e-5,
                               atol=1e-6)
    ca = T.cfar_2d_op(torch.from_numpy(m), dataclasses.replace(
        rt_t, algorithm=0), ct)
    assert torch.equal(got.threshold, ca.threshold)


def test_cfar_2d_op_clamps_raw_register_writes():
    cj, ct = _cfg2()
    rt_j, rt_t = _rt2()
    raw = dict(ref_range=40, guard_range=-2, ref_doppler=0, guard_doppler=9)
    rt_t = dataclasses.replace(rt_t, **raw)
    rt_j = dataclasses.replace(rt_j, **{k: jnp.int32(v)
                                        for k, v in raw.items()})
    m = _map(seed=3)
    got = T.cfar_2d_op(torch.from_numpy(m), rt_t, ct)
    want = cfar_2d_jax(jnp.asarray(m), rt_j, cj)
    np.testing.assert_allclose(got.threshold.numpy(),
                               np.asarray(want.threshold), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))


# ---- Kernel J's plain version against the JAX kernel ----

def _cfgs(method="freq", use_pallas=True, mf=True):
    cfg_j = R.ChainConfig(
        fft=R.FftConfig(max_size=N),
        matched_filter=(R.MatchedFilterConfig(num_taps=len(TAPS), fft_size=N,
                                              method=method) if mf else None),
        doppler=R.DopplerConfig(num_pulses=P, window="hann"),
        cfar=R.CfarConfig(max_ref_window=16, max_guard_window=4,
                          max_fft_size=N, variant=R.CfarVariant.CA,
                          include_cash=False, use_pallas=use_pallas))
    return cfg_j, chain_config_from_reference(cfg_j)


def _rts(**kw):
    rt_j = R.RuntimeConfig.make(**{"fft_size": N, **kw})
    return rt_j, runtime_from_reference(rt_j.peek())


def _cpi(shape=(2, P, N), seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) + 1j * rng.randn(*shape)) * 0.5
    x[..., 40:72] += 4 * TAPS * np.exp(0.7j * np.arange(shape[-2]))[:, None]
    x[..., 5, 100] += 6.0 - 2.0j
    return x.astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _jax_rd_2d(cfg_j, c2j):
    """The JAX ``fused_rd_2d_chain``, jitted once per elaboration (registers
    are traced)."""
    return jax.jit(lambda x, rt, rt2: rd_2d_jax(x, rt, rt2, TAPS, cfg_j, c2j,
                                                interpret=True))


@functools.lru_cache(maxsize=None)
def _jax_2d_chain(cfg_j, c2j, with_taps):
    return jax.jit(rd_2d_chain_jax(cfg_j, taps=TAPS if with_taps else None,
                                   cfg2d=c2j))


def _mag(x, rt_t, cfg_t):
    return logmag(krd.rd_front_reference(T.as_pair(x), TAPS, cfg_t),
                  rt_t.mag_mode).numpy()


RD2_REGS = [
    (dict(), dict()),
    (dict(mag_mode=0), dict(peak_grouping=1)),
    (dict(), dict(ref_range=6, guard_range=2, ref_doppler=4,
                  guard_doppler=2, active_range=200)),
    (dict(mag_mode=3), dict(log_or_linear=0, threshold_scaler=2.0,
                            ref_range=1, guard_range=0, ref_doppler=1,
                            guard_doppler=0)),
]


@pytest.mark.parametrize("regs, regs2", RD2_REGS)
def test_fused_rd_2d_chain_reference_matches_pallas(regs, regs2):
    cfg_j, cfg_t = _cfgs()
    c2j, c2t = _cfg2()
    rt_j, rt_t = _rts(**regs)
    r2j, r2t = _rt2(**regs2)
    x = _cpi()
    before = dict(_build.LAUNCHES)
    got = krd.fused_rd_2d_chain(T.as_pair(x), rt_t, r2t, TAPS, cfg_t, c2t)
    assert dict(_build.LAUNCHES) == before     # a CPU tensor: the plain path
    want = _jax_rd_2d(cfg_j, c2j)(R.as_pair(x), rt_j, r2j)
    _assert_cfar_close(got, want, _mag(x, rt_t, cfg_t))


def test_fused_rd_2d_chain_refuses_what_the_kernel_does_not_compute():
    _, cfg_t = _cfgs()
    _, os_cfg = _cfgs(method="overlap_save")
    _, rt_t = _rts()
    _, r2t = _rt2()
    _, c2t = _cfg2()
    x = T.as_pair(_cpi())
    with pytest.raises(ValueError, match="num_pulses"):
        krd.fused_rd_2d_chain(T.C(x.re[:, :8], x.im[:, :8]), rt_t, r2t, TAPS,
                              cfg_t, c2t)
    with pytest.raises(ValueError, match="overlap_save"):
        krd.fused_rd_2d_chain(x, rt_t, r2t, TAPS, os_cfg, c2t)
    with pytest.raises(ValueError, match="margin"):
        krd.fused_rd_2d_chain(x, rt_t, r2t, TAPS, cfg_t,
                              T.Cfar2dConfig(max_ref_range=60,
                                             max_guard_range=4))
    _, os2 = _cfg2(include_os=True, max_ref_range=4, max_guard_range=1,
                   max_ref_doppler=2, max_guard_doppler=1)
    with pytest.raises(ValueError, match="OS body"):
        krd.fused_rd_2d_chain(x, rt_t, r2t, TAPS, cfg_t, os2)


# ---- rd_2d_cfar_chain ----

@pytest.mark.parametrize("route, cfgs, cfg2_kw, fused, fusable", [
    ("fused (Kernel J)", dict(), dict(), True, True),
    ("map kernel + OS op", dict(), dict(include_os=True, max_ref_range=4,
                                        max_guard_range=1, max_ref_doppler=2,
                                        max_guard_doppler=1), False, True),
    ("composed, plain tail", dict(use_pallas=False), dict(), False, False),
    ("composed, overlap-save", dict(method="overlap_save"), dict(), False,
     False),
    ("no matched filter", dict(mf=False), dict(), False, False),
])
@pytest.mark.parametrize("regs2", [dict(peak_grouping=1),
                                   dict(algorithm=1, os_rank=4,
                                        active_range=180)])
def test_rd_2d_cfar_chain_matches_jax(route, cfgs, cfg2_kw, fused, fusable,
                                      regs2):
    cfg_j, cfg_t = _cfgs(**cfgs)
    c2j, c2t = _cfg2(**cfg2_kw)
    if regs2.get("algorithm") == 1 and not c2t.include_os:
        regs2 = dict(regs2, algorithm=0)
    taps = TAPS if cfg_t.matched_filter is not None else None
    run_t = T.rd_2d_cfar_chain(cfg_t, taps=taps, cfg2d=c2t, device="cpu")
    assert (run_t.fully_fusable, run_t.fusable) == (fused, fusable)
    rt_j, rt_t = _rts()
    r2j, r2t = _rt2(**regs2)
    x = _cpi(seed=4)
    got = run_t(x, rt_t, r2t)              # numpy in: to the chain's device
    want = _jax_2d_chain(cfg_j, c2j, taps is not None)(R.as_pair(x), rt_j,
                                                       r2j)
    if fusable and not fused and r2t.algorithm == 1:
        # An order statistic is one cell of the map, and the Pallas map's
        # split-bf16 products err by ~1e-5 of the map's peak, well above the
        # noise cells' own rounding. So the route's map is held against the
        # Pallas map at the map bar, and the whole route against the JAX
        # package's fp32 XLA composition of the same function.
        map_t = krd.fused_rd_chain(T.as_pair(x), rt_t, TAPS, cfg_t, emit="map")
        map_j = fused_rd_jax(R.as_pair(x), rt_j, TAPS, cfg_j, interpret=True,
                             emit="map")
        err = max(np.abs(map_t.re.numpy() - np.asarray(map_j.re)).max(),
                  np.abs(map_t.im.numpy() - np.asarray(map_j.im)).max())
        assert err / np.abs(np.asarray(map_j.re)).max() < REL
        xla_j, _ = _cfgs(use_pallas=False)
        want = _jax_2d_chain(xla_j, c2j, True)(R.as_pair(x), rt_j, r2j)
    y = T.as_pair(x)
    if cfg_t.matched_filter is not None:
        y = matched_filter_os(y, TAPS, cfg_t.matched_filter) if cfgs.get(
            "method") == "overlap_save" else matched_filter(
            y, TAPS, cfg_t.matched_filter)
    mag = logmag(doppler_fft(y, cfg_t.doppler), rt_t.mag_mode).numpy()
    _assert_cfar_close(got, want, mag)


@pytest.mark.parametrize("regs2", [
    dict(ref_doppler=52, guard_doppler=8, peak_grouping=1),
    dict(ref_doppler=7, guard_doppler=3, active_range=200),
])
def test_rd_2d_cfar_chain_fuses_any_doppler_reach(regs2):
    # a Doppler reach of 60 rows each side, past the CPI's 16 pulses: the
    # fused route takes it as the JAX package does
    cfg_j, cfg_t = _cfgs()
    c2j, c2t = _cfg2(max_ref_doppler=52, max_guard_doppler=8)
    run_t = T.rd_2d_cfar_chain(cfg_t, taps=TAPS, cfg2d=c2t, device="cpu")
    assert run_t.fully_fusable
    rt_j, rt_t = _rts()
    r2j, r2t = _rt2(**regs2)
    x = _cpi(seed=5)
    got = run_t(x, rt_t, r2t)
    want = _jax_2d_chain(cfg_j, c2j, True)(R.as_pair(x), rt_j, r2j)
    _assert_cfar_close(got, want, _mag(x, rt_t, cfg_t))


def test_rd_2d_cfar_chain_refuses_orphan_taps():
    _, cfg_t = _cfgs(mf=False)
    with pytest.raises(ValueError, match="taps given"):
        T.rd_2d_cfar_chain(cfg_t, taps=TAPS)
