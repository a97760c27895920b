"""The PyTorch port's bit-true integer pipeline against the JAX package's,
exactly: ``ops.bit_true`` op by op (and against the numpy goldens of
``rsp_chains_tpu.golden.int_models`` where they cover the op), the plain
versions of Kernels F and G against the JAX integer kernels in interpret
mode, the bit-true chain stage's routes, and the bit-true presets.

Bar: every integer equal, every peak equal. Inputs are seeded numpy arrays
of 16-bit integers, N = 256, at most 8 frames; beyond the one-launch
routes' bound (N = 16384), N = 32768 and 65536, two frames. (The test
names' "frame-per-block bound" is that bound, N = 16384.)"""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.cplx import C as JC
from rsp_chains_tpu.golden import int_models as G
from rsp_chains_tpu.kernels import int_chain_pallas as JK
from rsp_chains_tpu.ops import bit_true as JB

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.convert import (
    chain_config_from_reference, runtime_from_reference,
)
from rsp_chains_tpu_torch.kernels import int_chain as TK
from rsp_chains_tpu_torch.ops import bit_true as TB

N = 256
BIT_TRUE = R.FixedPointConfig(enabled=True, width=16, bin_point=0,
                              bit_true=True)
CA = R.CfarConfig(max_ref_window=32, max_guard_window=8,
                  variant=R.CfarVariant.CA, include_cash=False)
GOSCA = R.CfarConfig(max_ref_window=16, max_guard_window=4,
                     variant=R.CfarVariant.GOSCA, include_cash=True,
                     max_fft_size=N)
W8 = dict(ref_window_size=8, guard_window_size=2, div_sum=3)


def _iq(seed=0, frames=4, n=N, amp=30000):
    rng = np.random.RandomState(seed)
    return (rng.randint(-amp, amp, (frames, n)).astype(np.int32),
            rng.randint(-amp, amp, (frames, n)).astype(np.int32))


def _pair_j(re, im):
    return JC(jnp.asarray(re), jnp.asarray(im))


def _pair_t(re, im):
    return T.C(torch.from_numpy(np.array(re)), torch.from_numpy(np.array(im)))


def _assert_equal(got, want):
    np.testing.assert_array_equal(got.threshold.numpy(),
                                  np.asarray(want.threshold))
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))


# the JAX functions, compiled once per elaboration with the registers traced
_fft_j = jax.jit(JB.fft_int_op, static_argnums=2)
_mag_j = jax.jit(JB.mag_int_op)
_cfar_j = jax.jit(JB.cfar_int, static_argnums=2)


@functools.lru_cache(maxsize=None)
def _chain_j(cfg_j):
    return R.fft_mag_cfar_chain(cfg_j).jit()


def _regs(**kw):
    rt_j = R.RuntimeConfig.make(**{"fft_size": N, **kw})
    return rt_j, runtime_from_reference(rt_j.peek())


# ---- the FFT ----

def test_fixed_point_helpers_match_jax():
    v = np.concatenate([np.arange(-70000, 70000, 997),
                        [2**31 - 1, -2**31, 32767, 32768, -32768, -32769]])
    v = v.astype(np.int32)
    for k in (0, 1, 6, 15):
        np.testing.assert_array_equal(TB.rhu(torch.from_numpy(v), k).numpy(),
                                      np.asarray(JB.rhu(jnp.asarray(v), k)))
    np.testing.assert_array_equal(TB.wrap16(torch.from_numpy(v)).numpy(),
                                  np.asarray(JB.wrap16(jnp.asarray(v))))
    for n in (8, 256, 4096):
        got, want = TB.stage_twiddles(n), JB.stage_twiddles(n)
        for (gr, gi), (wr, wi) in zip(got[0], want[0]):
            np.testing.assert_array_equal(gr, wr)
            np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(got[1], want[1])


FFT_CASES = [
    dict(),
    dict(expand_logic=(1, 0, 1, 0, 0, 0, 0, 0)),
    dict(expand_logic=(1, 1, 1, 1, 1, 1, 1, 0)),          # 7 expanding stages
    dict(keep_msb_or_lsb=(1, 1, 0, 1, 1, 1, 1, 1)),        # a keepLSB stage
    dict(expand_logic=(0, 1, 0, 0, 0, 0, 0, 0),
         keep_msb_or_lsb=(1, 0, 1, 1, 1, 1, 1, 0)),        # mixed
]


@pytest.mark.parametrize("fft, log2n", [(f, None) for f in FFT_CASES]
                         + [(FFT_CASES[2], 6)])
def test_fft_int_op_matches_jax_and_golden(fft, log2n):
    re, im = _iq(1, amp=32768)
    cfg_j = R.FftConfig(max_size=N, **fft)
    cfg_t = chain_config_from_reference(R.ChainConfig(fft=cfg_j)).fft
    lg = None if log2n is None else jnp.int32(log2n)
    want = _fft_j(_pair_j(re, im), lg, cfg_j)
    got = TB.fft_int_op(_pair_t(re, im), log2n, cfg_t)
    assert got.re.dtype == torch.int32
    np.testing.assert_array_equal(got.re.numpy(), np.asarray(want.re))
    np.testing.assert_array_equal(got.im.numpy(), np.asarray(want.im))
    if log2n in (None, 8):
        gr, gi = G.int_fft_golden(re, im, fft.get("expand_logic"),
                                  fft.get("keep_msb_or_lsb"))
        np.testing.assert_array_equal(got.re.numpy(), gr)
        np.testing.assert_array_equal(got.im.numpy(), gi)


def test_more_than_seven_expanding_stages_raise():
    cfg = T.FftConfig(max_size=N, expand_logic=(1,) * 8)
    re, im = _iq(2, frames=1)
    with pytest.raises(ValueError, match="at most 7 expanding"):
        TB.fft_int_op(_pair_t(re, im), None, cfg)
    with pytest.raises(ValueError, match="at most 7 expanding"):
        JB.fft_int_op(_pair_j(re, im), None, R.FftConfig(max_size=N,
                                                         expand_logic=(1,) * 8))


# ---- the magnitudes ----

def _spectra():
    """A plain spectrum and one grown by 7 expanding stages, whose squares
    saturate."""
    re, im = _iq(3, amp=32768)
    plain = _fft_j(_pair_j(re, im), None, R.FftConfig(max_size=N))
    grown = _fft_j(_pair_j(re, im), None, R.FftConfig(
        max_size=N, expand_logic=(1, 1, 1, 1, 1, 1, 1, 0)))
    return [(np.asarray(s.re), np.asarray(s.im)) for s in (plain, grown)]


@pytest.mark.parametrize("mode", [-1, 0, 1, 2, 3, 5])
@pytest.mark.parametrize("grown", [False, True])
def test_mag_int_op_matches_jax_and_golden(mode, grown):
    re, im = _spectra()[int(grown)]
    want = np.asarray(_mag_j(_pair_j(re, im), jnp.int32(mode)))
    got = TB.mag_int_op(_pair_t(re, im), mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if grown and mode < 2:
        # the squares wrap in int32, as XLA's do; the int64 golden saturates
        assert (got.numpy() == 2**31 - 1).any() or mode < 1
        return
    golden = {0: G.int_abs_golden, 1: G.int_sqr_golden, 2: G.int_jpl_golden,
              3: G.int_log2_golden}[min(max(mode, 0), 3)]
    np.testing.assert_array_equal(got.numpy(), golden(re, im))


def test_isqrt_is_exact_on_boundaries():
    vals = [0, 1, 2, 3, 4, 8, 9, 15, 16, 2**31 - 1, 46340**2, 46340**2 - 1,
            46340**2 + 1] + [k * k + d for k in range(1, 3000, 53)
                             for d in (-1, 0, 1)]
    vals += list(np.random.RandomState(0).randint(0, 2**31 - 1, 2000))
    x = torch.tensor(np.asarray(vals, np.int64), dtype=torch.int32)
    np.testing.assert_array_equal(TB._isqrt32(x).numpy(),
                                  [math.isqrt(int(v)) for v in vals])


# ---- the CFAR ----

# (cfar elaboration, registers): every CFAR datapath and the wraparound points
CFAR_CASES = [
    (CA, dict(ref_window_size=16, guard_window_size=3, div_sum=4)),
    (CA, dict(cfar_mode=1, peak_grouping=1)),
    (CA, dict(cfar_mode=2, log_or_linear=0, threshold_scaler=2.0)),
    (CA, dict(threshold_scaler=2.5)),          # round(2.5) = 2, 160 half-even
    (CA, dict(threshold_scaler=3.5, log_or_linear=0)),   # round(3.5) = 4
    (CA, dict(div_sum=40)),                    # >> 40: the sign fill
    (CA, dict(ref_window_size=2, guard_window_size=1, cfar_fft_size=200)),
    (CA, dict(cfar_mode=3)),                   # CASH not elaborated: CA
    (GOSCA, dict(**W8, cfar_algorithm=1, index_lagg=4, index_lead=6)),
    (GOSCA, dict(**W8, cfar_algorithm=1, cfar_mode=1, index_lagg=0, index_lead=0,
                 peak_grouping=1)),
    (GOSCA, dict(**W8, cfar_algorithm=1, cfar_mode=2, index_lagg=7,
                 index_lead=7, cfar_fft_size=100)),
    (GOSCA, dict(**W8, cfar_algorithm=0, cfar_mode=1)),
    (GOSCA, dict(**W8, cfar_mode=3, sub_window_size=4)),
    (GOSCA, dict(**W8, cfar_mode=3, sub_window_size=2, cfar_fft_size=150,
                 cfar_algorithm=1)),
    (dataclasses.replace(GOSCA, variant=R.CfarVariant.GOS,
                         include_cash=False),
     dict(**W8, cfar_algorithm=0, index_lagg=3, index_lead=3)),
    (dataclasses.replace(CA, include_cash=True),
     dict(cfar_mode=3, sub_window_size=3)),
]


def _cfar_pair(cfar_j, regs, mag):
    rt_j, rt_t = _regs(**regs)
    want = _cfar_j(jnp.asarray(mag), rt_j, cfar_j)
    got = TB.cfar_int(torch.from_numpy(mag),
                      rt_t, chain_config_from_reference(
                          R.ChainConfig(cfar=cfar_j)).cfar)
    _assert_equal(got, want)
    return got, rt_j


@pytest.mark.parametrize("cfar_j, regs", CFAR_CASES)
def test_cfar_int_matches_jax_and_golden(cfar_j, regs):
    re, im = _spectra()[0]
    mag = G.int_jpl_golden(re, im).astype(np.int32)
    got, rt_j = _cfar_pair(cfar_j, regs, mag)
    thr = got.threshold.numpy()
    assert thr.dtype == np.int32
    p = rt_j.peek()
    kw = dict(ref_window=p["ref_window_size"],
              guard_window=p["guard_window_size"], div_sum=min(p["div_sum"], 63),
              threshold_scaler=p["threshold_scaler"],
              peak_grouping=p["peak_grouping"],
              log_or_linear=p["log_or_linear"],
              n_active=min(p["cfar_fft_size"], N))
    if cfar_j.variant is R.CfarVariant.CA and not cfar_j.include_cash:
        golden = [G.int_ca_cfar_golden(m, mode=p["cfar_mode"], **kw)
                  for m in mag]
    else:
        algorithm = (1 if cfar_j.variant is R.CfarVariant.GOS
                     else p["cfar_algorithm"])
        mode = p["cfar_mode"] if (p["cfar_mode"] != 3
                                  or cfar_j.include_cash) else 0
        golden = [G.int_gosca_cfar_golden(
            m, wmax=cfar_j.max_ref_window, algorithm=algorithm, mode=mode,
            rank_lagg=p["index_lagg"], rank_lead=p["index_lead"],
            sub_window=min(max(p["sub_window_size"], cfar_j.min_sub_window),
                           cfar_j.max_ref_window), **kw) for m in mag]
    np.testing.assert_array_equal(thr, np.stack([g[0] for g in golden]))
    np.testing.assert_array_equal(got.peaks.numpy(),
                                  np.stack([g[1] for g in golden]))


@pytest.mark.parametrize("cfar_j", [CA, GOSCA])
def test_ca_cfar_int_is_the_ca_datapath_whatever_the_variant(cfar_j):
    re, im = _spectra()[0]
    mag = G.int_jpl_golden(re, im).astype(np.int32)
    rt_j, rt_t = _regs(**W8, cfar_algorithm=1, cfar_mode=3, index_lagg=2)
    want = jax.jit(JB.ca_cfar_int, static_argnums=2)(jnp.asarray(mag), rt_j,
                                                      cfar_j)
    cfg_t = chain_config_from_reference(R.ChainConfig(cfar=cfar_j)).cfar
    _assert_equal(TB.ca_cfar_int(torch.from_numpy(mag), rt_t, cfg_t), want)


# the SQR overflow points: squares of a grown spectrum saturate, and the
# window sums, noise * scaler_q and (lag + lead) >> 1 wrap in int32
@pytest.mark.parametrize("cfar_j, regs", [
    (CA, dict(mag_mode=1, div_sum=0)),
    (CA, dict(mag_mode=1, div_sum=0, cfar_mode=1, threshold_scaler=40.0)),
    (GOSCA, dict(**W8, mag_mode=1, cfar_algorithm=1, index_lagg=7,
                 index_lead=7, threshold_scaler=2.5)),
    (GOSCA, dict(**W8, mag_mode=1, cfar_mode=3, sub_window_size=4)),
])
def test_cfar_int_wraps_as_xla_on_sqr_overflow(cfar_j, regs):
    re, im = _spectra()[1]
    mag = G.int_sqr_golden(re, im).astype(np.int32)
    got, _ = _cfar_pair(cfar_j, regs, mag)
    # the int32 results wrapped (negative thresholds), as XLA's do
    assert (got.threshold.numpy() < 0).any()


@pytest.mark.parametrize("div_sum", [31, 32, 33, 100, -1])
def test_div_sum_outside_the_shift_range_fills_with_the_sign(div_sum):
    re, im = _spectra()[1]
    mag = G.int_sqr_golden(re, im).astype(np.int32)
    rt_j, rt_t = _regs(mag_mode=1)
    rt_j = dataclasses.replace(rt_j, div_sum=jnp.int32(div_sum))
    rt_t = dataclasses.replace(rt_t, div_sum=div_sum)
    cfg_t = chain_config_from_reference(R.ChainConfig(cfar=CA)).cfar
    _assert_equal(TB.cfar_int(torch.from_numpy(mag), rt_t, cfg_t),
                  _cfar_j(jnp.asarray(mag), rt_j, CA))
    assert TB.div_shift(div_sum) == (31 if div_sum >= 31 or div_sum < 0
                                     else div_sum)


def test_scaler_rounds_half_to_even_as_jax():
    for s in (2.5, 3.5, 0.5, 1.0078125, 2.0 + 1 / 128, 7.4921875):
        q, add = TB.int_scaler(s)
        assert q == int(np.asarray(jnp.round(jnp.float32(s) * 64.0)))
        assert add == int(np.asarray(jnp.round(jnp.float32(s))))
    assert TB.int_scaler(2.5) == (160, 2)


# ---- the bit-true chain stage and presets ----

def _int_cfg(cfar, **fft):
    return R.ChainConfig(fft=R.FftConfig(**{"max_size": N, **fft}), cfar=cfar,
                         fixed_point=BIT_TRUE)


# registers and the route ``fused_chain_int_op`` must take, by the JAX
# package's conditions (int_chain_pallas.py:746-779)
ROUTES = [
    (CA, dict(), "chain_int"),
    (CA, dict(mag_mode=0, cfar_mode=2), "chain_int"),
    (CA, dict(mag_mode=3, log_or_linear=0), "ops"),
    (CA, dict(fft_size=128), "ops"),
    (CA, dict(cfar_mode=3), "chain_int"),
    (GOSCA, dict(cfar_algorithm=1, index_lagg=3, index_lead=7), "chain_int_gos"),
    (GOSCA, dict(cfar_algorithm=0, peak_grouping=1), "chain_int"),
    (GOSCA, dict(cfar_mode=3, sub_window_size=4), "ops"),
    (GOSCA, dict(cfar_mode=3, cfar_algorithm=1, sub_window_size=2), "ops"),
    (GOSCA, dict(cfar_algorithm=1, mag_mode=3, log_or_linear=0), "ops"),
    (GOSCA, dict(cfar_algorithm=1, fft_size=64), "ops"),
    (GOSCA, dict(cfar_algorithm=2), "ops"),
]


@pytest.mark.parametrize("cfar_j, regs, route", ROUTES)
def test_bit_true_chain_routes_and_matches_jax(cfar_j, regs, route,
                                               monkeypatch):
    """``fft_mag_cfar_chain`` on a bit-true elaboration: the route each
    register point takes, and the result, equal to the JAX chain on its XLA
    integer composition."""
    taken = []
    for name in ("chain_int", "chain_int_gos", "int_ops_chain"):
        real = getattr(TK, name)

        def spy(*a, _real=real, _name=name, **k):
            taken.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(TK, name, spy)
    cfg_j = _int_cfg(cfar_j)
    chain = T.fft_mag_cfar_chain(chain_config_from_reference(cfg_j))
    assert chain.stage_names == ("fft_mag_cfar_int_fused",)
    assert chain.stage_names == R.fft_mag_cfar_chain(cfg_j).stage_names
    re, im = _iq(7, frames=3)
    rt_j, rt_t = _regs(ref_window_size=8, guard_window_size=2, div_sum=3,
                       **regs)
    got = chain(_pair_t(re, im), rt_t)
    assert taken == [{"ops": "int_ops_chain"}.get(route, route)]
    plain_j = dataclasses.replace(cfg_j, cfar=dataclasses.replace(
        cfar_j, use_pallas=False))
    want = _chain_j(plain_j)(_pair_j(re, im), rt_j)
    _assert_equal(got, want)


def _spy_routes(monkeypatch):
    taken = []
    for name in ("chain_int", "chain_int_gos", "int_ops_chain"):
        real = getattr(TK, name)

        def spy(*a, _real=real, _name=name, **k):
            taken.append(_name)
            return _real(*a, **k)

        monkeypatch.setattr(TK, name, spy)
    return taken


def _big_chain(variant, n):
    cfar = R.CfarConfig(max_ref_window=16, max_guard_window=4,
                        variant=variant, include_cash=True, max_fft_size=n)
    return chain_config_from_reference(_int_cfg(cfar, max_size=n))


GOS_REGS_BIG = dict(cfar_algorithm=1, index_lagg=3, index_lead=7, **W8)


@pytest.mark.parametrize("variant, regs, route", [
    (R.CfarVariant.CA, W8, "chain_int"),
    (R.CfarVariant.GOSCA, GOS_REGS_BIG, "chain_int_gos"),
])
def test_bit_true_chain_takes_the_kernels_at_their_frame_bound(
        variant, regs, route, monkeypatch):
    """At N = 16384, the bound of the one-launch routes (on the card the
    mid-size route of ``csrc/int_mid.cu``, a frame a cluster of two
    blocks), a kernel's register point takes its kernel (here its plain
    version), equal to the integer ops."""
    n = 1 << TK.MAX_LOG2N
    cfg = _big_chain(variant, n)
    taken = _spy_routes(monkeypatch)
    rt = T.RuntimeConfig.make(fft_size=n, **regs)
    x = _pair_t(*_iq(10, frames=1, n=n))
    got = T.fft_mag_cfar_chain(cfg)(x, rt)
    assert taken == [route]
    want = TK.int_ops_chain(x, rt, cfg)
    assert torch.equal(got.threshold, want.threshold)
    assert torch.equal(got.peaks, want.peaks)


# register points beyond the one-launch routes' bound (N = 16384), each with
# the route it must take: (variant, registers, route)
BEYOND = [
    (R.CfarVariant.CA, W8, "chain_int"),
    (R.CfarVariant.CA, dict(W8, cfar_mode=1, peak_grouping=1), "chain_int"),
    (R.CfarVariant.GOSCA, GOS_REGS_BIG, "chain_int_gos"),
    (R.CfarVariant.GOSCA, dict(W8, cfar_algorithm=0, cfar_mode=2),
     "chain_int"),
]


@pytest.mark.parametrize("n", [2 << TK.MAX_LOG2N, 4 << TK.MAX_LOG2N])
@pytest.mark.parametrize("variant, regs, route", BEYOND)
def test_bit_true_chain_beyond_the_frame_per_block_bound_matches_jax(
        n, variant, regs, route, monkeypatch):
    """Frames of N = 32768 and 65536, which JAX's ``int_chain_fusable``
    passes: the port's chain takes the kernel's route (on the card the split
    route of ``csrc/int_split.cu``; here its plain version) and equals the
    JAX chain on its XLA integer composition."""
    cfar_j = R.CfarConfig(max_ref_window=16, max_guard_window=4,
                          variant=variant, include_cash=True, max_fft_size=n)
    cfg_j = _int_cfg(cfar_j, max_size=n)
    assert JK.int_chain_fusable(cfg_j)
    chain = T.fft_mag_cfar_chain(chain_config_from_reference(cfg_j))
    assert chain.stage_names == ("fft_mag_cfar_int_fused",)
    taken = _spy_routes(monkeypatch)
    re, im = _iq(12, frames=2, n=n)
    rt_j, rt_t = _regs(**{**regs, "fft_size": n})
    got = chain(_pair_t(re, im), rt_t)
    assert taken == [route]
    plain_j = dataclasses.replace(cfg_j, cfar=dataclasses.replace(
        cfar_j, use_pallas=False))
    _assert_equal(got, _chain_j(plain_j)(_pair_j(re, im), rt_j))
    assert bool(got.peaks.any())


@pytest.mark.parametrize("name", ["chain_int", "chain_int_gos"])
def test_the_kernels_take_every_power_of_two_frame_jax_passes(name):
    """No power-of-two frame >= 256 that ``int_chain_fusable`` passes is
    refused by the kernels' operand checks (up to the split route's 2^30)."""
    for log2n in range(8, TK.MAX_LOG2N_SPLIT + 1):
        n = 1 << log2n
        cfg = _big_chain(R.CfarVariant.GOSCA, n)
        assert TK.int_chain_fusable(cfg)
        TK._check_operands(name, n, T.RuntimeConfig.make(fft_size=n),
                           cfg.fft, cfg.cfar, name == "chain_int_gos")


def test_integer_ops_routes_run_beyond_the_kernels_frame_bound(monkeypatch):
    n = 2 << TK.MAX_LOG2N
    cfg = _big_chain(R.CfarVariant.CA, n)
    taken = _spy_routes(monkeypatch)
    rt = T.RuntimeConfig.make(fft_size=n, mag_mode=3, log_or_linear=0, **W8)
    out = T.fft_mag_cfar_chain(cfg)(_pair_t(*_iq(11, frames=1, n=n)), rt)
    assert taken == ["int_ops_chain"]
    assert out.threshold.shape == (1, n) and bool(out.peaks.any())


@pytest.mark.parametrize("cfar, fft", [
    (CA, {}),
    (GOSCA, {}),
    (dataclasses.replace(GOSCA, variant=R.CfarVariant.GOS), {}),
    (dataclasses.replace(CA, edge_policy=R.EdgePolicy.WRAP), {}),
    (dataclasses.replace(CA, send_cut=True), {}),
    (dataclasses.replace(CA, use_pallas=False), {}),
    (R.CfarConfig(max_ref_window=128), {}),
    (CA, dict(use_bit_reverse=False)),
    (CA, dict(max_size=128)),
    (CA, dict(expand_logic=(1,) * 8)),
])
def test_bit_true_presets_build_the_jax_stages(cfar, fft):
    cfg_j = _int_cfg(cfar, **fft)
    cfg_t = chain_config_from_reference(cfg_j)
    assert (T.fft_mag_cfar_chain(cfg_t).stage_names
            == R.fft_mag_cfar_chain(cfg_j).stage_names)
    assert (T.rx_fft_mag_cfar_tx_chain(cfg_t).stage_names
            == R.rx_fft_mag_cfar_tx_chain(cfg_j).stage_names)
    assert TK.int_chain_fusable(cfg_t) == JK.int_chain_fusable(cfg_j)


def test_shipped_integer_gosca_builds_the_fused_integer_stage():
    cfg = T.ChainConfig(fixed_point=T.FixedPointConfig(
        enabled=True, width=16, bin_point=0, bit_true=True))
    assert T.fft_mag_cfar_chain(cfg).stage_names == ("fft_mag_cfar_int_fused",)
    assert T.rx_fft_mag_cfar_tx_chain(cfg).stage_names == (
        "rx_unpack", "fft_mag_cfar_int_fused", "tx_pack")


def test_unfused_bit_true_chain_matches_jax():
    """A pure-GOS bit-true elaboration behind a WRAP edge policy: the three
    integer stages (the integer CFAR is PARTIAL whatever the policy)."""
    cfar = dataclasses.replace(GOSCA, variant=R.CfarVariant.GOS,
                               include_cash=False,
                               edge_policy=R.EdgePolicy.WRAP)
    cfg_j = _int_cfg(cfar, runtime_size=False)
    chain = T.fft_mag_cfar_chain(chain_config_from_reference(cfg_j))
    assert chain.stage_names == ("fft_int", "logmag_int", "cfar_int")
    re, im = _iq(8, frames=2)
    rt_j, rt_t = _regs(ref_window_size=8, guard_window_size=2, index_lagg=5,
                       index_lead=2)
    _assert_equal(chain(_pair_t(re, im), rt_t),
                  _chain_j(cfg_j)(_pair_j(re, im), rt_j))


def test_int_ops_chain_chunks_give_the_same_integers(monkeypatch):
    cfg = chain_config_from_reference(_int_cfg(GOSCA))
    re, im = _iq(9, frames=5)
    rt = T.RuntimeConfig.make(fft_size=N, ref_window_size=8,
                              guard_window_size=2, cfar_mode=3,
                              sub_window_size=3)
    whole = TK.int_ops_chain(_pair_t(re, im), rt, cfg)
    monkeypatch.setattr(TK, "OPS_CELLS", 2 * N)
    chunked = TK.int_ops_chain(_pair_t(re, im), rt, cfg)
    assert torch.equal(whole.threshold, chunked.threshold)
    assert torch.equal(whole.peaks, chunked.peaks)
