"""The PyTorch port's own copies of the numpy goldens (``golden.models``,
``golden.int_models``) against the JAX package's, bit for bit on the same
seeded inputs, two shapes or settings a function; the port's ``ifft_op``
against the JAX ``ifft_op`` (pair and complex, with and without ``n``) within
1e-5 of the largest magnitude; ``is_pair`` against the JAX one."""

import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.golden import int_models as j_int
from rsp_chains_tpu.golden import models as j_models
from rsp_chains_tpu.ops.fft import ifft_op as j_ifft_op

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.golden import int_models as t_int
from rsp_chains_tpu_torch.golden import models as t_models
from rsp_chains_tpu_torch.ops.fft import ifft_op


def _cx(*shape, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randn(*shape) + 1j * rng.randn(*shape)


def _mag(*shape, seed=1):
    return np.abs(np.random.RandomState(seed).randn(*shape)) + 0.1


def _ints(*shape, lo=-20000, hi=20000, seed=2):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(np.int64)


def _imag(n, seed=3):
    return np.random.RandomState(seed).randint(0, 4000, n).astype(np.int64)


CFAR = dict(ref_window=8, guard_window=2, threshold_scaler=3.0)
CFAR_2D = dict(ref_range=3, guard_range=1, ref_doppler=2, guard_doppler=1,
               threshold_scaler=2.5)
INT_CFAR = dict(ref_window=8, guard_window=2, div_sum=3, threshold_scaler=3)

# (module name, function, positional args, keyword args): two settings a
# function; the first of a pair is the plain call
CASES = [
    ("models", "jpl_mag", (_cx(64),), {}),
    ("models", "jpl_mag", (_cx(3, 32),), {}),
    ("models", "sqr_mag", (_cx(64),), {}),
    ("models", "sqr_mag", (_cx(3, 32),), {}),
    ("models", "log2_mag", (_cx(64),), {}),
    ("models", "log2_mag", (np.zeros(4, complex),), {}),
    ("models", "abs_mag", (_cx(64),), {}),
    ("models", "abs_mag", (_cx(3, 32),), {}),
    ("models", "fft_golden", (_cx(64),), {}),
    ("models", "fft_golden", (_cx(3, 32), 16), dict(scaling="sqrt_n")),
    ("models", "fft_golden", (_cx(32),), dict(scaling="none")),
    ("models", "nco_golden", (64, 5, 64), {}),
    ("models", "nco_golden", (100, 3, 256), dict(amplitude=2.0 ** 10)),
    ("models", "cfar_golden", (_mag(64),), dict(CFAR, mode=1)),
    ("models", "cfar_golden", (_mag(2, 48),), dict(
        CFAR, mode=3, sub_window=4, peak_grouping=1)),
    ("models", "cfar_golden", (_mag(64),), dict(
        CFAR, algorithm=1, index_lagg=3, index_lead=5, mode=2)),
    ("models", "cfar_golden", (_mag(40),), dict(
        CFAR, edge_policy="reflect", log_or_linear=0, div_sum=2)),
    ("models", "cfar_golden", (_mag(40),), dict(CFAR, edge_policy="wrap")),
    ("models", "matched_filter_golden", (_cx(64), _cx(8, seed=4)), {}),
    ("models", "matched_filter_golden", (_cx(2, 32), _cx(5, seed=4)),
     dict(mode="full")),
    ("models", "matched_filter_golden", (_cx(32), _cx(5, seed=4)),
     dict(mode="same")),
    ("models", "matched_filter_golden", (_cx(32), _cx(5, seed=4)),
     dict(mode="valid")),
    ("models", "range_doppler_golden", (_cx(8, 32),), {}),
    ("models", "range_doppler_golden", (_cx(2, 16, 32),), dict(
        doppler_window=np.hanning(16), fft_shift=False,
        doppler_scaling="sqrt_n", range_scaling="none")),
    ("models", "cfar_2d_golden", (_mag(8, 16),), CFAR_2D),
    ("models", "cfar_2d_golden", (_mag(6, 12),), dict(
        CFAR_2D, algorithm=1, os_rank=4, peak_grouping=1, active_range=10,
        log_or_linear=0)),
    ("int_models", "int_fft_golden", (_ints(16), _ints(16, seed=5)), {}),
    ("int_models", "int_fft_golden", (_ints(2, 32), _ints(2, 32, seed=5)),
     dict(expand_logic=[1, 0, 1, 0, 0], keep_msb=[1, 1, 0, 1, 1])),
    ("int_models", "int_jpl_golden", (_ints(64), _ints(64, seed=5)), {}),
    ("int_models", "int_jpl_golden", (_ints(3, 16), _ints(3, 16, seed=5)),
     {}),
    ("int_models", "int_sqr_golden", (_ints(64), _ints(64, seed=5)), {}),
    ("int_models", "int_sqr_golden", (_ints(3, 16, lo=-40000, hi=40000),
                                      _ints(3, 16, seed=5)), {}),
    ("int_models", "int_abs_golden", (_ints(64), _ints(64, seed=5)), {}),
    ("int_models", "int_abs_golden", (_ints(3, 16), _ints(3, 16, seed=5)),
     {}),
    ("int_models", "int_log2_golden", (_ints(64), _ints(64, seed=5)), {}),
    ("int_models", "int_log2_golden", (_ints(3, 16), _ints(3, 16, seed=5)),
     dict(data_width_log=12, bin_point_log=6, lookup_width=7)),
    ("int_models", "int_gosca_cfar_golden", (_imag(64),), dict(
        INT_CFAR, wmax=16, algorithm=1, rank_lagg=2, rank_lead=5)),
    ("int_models", "int_gosca_cfar_golden", (_imag(48),), dict(
        INT_CFAR, wmax=16, mode=3, sub_window=4, peak_grouping=1,
        n_active=40)),
    ("int_models", "int_ca_cfar_golden", (_imag(64),), dict(INT_CFAR,
                                                            mode=1)),
    ("int_models", "int_ca_cfar_golden", (_imag(48),), dict(
        INT_CFAR, mode=2, log_or_linear=0, peak_grouping=1, n_active=40)),
]


def _bit_equal(got, want, where="out"):
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), where
        for k, (g, w) in enumerate(zip(got, want)):
            _bit_equal(g, w, f"{where}[{k}]")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, where
    assert g.tobytes() == w.tobytes(), where


@pytest.mark.parametrize(
    "module,name,args,kw", CASES,
    ids=[f"{c[1]}-{i}" for i, c in enumerate(CASES)])
def test_port_golden_is_bit_equal_to_the_jax_golden(module, name, args, kw):
    jmod, tmod = {"models": (j_models, t_models),
                  "int_models": (j_int, t_int)}[module]
    _bit_equal(getattr(tmod, name)(*args, **kw),
               getattr(jmod, name)(*args, **kw))


def test_every_jax_golden_has_its_port_copy():
    for jmod, tmod in ((j_models, t_models), (j_int, t_int)):
        names = {k for k, v in vars(jmod).items()
                 if callable(v) and getattr(v, "__module__", "") ==
                 jmod.__name__}
        assert names <= set(vars(tmod)), names - set(vars(tmod))
        assert names - {"_rhu", "_wrap16"} <= {c[1] for c in CASES}
    assert set(t_models.MAG_GOLDENS) == set(j_models.MAG_GOLDENS)
    jexp = {k for k in dir(R.golden) if not k.startswith("_")}
    assert jexp <= set(dir(T.golden)), jexp - set(dir(T.golden))
    assert T.golden.models is t_models


@pytest.mark.parametrize("pair", [True, False])
@pytest.mark.parametrize("shape,n", [((64,), None), ((3, 256), None),
                                     ((2, 128), 128)])
def test_ifft_op_matches_jax(pair, shape, n):
    x = _cx(*shape, seed=7).astype(np.complex64)
    if pair:
        got = ifft_op(T.as_pair(x), n)
        assert T.cplx.is_pair(got)
        got = T.to_numpy(got)
        want = R.cplx.to_numpy(j_ifft_op(R.as_pair(x), n))
    else:
        got = ifft_op(x, n)
        assert isinstance(got, torch.Tensor) and got.is_complex()
        got = got.numpy()
        want = np.asarray(j_ifft_op(x, n))
    assert got.shape == want.shape == shape
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 1e-5, err
    np.testing.assert_allclose(got, np.fft.ifft(x), atol=1e-5 * np.abs(
        want).max())


@pytest.mark.parametrize("what", ["pair", "complex", "real"])
def test_is_pair_matches_jax(what):
    x = _cx(8).astype(np.complex64)
    t_x = {"pair": T.as_pair(x), "complex": torch.from_numpy(x),
           "real": torch.from_numpy(x.real.copy())}[what]
    j_x = {"pair": R.as_pair(x), "complex": x, "real": x.real.copy()}[what]
    assert T.cplx.is_pair(t_x) == R.cplx.is_pair(j_x) == (what == "pair")
