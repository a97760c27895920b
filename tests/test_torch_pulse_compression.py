"""The port's pulse-compression chain against the JAX package on the CPU:
Kernel I's plain version against the JAX ``fused_chain_ca(h_block=...)``
(Pallas in interpret mode, as the JAX package's own tests run it), and the
three routes of ``pulse_compression_chain`` with the shrunken-size branch.
The CUDA kernel itself is checked on the card by tests/test_torch_cuda.py.

Same seeded numpy inputs through both packages at N = 256 and 512. Bar:
threshold max|dthr| / max|thr| < 1e-4, and peaks equal except at cells with
|mag - thr| / max|thr| < 1e-4, where the two FFT formulations (~1e-6
relative) may fall on either side of the threshold."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.kernels.chain_pallas import fused_chain_ca as chain_ca_jax
from rsp_chains_tpu.kernels.rd_pallas import _h_block

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.convert import (
    chain_config_from_reference, runtime_from_reference,
)
from rsp_chains_tpu_torch.kernels import _build
from rsp_chains_tpu_torch.kernels import chain as kchain
from rsp_chains_tpu_torch.ops.fft import fft_op
from rsp_chains_tpu_torch.ops.logmag import logmag
from rsp_chains_tpu_torch.ops.matched_filter import h_planes, matched_filter

REL = 1e-4
TAPS = R.golden.lfm_chirp(48, 0.0, 0.25)


def _cfgs(n=256, variant=R.CfarVariant.CA, include_cash=False, method="freq",
          window=None, runtime_size=True):
    cfg_j = R.ChainConfig(
        fft=R.FftConfig(max_size=n, window=window, runtime_size=runtime_size),
        matched_filter=R.MatchedFilterConfig(num_taps=len(TAPS), fft_size=n,
                                             method=method),
        cfar=R.CfarConfig(max_ref_window=16, max_guard_window=4,
                          max_fft_size=n, variant=variant,
                          include_cash=include_cash))
    return cfg_j, chain_config_from_reference(cfg_j)


def _rts(n=256, **kw):
    regs = dict(fft_size=n, ref_window_size=8, guard_window_size=2,
                threshold_scaler=4.0, div_sum=4)
    regs.update(kw)
    rt_j = R.RuntimeConfig.make(**regs)
    return rt_j, runtime_from_reference(rt_j.peek())


def _frames(n=256, frames=6, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(frames, n) + 1j * rng.randn(frames, n)) * 0.5
    x[:, 30:30 + len(TAPS)] += 3 * TAPS
    x[:, 150:150 + len(TAPS)] += 1.5 * TAPS
    return x.astype(np.complex64)


def _assert_cfar_close(got, want, mag):
    thr_w = np.asarray(want.threshold)
    scale = np.abs(thr_w).max()
    assert got.threshold.shape == thr_w.shape
    assert np.abs(got.threshold.numpy() - thr_w).max() / scale < REL
    assert got.peaks.dtype == torch.bool
    diff = got.peaks.numpy() != np.asarray(want.peaks)
    near = np.abs(np.asarray(mag) - thr_w) / scale < REL
    assert not (diff & ~near).any(), int((diff & ~near).sum())


def _spectrum(x, cfg_t, rt_t):
    """The port's plain matched filter and FFT at the register's size."""
    return fft_op(matched_filter(T.as_pair(x), TAPS, cfg_t.matched_filter),
                  rt_t.log2_fft_size, cfg_t.fft)


@functools.lru_cache(maxsize=None)
def _jax_pc(cfg_j):
    return R.pulse_compression_chain(cfg_j, taps=TAPS).jit()


@functools.lru_cache(maxsize=None)
def _jax_h_block_kernel(cfg_j):
    """The JAX ``fused_chain_ca(h_block=...)``, jitted once per elaboration
    (registers are traced)."""
    hb = _h_block(TAPS, cfg_j.fft.max_size, True)
    return jax.jit(lambda x, rt: chain_ca_jax(x, rt, cfg_j.fft, cfg_j.cfar,
                                              interpret=True, h_block=hb))


PC_REGS = [
    dict(),
    dict(cfar_mode=1, peak_grouping=1),
    dict(cfar_mode=2, mag_mode=0),
    dict(mag_mode=3, log_or_linear=0, threshold_scaler=2.0),
    dict(ref_window_size=16, guard_window_size=4, div_sum=5, mag_mode=1),
    dict(cfar_fft_size=180),
]


@pytest.mark.parametrize("regs", PC_REGS)
def test_pc_ca_reference_matches_the_h_block_kernel(regs):
    n = 256
    cfg_j, cfg_t = _cfgs(n)
    rt_j, rt_t = _rts(n, **regs)
    x = _frames(n)
    want = _jax_h_block_kernel(cfg_j)(R.as_pair(x), rt_j)
    h = h_planes(TAPS, n, True, torch.device("cpu"))
    before = dict(_build.LAUNCHES)
    got = kchain.pc_ca(T.as_pair(x), rt_t, cfg_t.fft, cfg_t.cfar, h)
    assert dict(_build.LAUNCHES) == before     # a CPU tensor: the plain path
    _assert_cfar_close(got, want, logmag(_spectrum(x, cfg_t, rt_t),
                                         rt_t.mag_mode))


@pytest.mark.parametrize("n, regs", [
    (256, dict()),
    (256, dict(cfar_mode=1, peak_grouping=1)),
    (256, dict(fft_size=128)),                 # the shrunken-size branch
    (256, dict(fft_size=64, cfar_mode=2)),
    (512, dict()),
    (512, dict(fft_size=256, mag_mode=0)),
])
def test_pc_fused_route_matches_jax(n, regs):
    cfg_j, cfg_t = _cfgs(n)
    chain_t = T.pulse_compression_chain(cfg_t, taps=TAPS, device="cpu")
    assert chain_t.stage_names == ("pc_fused",)
    assert R.pulse_compression_chain(cfg_j, taps=TAPS).stage_names == (
        "pc_fused",)
    rt_j, rt_t = _rts(n, **regs)
    x = _frames(n)
    got = chain_t(x, rt_t)              # numpy in: to the chain's device
    want = _jax_pc(cfg_j)(R.as_pair(x), rt_j)
    _assert_cfar_close(got, want, logmag(_spectrum(x, cfg_t, rt_t),
                                         rt_t.mag_mode))


@pytest.mark.parametrize("route, kw, stages", [
    ("spectral_mf, GOSCA tail", dict(variant=R.CfarVariant.GOSCA,
                                     include_cash=True),
     ("spectral_mf", "mag_gos_cfar_fused")),
    ("spectral_mf, plain tail", dict(include_cash=True),
     ("spectral_mf", "logmag", "cfar")),
    ("four stages, overlap-save", dict(method="overlap_save"),
     ("matched_filter_os", "fft", "logmag", "cfar")),
    ("four stages, windowed FFT", dict(window="hann"),
     ("matched_filter", "fft", "logmag", "cfar")),
    ("spectral_mf, static size", dict(variant=R.CfarVariant.GOSCA,
                                      include_cash=False, runtime_size=False),
     ("spectral_mf", "mag_gos_cfar_fused")),
])
@pytest.mark.parametrize("regs", [
    dict(cfar_algorithm=1, index_lagg=3, index_lead=5),
    dict(fft_size=128, cfar_mode=3, sub_window_size=2),
])
def test_other_routes_match_jax(route, kw, stages, regs):
    cfg_j, cfg_t = _cfgs(**kw)
    chain_j = R.pulse_compression_chain(cfg_j, taps=TAPS)
    chain_t = T.pulse_compression_chain(cfg_t, taps=TAPS, device="cpu")
    assert chain_t.stage_names == chain_j.stage_names == stages
    rt_j, rt_t = _rts(**regs)
    x = _frames()
    got = chain_t(T.as_pair(x), rt_t)
    want = _jax_pc(cfg_j)(R.as_pair(x), rt_j)
    y = T.as_pair(x)
    for st in chain_t.stages[:-1]:
        y = st.fn(y, rt_t)
    mag = y if "logmag" in stages else logmag(y, rt_t.mag_mode)
    _assert_cfar_close(got, want, mag)


def test_default_pulse_compression_chain_matches_jax():
    chain_j = R.pulse_compression_chain()
    chain_t = T.pulse_compression_chain(device="cpu")
    assert chain_t.stage_names == chain_j.stage_names
    assert chain_t.cfg == chain_config_from_reference(chain_j.cfg)


def test_pc_ca_refuses_what_the_kernel_does_not_compute():
    _, cfg_t = _cfgs(256)
    _, rt_t = _rts()
    x = T.as_pair(_frames())
    h = h_planes(TAPS, 256, True, torch.device("cpu"))
    with pytest.raises(ValueError, match="max_size"):
        kchain.pc_ca(T.C(x.re[:, :128], x.im[:, :128]), rt_t, cfg_t.fft,
                     cfg_t.cfar, h)
    with pytest.raises(ValueError, match=r"h must be \[2, 256\]"):
        kchain.pc_ca(x, rt_t, cfg_t.fft, cfg_t.cfar, h[:, :128])
    win = dataclasses.replace(cfg_t.fft, window="hann")
    with pytest.raises(ValueError, match="window"):
        kchain.pc_ca(x, rt_t, win, cfg_t.cfar, h)
    big = T.FftConfig(max_size=8192)
    xb = T.as_pair(np.zeros((1, 8192), np.complex64))
    with pytest.raises(ValueError, match="max_size"):
        kchain.pc_ca(xb, rt_t, big, cfg_t.cfar,
                     h_planes(TAPS, 8192, True, torch.device("cpu")))
