"""The plain versions of the port's two kernels against the JAX package's
Pallas kernels (run in interpret mode, as the JAX package's own tests run them
on the CPU), and the wrappers' host-side contract. The CUDA kernels themselves
are checked on the card by tests/test_torch_cuda.py.

Bar: max|dthr| / max|thr| < 1e-4, the bench's (the port's torch.fft against
the Pallas kernel's split-matmul FFT measures ~1e-6); peaks equal."""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.kernels.cfar_pallas import fused_mag_cfar
from rsp_chains_tpu.kernels.chain_pallas import fused_chain_ca, fused_chain_ca_op

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.convert import (
    chain_config_from_reference, runtime_from_reference,
)
from rsp_chains_tpu_torch.kernels import _build
from rsp_chains_tpu_torch.kernels import cfar as kcfar
from rsp_chains_tpu_torch.kernels import chain as kchain
from rsp_chains_tpu_torch.ops.fft import fft_op
from rsp_chains_tpu_torch.ops.logmag import logmag

REL = 1e-4


def _cfgs(n):
    cfg_j = R.ChainConfig(
        fft=R.FftConfig(max_size=n),
        cfar=R.CfarConfig(max_ref_window=64, variant=R.CfarVariant.CA,
                          include_cash=False, max_fft_size=n))
    return cfg_j, chain_config_from_reference(cfg_j)


def _frames(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) + 1j * rng.randn(*shape)) * 50
    x[..., 40] += 4000 + 100j
    x[..., 100] += 900 - 500j
    return x.astype(np.complex64)


def _assert_matches(got, want):
    thr_w = np.asarray(want.threshold)
    rel = np.abs(got.threshold.numpy() - thr_w).max() / np.abs(thr_w).max()
    assert rel < REL, rel
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))
    assert got.peaks.dtype == torch.bool


CHAIN_REGS = [
    dict(),
    dict(cfar_mode=1, peak_grouping=1, ref_window_size=16,
         guard_window_size=2, div_sum=4),
    dict(cfar_mode=2, mag_mode=3, log_or_linear=0, threshold_scaler=2.0,
         cfar_fft_size=200),
]


@pytest.mark.parametrize("regs", CHAIN_REGS)
@pytest.mark.parametrize("n", [256, 512])
def test_chain_ca_reference_matches_pallas(n, regs):
    cfg_j, cfg_t = _cfgs(n)
    x = _frames((3, n))
    rt_j = R.RuntimeConfig.make(**{"fft_size": n, **regs})
    want = fused_chain_ca(R.as_pair(x), rt_j, cfg_j.fft, cfg_j.cfar,
                          interpret=True)
    got = kchain.chain_ca_reference(T.as_pair(x),
                                    runtime_from_reference(rt_j.peek()),
                                    cfg_t.fft, cfg_t.cfar)
    _assert_matches(got, want)


MAG_REGS = [
    dict(),
    dict(cfar_mode=1, ref_window_size=64, guard_window_size=8, div_sum=6),
    dict(cfar_mode=2, ref_window_size=2, guard_window_size=1, mag_mode=0),
    dict(peak_grouping=1, mag_mode=1, ref_window_size=16,
         guard_window_size=2),
    dict(fft_size=128, mag_mode=3, log_or_linear=0, threshold_scaler=2.0),
]


@pytest.mark.parametrize("regs", MAG_REGS)
def test_mag_cfar_reference_matches_pallas(regs):
    cfg_j, cfg_t = _cfgs(256)
    spec = _frames((4, 256), seed=2)
    rt_j = R.RuntimeConfig.make(**{"fft_size": 256, **regs})
    want = fused_mag_cfar(jnp.asarray(spec), rt_j, cfg_j.cfar, interpret=True)
    got = kcfar.mag_cfar_reference(T.as_pair(spec),
                                   runtime_from_reference(rt_j.peek()),
                                   cfg_t.cfar)
    _assert_matches(got, want)


def test_fused_chain_ca_op_shrunken_size_matches_pallas():
    """A shrunken FFT-size register leaves Kernel A: the FFT op, then Kernel
    B's path, in both packages."""
    cfg_j, cfg_t = _cfgs(256)
    x = _frames((3, 256), seed=5)
    rt_j = R.RuntimeConfig.make(fft_size=64, ref_window_size=8,
                                guard_window_size=2)
    want = fused_chain_ca_op(R.as_pair(x), rt_j, cfg_j.fft, cfg_j.cfar,
                             interpret=True)
    got = kchain.fused_chain_ca_op(T.as_pair(x),
                                   runtime_from_reference(rt_j.peek()),
                                   cfg_t.fft, cfg_t.cfar)
    _assert_matches(got, want)


def test_cpu_tensors_take_the_plain_version_without_launching():
    _, cfg = _cfgs(512)
    x = T.as_pair(_frames((2, 3, 512)))
    rt = T.RuntimeConfig.make(fft_size=512, peak_grouping=1)
    small = rt.merge_regs(fft_size=256, cfar_fft_size=256)
    launches = (kchain.LAUNCHES, kcfar.LAUNCHES)
    pairs = [
        (kchain.fused_chain_ca_op(x, rt, cfg.fft, cfg.cfar),
         kchain.chain_ca_reference(x, rt, cfg.fft, cfg.cfar)),
        (kchain.fused_chain_ca_op(x, small, cfg.fft, cfg.cfar),
         kcfar.mag_cfar_reference(fft_op(x, small.log2_fft_size, cfg.fft),
                                  small, cfg.cfar)),
    ]
    for got, want in pairs:
        assert got.threshold.shape == (2, 3, 512)
        assert got.peaks.dtype == torch.bool
        assert torch.equal(got.threshold, want.threshold)
        assert torch.equal(got.peaks, want.peaks)
    assert (kchain.LAUNCHES, kcfar.LAUNCHES) == launches


def test_wrappers_check_shapes_and_window_bounds():
    _, cfg = _cfgs(1024)
    rt = T.RuntimeConfig.make()
    x = T.as_pair(_frames((2, 1024)))
    with pytest.raises(ValueError):       # N is not the elaborated max_size
        kchain.chain_ca(T.as_pair(_frames((2, 512))), rt, cfg.fft, cfg.cfar)
    big = T.FftConfig(max_size=2048)
    with pytest.raises(ValueError):       # N outside the kernel's sizes
        kchain.chain_ca(T.as_pair(_frames((2, 2048))), rt, big, cfg.cfar)
    with pytest.raises(ValueError):       # a window is not in the kernel
        kchain.chain_ca(x, rt, T.FftConfig(max_size=1024, window="hann"),
                        cfg.cfar)
    with pytest.raises(ValueError):       # N % 128
        kcfar.mag_cfar(T.as_pair(_frames((2, 200))), rt, cfg.cfar)
    wide = T.CfarConfig(max_ref_window=128, variant=T.CfarVariant.CA,
                        include_cash=False)
    with pytest.raises(ValueError):       # max_ref > 64
        kcfar.mag_cfar(x, rt, wide)
    reach = T.CfarConfig(max_ref_window=64, max_guard_window=64,
                         variant=T.CfarVariant.CA, include_cash=False)
    with pytest.raises(ValueError):       # max_ref + max_guard + 1 > 128
        kchain.chain_ca(x, rt, cfg.fft, reach)
    meta = T.C(torch.empty(2, 1024, device="meta"),
               torch.empty(2, 1024, device="meta"))
    with pytest.raises(ValueError):       # neither CPU nor CUDA
        kchain.chain_ca(meta, rt, cfg.fft, cfg.cfar)
    with pytest.raises(ValueError):
        kcfar.mag_cfar(meta, rt, cfg.cfar)


def test_registers_are_clamped_on_the_host_like_chain_scalars():
    cfg = T.CfarConfig(max_ref_window=32, max_guard_window=4,
                       variant=T.CfarVariant.CA, include_cash=False)
    rt = T.RuntimeConfig.make(ref_window_size=64, guard_window_size=9,
                              mag_mode=7, cfar_fft_size=5000,
                              threshold_scaler=0.1)
    regs = kcfar.ca_registers(rt, cfg, 1024)
    assert (regs.log2w, regs.guard, regs.mag_mode) == (5, 4, 3)
    assert (regs.active_lo, regs.active_hi) == (0, 1024)
    assert regs.scaler == float(np.float32(0.1))
    regs = kcfar.ca_registers(rt.merge_regs(cfar_fft_size=700), cfg, 1024)
    assert (regs.active_lo, regs.active_hi) == (0, 700)


def test_mag_mode_above_three_follows_the_plain_logmag():
    """A ``mag_mode`` code above 3 is clipped to LOG2, as the JAX package's
    ``ops.logmag`` clips it (its Pallas ``_magnitude`` would pass the real part
    through instead)."""
    from rsp_chains_tpu.ops.logmag import logmag as logmag_j

    _, cfg = _cfgs(256)
    spec = _frames((4, 256), seed=3)
    rt = T.RuntimeConfig.make(mag_mode=7, log_or_linear=0,
                              threshold_scaler=2.0)
    want_mag = np.asarray(logmag_j(R.as_pair(spec), jnp.int32(7)))
    got_mag = logmag(T.as_pair(spec), 7).numpy()
    np.testing.assert_allclose(got_mag, want_mag, rtol=1e-5, atol=1e-5)
    got = kcfar.mag_cfar(T.as_pair(spec), rt, cfg.cfar)
    log2 = kcfar.mag_cfar(T.as_pair(spec), rt.merge_regs(mag_mode=3),
                          cfg.cfar)
    assert torch.equal(got.threshold, log2.threshold)
    assert torch.equal(got.peaks, log2.peaks)


def test_register_struct_mirrors_the_cuda_header():
    """``CaRegs`` is passed by value to the C entry points: its fields must be
    ``RspCaRegs``'s, in order, with the same types."""
    header = (_build.CSRC / "ca_cfar.cuh").read_text()
    body = re.search(r"struct RspCaRegs \{(.*?)\};", header, re.S).group(1)
    fields = re.findall(r"^\s*(int|float)\s+(\w+);", body, re.M)
    ctypes_names = {"int": "c_int", "float": "c_float"}
    assert [(name, ctypes_names[t]) for t, name in fields] == [
        (name, ctype.__name__) for name, ctype in kcfar.CaRegs._fields_]


def test_build_is_named_by_its_sources_and_needs_nvcc(monkeypatch, tmp_path):
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    assert path == _build.library_path()
    for name in _build.SOURCES + _build.HEADERS:
        assert (_build.CSRC / name).is_file()
    copy = tmp_path / "csrc"
    copy.mkdir()
    for name in _build.SOURCES + _build.HEADERS:
        (copy / name).write_bytes((_build.CSRC / name).read_bytes())
    (copy / "ca_cfar.cuh").write_text(
        (copy / "ca_cfar.cuh").read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "CSRC", copy)
    assert _build.library_path() != path
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
