"""The CUDA kernels of the PyTorch port against their plain PyTorch versions,
on the card. This file imports no jax, so it runs on a host with a card and no
JAX; elsewhere every test skips. On the card:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py -q

Bar: the bench's, max|dthr| / max|thr| < 1e-4 (the kernel's radix-2 fp32 FFT
and direct window sums round differently from torch.fft and the dyadic box
sums) and peak flips <= 1e-5 of the cells."""

import numpy as np
import pytest
import torch

import rsp_chains_tpu_torch as rsp
from rsp_chains_tpu_torch.kernels import _build
from rsp_chains_tpu_torch.kernels import cfar as kcfar
from rsp_chains_tpu_torch.kernels import chain as kchain
from rsp_chains_tpu_torch.ops.fft import fft_op

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _cfg(n):
    return rsp.ChainConfig(
        fft=rsp.FftConfig(max_size=n),
        cfar=rsp.CfarConfig(max_ref_window=64, variant=rsp.CfarVariant.CA,
                            include_cash=False, max_fft_size=n))


def _iq(shape, dev, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) + 1j * rng.randn(*shape)
    x[..., 40] += 60.0  # a strong tone in every frame
    return rsp.as_pair(x.astype(np.complex64), device=dev)


def _assert_close(got, want):
    torch.cuda.synchronize()
    scale = want.threshold.abs().max().item()
    rel = (got.threshold - want.threshold).abs().max().item() / scale
    flips = int((got.peaks != want.peaks).sum().item())
    assert got.peaks.dtype == torch.bool
    assert rel < 1e-4, rel
    assert flips <= 1e-5 * want.peaks.numel() + 0.5, flips


REGS = [
    dict(),
    dict(cfar_mode=1, peak_grouping=1),
    dict(cfar_mode=2, mag_mode=0),
    dict(mag_mode=3, log_or_linear=0, threshold_scaler=2.0),
    dict(ref_window_size=64, guard_window_size=8, div_sum=6, mag_mode=1),
    dict(ref_window_size=2, guard_window_size=1, div_sum=1),
    dict(cfar_fft_size=200),
]


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("regs", REGS)
def test_chain_ca_matches_reference(dev, n, regs):
    cfg = _cfg(n)
    x = _iq((37, n), dev)
    rt = rsp.RuntimeConfig.make(**{"fft_size": n, **regs})
    before = kchain.LAUNCHES
    got = kchain.chain_ca(x, rt, cfg.fft, cfg.cfar)
    assert kchain.LAUNCHES == before + 1
    _assert_close(got, kchain.chain_ca_reference(x, rt, cfg.fft, cfg.cfar))


@pytest.mark.parametrize("n", [128, 384, 1024, 16384])
@pytest.mark.parametrize("regs", REGS)
def test_mag_cfar_matches_reference(dev, n, regs):
    cfg = _cfg(1024)
    spec = _iq((2, 19, n), dev, seed=1)
    rt = rsp.RuntimeConfig.make(**{"fft_size": 1024, "cfar_fft_size": n,
                                   **regs})
    before = kcfar.LAUNCHES
    got = kcfar.mag_cfar(spec, rt, cfg.cfar)
    assert kcfar.LAUNCHES == before + 1
    _assert_close(got, kcfar.mag_cfar_reference(spec, rt, cfg.cfar))


def test_chain_over_register_writes_builds_once(dev):
    cfg = _cfg(1024)
    chain = rsp.fft_mag_cfar_chain(cfg)
    x = _iq((8, 1024), dev)
    for regs in REGS + [dict(fft_size=256)]:
        chain(x, rsp.RuntimeConfig.make(**{"fft_size": 1024, **regs}))
    torch.cuda.synchronize()
    assert _build.BUILDS == 1


def test_three_tone_detections(dev):
    chain = rsp.fft_mag_cfar_chain(_cfg(1024))
    iq = rsp.golden.three_tone_signal(1024, shift_range_factor=12)
    rt = rsp.RuntimeConfig.make(fft_size=1024, ref_window_size=32,
                                guard_window_size=4, threshold_scaler=3.5,
                                div_sum=5)
    out = chain(rsp.as_pair(iq, device=dev), rt)
    assert np.flatnonzero(out.peaks.cpu().numpy()).tolist() == [0, 128, 256, 512]


def test_shrunken_fft_register_takes_mag_cfar(dev):
    cfg = _cfg(1024)
    x = _iq((4, 1024), dev)
    rt = rsp.RuntimeConfig.make(fft_size=128)
    before = kcfar.LAUNCHES
    got = rsp.fft_mag_cfar_chain(cfg)(x, rt)
    assert kcfar.LAUNCHES == before + 1
    want = kcfar.mag_cfar_reference(fft_op(x, rt.log2_fft_size, cfg.fft), rt,
                                    cfg.cfar)
    _assert_close(got, want)


def test_wrapper_refuses_bad_operands(dev):
    cfg = _cfg(1024)
    rt = rsp.RuntimeConfig.make()
    x = _iq((4, 1024), dev)
    with pytest.raises(ValueError):
        kchain.chain_ca(rsp.C(x.re.double(), x.im.double()), rt, cfg.fft,
                        cfg.cfar)
    strided = torch.zeros(4, 2048, device=dev)[:, ::2]
    with pytest.raises(ValueError):
        kcfar.mag_cfar(rsp.C(strided, strided), rt, cfg.cfar)
    with pytest.raises(ValueError):
        kcfar.mag_cfar(rsp.C(x.re, x.im.cpu()), rt, cfg.cfar)
