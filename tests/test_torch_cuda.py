"""The CUDA kernels of the PyTorch port against their plain PyTorch versions,
on the card. This file imports no jax, so it runs on a host with a card and no
JAX; elsewhere every test skips. On the card:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py -q

Bars: for the float kernels the bench's, max|dthr| / max|thr| < 1e-4 (the
kernel's radix-2 fp32 FFT and direct window sums round differently from
torch.fft and the dyadic box sums) and peak flips <= 1e-5 of the cells; for
the wire kernel the bench's wire bar on the decoded fields; for the integer
kernels equality."""

import dataclasses

import numpy as np
import pytest
import torch

import rsp_chains_tpu_torch as rsp
from rsp_chains_tpu_torch.kernels import _build
from rsp_chains_tpu_torch.kernels import cfar as kcfar
from rsp_chains_tpu_torch.kernels import chain as kchain
from rsp_chains_tpu_torch.kernels import int_chain as kint
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
    before = _build.LAUNCHES["chain_ca"]
    got = kchain.chain_ca(x, rt, cfg.fft, cfg.cfar)
    assert _build.LAUNCHES["chain_ca"] == before + 1
    _assert_close(got, kchain.chain_ca_reference(x, rt, cfg.fft, cfg.cfar))


@pytest.mark.parametrize("n", [128, 384, 1024, 16384])
@pytest.mark.parametrize("regs", REGS)
def test_mag_cfar_matches_reference(dev, n, regs):
    cfg = _cfg(1024)
    spec = _iq((2, 19, n), dev, seed=1)
    rt = rsp.RuntimeConfig.make(**{"fft_size": 1024, "cfar_fft_size": n,
                                   **regs})
    before = _build.LAUNCHES["mag_cfar"]
    got = kcfar.mag_cfar(spec, rt, cfg.cfar)
    assert _build.LAUNCHES["mag_cfar"] == before + 1
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
    before = _build.LAUNCHES["mag_cfar"]
    got = rsp.fft_mag_cfar_chain(cfg)(x, rt)
    assert _build.LAUNCHES["mag_cfar"] == before + 1
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


# ---- the GOSCA kernels: C (mag_gos_cfar) and D (chain_gos) ----

def _gos_cfg(n):
    """The default elaboration (GOSCA + CASH, max_ref_window 64) at size n."""
    return rsp.ChainConfig(fft=rsp.FftConfig(max_size=n),
                           cfar=rsp.CfarConfig(max_fft_size=n))


GOS = dict(cfar_algorithm=1, index_lagg=16, index_lead=16)
# (registers over GOS, registers written raw past make()'s rules)
GOS_REGS = [
    (dict(), {}),
    (dict(cfar_mode=1, index_lagg=8, index_lead=24, peak_grouping=1), {}),
    (dict(cfar_mode=2, index_lagg=0, index_lead=0, mag_mode=0), {}),
    (dict(), dict(index_lagg=40, index_lead=64)),
    (dict(ref_window_size=64, guard_window_size=8, div_sum=6,
          index_lagg=63, index_lead=5, mag_mode=1), {}),
    (dict(ref_window_size=2, guard_window_size=1, index_lagg=1,
          index_lead=0), {}),
    (dict(mag_mode=3, log_or_linear=0, threshold_scaler=2.0), {}),
    (dict(cfar_mode=3, sub_window_size=8), {}),
    (dict(cfar_mode=3, sub_window_size=2, cfar_fft_size=200), {}),
    (dict(cfar_mode=3, mag_mode=3, log_or_linear=0, threshold_scaler=2.0),
     dict(sub_window_size=64)),
    (dict(cfar_algorithm=0, cfar_mode=3, sub_window_size=4), {}),
    (dict(cfar_algorithm=0, cfar_mode=1), {}),   # CA sums in Kernels C / D
    (dict(cfar_fft_size=200, peak_grouping=1), {}),
]


def _gos_rt(n, regs, raw):
    rt = rsp.RuntimeConfig.make(**{"fft_size": n, **GOS, **regs})
    return dataclasses.replace(rt, **raw)


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("regs, raw", GOS_REGS)
def test_chain_gos_matches_reference(dev, n, regs, raw):
    cfg = _gos_cfg(n)
    x = _iq((13, n), dev, seed=2)
    rt = _gos_rt(n, regs, raw)
    before = _build.LAUNCHES["chain_gos"]
    got = kchain.chain_gos(x, rt, cfg.fft, cfg.cfar)
    assert _build.LAUNCHES["chain_gos"] == before + 1
    _assert_close(got, kchain.chain_gos_reference(x, rt, cfg.fft, cfg.cfar))


@pytest.mark.parametrize("n", [256, 512, 1024, 1280])
@pytest.mark.parametrize("regs, raw", GOS_REGS)
def test_mag_gos_cfar_matches_reference(dev, n, regs, raw):
    cfg = _gos_cfg(1024)
    spec = _iq((2, 7, n), dev, seed=3)
    rt = _gos_rt(1024, regs, raw)
    if "cfar_fft_size" not in regs:  # the whole frame is active
        rt = dataclasses.replace(rt, cfar_fft_size=n)
    before = _build.LAUNCHES["mag_gos_cfar"]
    got = kcfar.mag_gos_cfar(spec, rt, cfg.cfar)
    assert _build.LAUNCHES["mag_gos_cfar"] == before + 1
    _assert_close(got, kcfar.mag_gos_cfar_reference(spec, rt, cfg.cfar))


def test_pure_gos_elaboration_ignores_the_algorithm_register(dev):
    cfg = rsp.ChainConfig(cfar=rsp.CfarConfig(variant=rsp.CfarVariant.GOS,
                                              include_cash=False))
    x = _iq((8, 1024), dev, seed=4)
    rt = rsp.RuntimeConfig.make(fft_size=1024, index_lagg=6, index_lead=6)
    assert rt.cfar_algorithm == 0
    chain = rsp.fft_mag_cfar_chain(cfg)
    before = _build.LAUNCHES["chain_gos"]
    got = chain(x, rt)
    assert _build.LAUNCHES["chain_gos"] == before + 1
    want = chain(x, rt.merge_regs(cfar_algorithm=1))
    torch.cuda.synchronize()
    assert torch.equal(got.threshold, want.threshold)
    _assert_close(got, kchain.chain_gos_reference(x, rt, cfg.fft, cfg.cfar))


@pytest.mark.parametrize("regs, kernel", [
    (dict(), "chain_ca"),
    (GOS, "chain_gos"),
    (dict(cfar_mode=3), "chain_gos"),
    (dict(GOS, fft_size=512), "mag_gos_cfar"),
    (dict(fft_size=256), "mag_cfar"),
])
def test_default_chain_launches_the_kernel_its_registers_select(dev, regs,
                                                                 kernel):
    cfg = rsp.ChainConfig()
    chain = rsp.fft_mag_cfar_chain()
    assert chain.stage_names == ("fft_mag_gos_cfar_fused",)
    x = _iq((4, 1024), dev, seed=5)
    rt = rsp.RuntimeConfig.make(**{"fft_size": 1024, **regs})
    before = dict(_build.LAUNCHES)
    got = chain(x, rt)
    after = dict(_build.LAUNCHES)
    assert {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)} == {kernel: 1}
    plain = dataclasses.replace(
        cfg, cfar=dataclasses.replace(cfg.cfar, use_pallas=False))
    _assert_close(got, rsp.fft_mag_cfar_chain(plain)(x, rt))


def test_default_chain_three_tone_detections_with_gos_registers(dev):
    iq = rsp.golden.three_tone_signal(1024, shift_range_factor=12)
    rt = rsp.RuntimeConfig.make(fft_size=1024, ref_window_size=32,
                                guard_window_size=4, threshold_scaler=3.5,
                                div_sum=5, **GOS)
    out = rsp.fft_mag_cfar_chain()(rsp.as_pair(iq, device=dev), rt)
    assert np.flatnonzero(out.peaks.cpu().numpy()).tolist() == [0, 128, 256, 512]


def test_gos_register_writes_build_once(dev):
    chain = rsp.fft_mag_cfar_chain()
    x = _iq((4, 1024), dev)
    for regs, raw in GOS_REGS:
        chain(x, _gos_rt(1024, regs, raw))
    torch.cuda.synchronize()
    assert _build.BUILDS == 1


def test_gos_wrappers_refuse_bad_operands(dev):
    cfg = _gos_cfg(1024)
    rt = rsp.RuntimeConfig.make(**GOS)
    x = _iq((4, 1024), dev)
    with pytest.raises(ValueError):
        kchain.chain_gos(rsp.C(x.re.double(), x.im.double()), rt, cfg.fft,
                         cfg.cfar)
    strided = torch.zeros(4, 2048, device=dev)[:, ::2]
    with pytest.raises(ValueError):
        kcfar.mag_gos_cfar(rsp.C(strided, strided), rt, cfg.cfar)
    with pytest.raises(ValueError):
        kcfar.mag_gos_cfar(rsp.C(x.re, x.im.cpu()), rt, cfg.cfar)
    with pytest.raises(ValueError):
        kcfar.mag_gos_cfar(rsp.C(x.re[:, :640].contiguous(),
                                 x.im[:, :640].contiguous()), rt, cfg.cfar)


# ---- Kernel E (wire_ca): packed words in and out ----

def _words(shape, dev, seed=0, scale=250.0):
    """Beat words of IQ quantized as the JAX bench quantizes its frames
    (bench.py:651-653): x * 250, rounded, clipped to +-32767."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) + 1j * rng.randn(*shape)
    x[..., 40] += 60.0
    q = (np.clip(np.round(x.real * scale), -32767, 32767)
         + 1j * np.clip(np.round(x.imag * scale), -32767, 32767))
    return rsp.packing.pack_iq(q.astype(np.complex64)).to(dev)


def _assert_wire_bar(got, want, bw):
    """The JAX bench's wire bar (bench.py:655-679): bins equal, threshold
    field within 2 LSB and 0.05 LSB on average, peak flips <= 1e-5."""
    torch.cuda.synchronize()
    tg, bg, pg = rsp.packing.unpack_cfar_words(got, bw)
    tw, bwant, pw = rsp.packing.unpack_cfar_words(want, bw)
    assert torch.equal(bg, bwant)
    err = (tg - tw).abs().double()
    assert err.max().item() <= 2 and err.mean().item() <= 0.05
    assert int((pg != pw).sum().item()) <= 1e-5 * pg.numel() + 0.5


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("regs", REGS)
def test_wire_ca_matches_reference(dev, n, regs):
    cfg = _cfg(n)
    w = _words((37, n), dev)
    rt = rsp.RuntimeConfig.make(**{"fft_size": n, **regs})
    before = _build.LAUNCHES["wire_ca"]
    got = kchain.wire_ca(w, rt, cfg.fft, cfg.cfar)
    assert _build.LAUNCHES["wire_ca"] == before + 1
    assert got.dtype == torch.int32 and got.shape == w.shape
    _assert_wire_bar(got, kchain.wire_ca_reference(w, rt, cfg.fft, cfg.cfar),
                     n.bit_length() - 1)


@pytest.mark.parametrize("regs, kernel", [
    (dict(), "wire_ca"), (dict(fft_size=256), "mag_cfar")])
def test_wire_chain_launches_the_kernel_its_registers_select(dev, regs,
                                                             kernel):
    cfg = _cfg(1024)
    chain = rsp.rx_fft_mag_cfar_tx_chain(cfg)
    assert chain.stage_names == ("rx_fft_mag_cfar_tx_fused",)
    w = _words((4, 1024), dev, seed=6)
    rt = rsp.RuntimeConfig.make(**{"fft_size": 1024, **regs})
    before = dict(_build.LAUNCHES)
    got = chain(w, rt)
    after = dict(_build.LAUNCHES)
    assert {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)} == {kernel: 1}
    plain = dataclasses.replace(cfg, cfar=dataclasses.replace(
        cfg.cfar, use_pallas=False))
    _assert_wire_bar(got, rsp.rx_fft_mag_cfar_tx_chain(plain)(w, rt), 10)


# ---- Kernels F (chain_int) and G (chain_int_gos): exact ----

def _int_iq(shape, dev, seed=0, amp=32767):
    rng = np.random.RandomState(seed)
    re = rng.randint(-amp, amp + 1, shape)
    im = rng.randint(-amp, amp + 1, shape)
    return rsp.C(torch.tensor(re, dtype=torch.int32, device=dev),
                 torch.tensor(im, dtype=torch.int32, device=dev))


def _assert_exact(got, want):
    torch.cuda.synchronize()
    assert got.threshold.dtype == torch.int32 and got.peaks.dtype == torch.bool
    assert torch.equal(got.threshold, want.threshold)
    assert torch.equal(got.peaks, want.peaks)


def _fft(n, expand=None, lsb=None):
    p = n.bit_length() - 1
    return rsp.FftConfig(
        max_size=n,
        expand_logic=None if expand is None else tuple(
            int(s in expand) for s in range(p)),
        keep_msb_or_lsb=None if lsb is None else tuple(
            int(s not in lsb) for s in range(p)))


INT_REGS = [
    dict(),
    dict(mag_mode=0, cfar_mode=1, peak_grouping=1),
    dict(mag_mode=1, cfar_mode=2, threshold_scaler=2.5),
    dict(mag_mode=1, div_sum=0, threshold_scaler=64.0),   # wraps in int32
    dict(log_or_linear=0, threshold_scaler=3.5, cfar_fft_size=200),
    dict(ref_window_size=64, guard_window_size=8, div_sum=6),
    dict(ref_window_size=2, guard_window_size=1, div_sum=40),
]
INT_FFTS = [dict(), dict(expand=(0, 2, 3, 5, 6, 7, 8)), dict(lsb=(1, 4)),
            dict(expand=(1,), lsb=(0, 2))]


@pytest.mark.parametrize("n", [256, 1024, 4096, 16384])
@pytest.mark.parametrize("regs", INT_REGS)
@pytest.mark.parametrize("fft", INT_FFTS)
def test_chain_int_matches_reference(dev, n, regs, fft):
    cfg = _cfg(n)
    fft_cfg = _fft(n, **fft)
    x = _int_iq((9, n), dev, seed=n)
    rt = rsp.RuntimeConfig.make(**{"fft_size": n, **regs})
    before = _build.LAUNCHES["chain_int"]
    got = kint.chain_int(x, rt, fft_cfg, cfg.cfar)
    assert _build.LAUNCHES["chain_int"] == before + 1
    _assert_exact(got, kint.chain_int_reference(x, rt, fft_cfg, cfg.cfar))


INT_GOS_REGS = [
    dict(),
    dict(cfar_mode=1, index_lagg=8, index_lead=24, peak_grouping=1),
    dict(cfar_mode=2, index_lagg=0, index_lead=0, mag_mode=0),
    dict(index_lagg=31, index_lead=31, mag_mode=1, threshold_scaler=2.5),
    dict(ref_window_size=64, guard_window_size=8, div_sum=6, index_lagg=63,
         index_lead=5, cfar_fft_size=300),
    dict(ref_window_size=2, guard_window_size=1, index_lagg=1, index_lead=0),
    dict(cfar_algorithm=0, cfar_mode=1, mag_mode=1, div_sum=0),
]


@pytest.mark.parametrize("n", [256, 1024, 4096, 16384])
@pytest.mark.parametrize("regs", INT_GOS_REGS)
@pytest.mark.parametrize("fft", INT_FFTS[:2])
def test_chain_int_gos_matches_reference(dev, n, regs, fft):
    cfg = _gos_cfg(n)
    fft_cfg = _fft(n, **fft)
    x = _int_iq((5, n), dev, seed=n + 1)
    rt = rsp.RuntimeConfig.make(**{"fft_size": n, **GOS, **regs})
    before = _build.LAUNCHES["chain_int_gos"]
    got = kint.chain_int_gos(x, rt, fft_cfg, cfg.cfar)
    assert _build.LAUNCHES["chain_int_gos"] == before + 1
    _assert_exact(got, kint.chain_int_gos_reference(x, rt, fft_cfg, cfg.cfar))


def _bit_true(cfar):
    return rsp.ChainConfig(cfar=cfar, fixed_point=rsp.FixedPointConfig(
        enabled=True, width=16, bin_point=0, bit_true=True))


@pytest.mark.parametrize("cfar, regs, kernel", [
    (rsp.CfarConfig(variant=rsp.CfarVariant.CA, include_cash=False), {},
     "chain_int"),
    (rsp.CfarConfig(variant=rsp.CfarVariant.CA, include_cash=False),
     dict(mag_mode=3, log_or_linear=0), None),
    (rsp.CfarConfig(), GOS, "chain_int_gos"),
    (rsp.CfarConfig(), dict(cfar_algorithm=0), "chain_int"),
    (rsp.CfarConfig(), dict(cfar_mode=3, sub_window_size=8), None),
    (rsp.CfarConfig(), dict(GOS, fft_size=512), None),
])
def test_bit_true_chain_launches_the_kernel_its_registers_select(
        dev, cfar, regs, kernel):
    cfg = _bit_true(cfar)
    chain = rsp.fft_mag_cfar_chain(cfg)
    assert chain.stage_names == ("fft_mag_cfar_int_fused",)
    x = _int_iq((4, 1024), dev, seed=7, amp=8000)
    rt = rsp.RuntimeConfig.make(**{"fft_size": 1024, **regs})
    before = dict(_build.LAUNCHES)
    got = chain(x, rt)
    after = dict(_build.LAUNCHES)
    assert {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)} == ({kernel: 1} if kernel else {})
    _assert_exact(got, kint.int_ops_chain(x, rt, cfg))


def test_bit_true_wire_chain_launches_chain_int(dev):
    cfg = _bit_true(rsp.CfarConfig(variant=rsp.CfarVariant.CA,
                                   include_cash=False))
    chain = rsp.rx_fft_mag_cfar_tx_chain(cfg)
    w = _words((4, 1024), dev, seed=8)
    rt = rsp.RuntimeConfig.make(fft_size=1024)
    before = _build.LAUNCHES["chain_int"]
    got = chain(w, rt)
    assert _build.LAUNCHES["chain_int"] == before + 1
    torch.cuda.synchronize()
    plain = dataclasses.replace(cfg, cfar=dataclasses.replace(
        cfg.cfar, use_pallas=False))
    assert torch.equal(got, rsp.rx_fft_mag_cfar_tx_chain(plain)(w, rt))


def test_integer_register_writes_build_once(dev):
    chain = rsp.fft_mag_cfar_chain(_bit_true(rsp.CfarConfig()))
    x = _int_iq((4, 1024), dev)
    for regs in INT_GOS_REGS + [dict(cfar_algorithm=0), dict(fft_size=256)]:
        chain(x, rsp.RuntimeConfig.make(**{"fft_size": 1024, **GOS, **regs}))
    wire = rsp.rx_fft_mag_cfar_tx_chain(_cfg(1024))
    for regs in REGS:
        wire(_words((4, 1024), dev), rsp.RuntimeConfig.make(**regs))
    torch.cuda.synchronize()
    assert _build.BUILDS == 1


def test_new_wrappers_refuse_bad_operands(dev):
    cfg = _cfg(1024)
    gcfg = _gos_cfg(1024)
    rt = rsp.RuntimeConfig.make(**GOS)
    w = _words((4, 1024), dev)
    with pytest.raises(ValueError):
        kchain.wire_ca(w[:, :512].contiguous(), rt, cfg.fft, cfg.cfar)
    with pytest.raises(ValueError):
        kchain.wire_ca(torch.zeros(4, 2048, dtype=torch.int32,
                                   device=dev)[:, ::2], rt, cfg.fft, cfg.cfar)
    x = _int_iq((4, 1024), dev)
    with pytest.raises(ValueError):
        kint.chain_int(rsp.C(x.re, x.im.cpu()), rt, cfg.fft, cfg.cfar)
    with pytest.raises(ValueError):
        kint.chain_int(rsp.C(x.re[:, :640].contiguous(),
                             x.im[:, :640].contiguous()), rt, cfg.fft,
                       cfg.cfar)
    with pytest.raises(ValueError, match="magnitude modes 0-2"):
        kint.chain_int(x, rt.merge_regs(mag_mode=3), cfg.fft, cfg.cfar)
    with pytest.raises(ValueError, match="no CASH"):
        kint.chain_int_gos(x, rt.merge_regs(cfar_mode=3), gcfg.fft, gcfg.cfar)
    with pytest.raises(ValueError, match="at most 7 expanding"):
        kint.chain_int(x, rt, rsp.FftConfig(expand_logic=(1,) * 10), cfg.cfar)
    big = _int_iq((1, 32768), dev)
    with pytest.raises(ValueError, match="power of two in"):
        kint.chain_int_gos(big, rt, rsp.FftConfig(max_size=32768), gcfg.cfar)
