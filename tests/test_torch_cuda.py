"""The CUDA kernels of the PyTorch port against their plain PyTorch versions,
on the card. This file imports no jax, so it runs on a host with a card and no
JAX; elsewhere every test skips. On the card:

    python -m pytest --noconftest -o addopts="" -m cuda tests/test_torch_cuda.py -q

Bars: for the float kernels the bench's, max|dthr| / max|thr| < 1e-4 (the
kernels' fp32 FFT passes and window sums round differently from torch.fft
and the dyadic box sums) and peak flips <= 1e-5 of the cells; for
the complex range-Doppler map max|dmap| / max|map| < 1e-4; for the wire
kernel the bench's wire bar on the decoded fields; for the integer kernels
equality; for the halo exchange equality, and for the extended magnitude
max|d| / max|mag| <= 1e-6.

The sharded chains run on meshes of virtual shards of one card (a mesh that
lists cuda:0 several times), and, where the host has two cards or more, on
meshes of distinct cards, whose halo kernels read their neighbours' memory
over the peer link."""

import dataclasses

import numpy as np
import pytest
import torch

import rsp_chains_tpu_torch as rsp
from rsp_chains_tpu_torch import parallel as SP
from rsp_chains_tpu_torch.kernels import _build
from rsp_chains_tpu_torch.kernels import cfar as kcfar
from rsp_chains_tpu_torch.kernels import chain as kchain
from rsp_chains_tpu_torch.kernels import halo as khalo
from rsp_chains_tpu_torch.kernels import int_chain as kint
from rsp_chains_tpu_torch.kernels import rd as krd
from rsp_chains_tpu_torch.ops.fft import fft_op
from rsp_chains_tpu_torch.ops.logmag import logmag
from rsp_chains_tpu_torch.ops import bit_true as TB
from rsp_chains_tpu_torch.ops import nco as tnco
from rsp_chains_tpu_torch.ops.matched_filter import overlap_save_fir

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


@pytest.mark.parametrize("n", [128, 384, 1024, 4096, 8320, 16384])
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


# Kernel B's layouts: rows of N <= 4096 several a block (32 at N = 128, 10
# at 384 with 16 threads idle, one at 4096), longer rows in tiles of 4096
# (8320: two seams, a last tile of 128 cells)
B_SIZES = [128, 384, 1024, 4096, 8320]
B_CUTS = ["whole frame", "active range", "active range, given"]


@pytest.mark.parametrize("n", B_SIZES)
@pytest.mark.parametrize("mode", [0, 1, 2])
@pytest.mark.parametrize("log", [False, True])
@pytest.mark.parametrize("grouping", [0, 1])
@pytest.mark.parametrize("cut", B_CUTS)
def test_mag_cfar_rows_and_tiles_match_reference(dev, n, mode, log, grouping,
                                                 cut):
    cfg = _cfg(1024)
    regs = dict(fft_size=1024, cfar_fft_size=n, cfar_mode=mode,
                peak_grouping=grouping, ref_window_size=16,
                guard_window_size=2, div_sum=4)
    if log:
        regs.update(mag_mode=3, log_or_linear=0, threshold_scaler=2.0)
    rt = rsp.RuntimeConfig.make(**regs)
    spec = _iq((7, n), dev, seed=n + mode)
    kw = {}
    if cut != "whole frame":
        kw = dict(active_lo=37, active_hi=n - 21)
    if cut.endswith("given"):
        spec = logmag(spec, rt.mag_mode)
        kw["mag_given"] = True
    before = dict(_build.LAUNCHES)
    got = kcfar.mag_cfar(spec, rt, cfg.cfar, **kw)
    assert _took(before) == {"mag_cfar": 1}
    _assert_close(got, kcfar.mag_cfar_reference(spec, rt, cfg.cfar, **kw))
    if kw:
        assert not got.peaks[..., :37].any()
        assert not got.peaks[..., n - 21:].any()


@pytest.mark.parametrize("n", [57856, 65664])
def test_mag_cfar_takes_frames_beyond_a_blocks_shared_memory(dev, n):
    """57,856 cells was the longest frame a whole row in shared memory took;
    tiles take any length."""
    cfg = _cfg(1024)
    rt = rsp.RuntimeConfig.make(fft_size=1024, cfar_fft_size=n,
                                peak_grouping=1)
    spec = _iq((2, n), dev, seed=3)
    got = kcfar.mag_cfar(spec, rt, cfg.cfar)
    _assert_close(got, kcfar.mag_cfar_reference(spec, rt, cfg.cfar))


def test_mag_cfar_takes_a_plane_at_an_unaligned_offset(dev):
    """Kernel B loads float4: a contiguous plane that starts 4 bytes into
    its storage goes through an aligned copy and gives the same result."""
    cfg = _cfg(1024)
    rt = rsp.RuntimeConfig.make(fft_size=1024, cfar_fft_size=384)
    spec = _iq((5, 384), dev, seed=4)
    store = torch.zeros(5 * 384 + 1, device=dev)
    store[1:] = spec.re.reshape(-1)
    odd = rsp.C(store[1:].view(5, 384), spec.im)
    assert odd.re.data_ptr() % 16 and odd.re.is_contiguous()
    got = kcfar.mag_cfar(odd, rt, cfg.cfar)
    _assert_close(got, kcfar.mag_cfar_reference(spec, rt, cfg.cfar))


# the 13-register sweep of tests/test_no_recompile.py, over the CA
# elaboration (CASH and the GOS algorithm degrade to CA there)
SWEEP13 = [
    dict(), dict(fft_size=256), dict(fft_size=64), dict(mag_mode=1),
    dict(mag_mode=3, log_or_linear=0, threshold_scaler=2.0),
    dict(cfar_mode=1), dict(cfar_mode=2),
    dict(cfar_mode=3, sub_window_size=8),
    dict(cfar_algorithm=1, index_lagg=20, index_lead=20),
    dict(ref_window_size=16, guard_window_size=2, div_sum=4),
    dict(ref_window_size=64, guard_window_size=8, div_sum=6),
    dict(peak_grouping=1), dict(threshold_scaler=10.0),
]


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("regs", SWEEP13)
def test_chain_ca_over_the_register_sweep(dev, n, regs):
    cfg = _cfg(n)
    x = _iq((19, n), dev, seed=2)
    rt = rsp.RuntimeConfig.make(**{"ref_window_size": 32,
                                   "guard_window_size": 4, **regs})
    before = _build.LAUNCHES["chain_ca"]
    got = kchain.chain_ca(x, rt, cfg.fft, cfg.cfar)
    assert _build.LAUNCHES["chain_ca"] == before + 1
    _assert_close(got, kchain.chain_ca_reference(x, rt, cfg.fft, cfg.cfar))
    assert _build.BUILDS == 1


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("w", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("mode, grouping", [(0, 0), (1, 1), (2, 0)])
def test_chain_ca_over_windows_and_modes(dev, n, w, mode, grouping):
    """Every run width of the CA tail (C = min(w, 16)); w = 1 with guard 0
    is a raw register write past make()'s rules."""
    cfg = _cfg(n)
    x = _iq((11, n), dev, seed=w)
    rt = rsp.RuntimeConfig.make(
        ref_window_size=max(w, 2), guard_window_size=min(w // 4 + 1, 8),
        div_sum=w.bit_length() - 1, cfar_mode=mode, peak_grouping=grouping)
    if w == 1:
        rt = dataclasses.replace(rt, ref_window_size=1, guard_window_size=0)
    _assert_close(kchain.chain_ca(x, rt, cfg.fft, cfg.cfar),
                  kchain.chain_ca_reference(x, rt, cfg.fft, cfg.cfar))


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("lo, hi", [(5, 117), (37, -21), (16, 33), (0, 200)])
@pytest.mark.parametrize("mag_mode", [0, 2, 3])
def test_chain_ca_active_range_inside_a_run(dev, n, lo, hi, mag_mode):
    """Kernel A with an active range whose edges fall inside a thread's
    16-cell run, against the plain tail over the same range."""
    cfg = _cfg(n)
    hi = hi % n
    x = _iq((9, n), dev, seed=lo)
    rt = rsp.RuntimeConfig.make(fft_size=n, mag_mode=mag_mode, peak_grouping=1,
                                **({} if mag_mode != 3 else dict(
                                    log_or_linear=0, threshold_scaler=2.0)))
    regs = kcfar.ca_registers(rt, cfg.cfar, n, lo, hi)
    got = kchain._chain_kernel("chain_ca", "rsp_chain_ca", regs, x, cfg.fft,
                               kchain._row_twiddles(n, dev))
    want = kcfar.mag_cfar_reference(fft_op(x, None, cfg.fft), rt, cfg.cfar,
                                    active_lo=lo, active_hi=hi)
    _assert_close(got, want)
    assert not got.peaks[:, :lo].any() and not got.peaks[:, hi:].any()
    assert not got.threshold[:, :lo].any() and not got.threshold[:, hi:].any()


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("frames", [1, 3, 17, 65])
def test_chain_ca_part_filled_block(dev, n, frames):
    """Frame counts that leave the last block (256 / (N / 16) frames) part
    filled: the absent frames take part in the barriers and write nothing."""
    cfg = _cfg(n)
    x = _iq((frames + 1, n), dev, seed=frames)
    rt = rsp.RuntimeConfig.make(fft_size=n)
    sub = rsp.C(x.re[:frames], x.im[:frames])
    got = kchain.chain_ca(sub, rt, cfg.fft, cfg.cfar)
    assert got.threshold.shape == (frames, n)
    _assert_close(got, kchain.chain_ca_reference(sub, rt, cfg.fft, cfg.cfar))


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


# the windows and ranks of the warp-resident selection of C and D
WINDOWS = [2, 4, 8, 16, 32, 64]
RANKS = ["0", "middle", "w - 1", ">= nv, raw"]


def _window_regs(w, rank):
    """(registers over GOS, registers written raw) at window w, guard
    max(1, w // 8): the lag rank ``rank`` and the lead rank its mirror
    w - 1 - rank, or with ``">= nv, raw"`` ranks past every window's count
    written past make()'s rules; the mode cycles CA, GO, SO over the
    windows."""
    k = {"0": 0, "middle": w // 2, "w - 1": w - 1}.get(rank, 0)
    regs = dict(ref_window_size=w, guard_window_size=max(1, w // 8),
                index_lagg=k, index_lead=w - 1 - k,
                cfar_mode=WINDOWS.index(w) % 3)
    raw = dict(index_lagg=w + 3, index_lead=100) if rank == RANKS[-1] else {}
    return regs, raw


WINDOW_REGS = [_window_regs(w, rank) for w in WINDOWS for rank in RANKS]


def _gos_rt(n, regs, raw):
    rt = rsp.RuntimeConfig.make(**{"fft_size": n, **GOS, **regs})
    return dataclasses.replace(rt, **raw)


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("regs, raw", GOS_REGS + WINDOW_REGS)
def test_chain_gos_matches_reference(dev, n, regs, raw):
    cfg = _gos_cfg(n)
    x = _iq((13, n), dev, seed=2)
    rt = _gos_rt(n, regs, raw)
    before = _build.LAUNCHES["chain_gos"]
    got = kchain.chain_gos(x, rt, cfg.fft, cfg.cfar)
    assert _build.LAUNCHES["chain_gos"] == before + 1
    _assert_close(got, kchain.chain_gos_reference(x, rt, cfg.fft, cfg.cfar))


def test_chain_gos_counts_its_launch_and_its_host_time(dev):
    cfg = _gos_cfg(1024)
    x = _iq((64, 1024), dev, seed=2)
    n0, s0 = _build.LAUNCHES["chain_gos"], _build.LAUNCH_S["chain_gos"]
    kchain.chain_gos(x, _gos_rt(1024, {}, {}), cfg.fft, cfg.cfar)
    assert _build.LAUNCHES["chain_gos"] == n0 + 1
    assert _build.LAUNCH_S["chain_gos"] > s0


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


# ---- the warp-resident rank selection of C and D over every window ----

def _int_spec(shape, dev, seed):
    """Integer-valued spectra: re, im in -3 .. 3 and a cell of 25 at bin 40.
    Under SQR magnitude and a linear scaler of 3.5 every statistic, mean and
    product is exact in float32, and every window is full of ties."""
    rng = np.random.RandomState(seed)
    re = rng.randint(-3, 4, shape).astype(np.float32)
    im = rng.randint(-3, 4, shape).astype(np.float32)
    re[..., 40] += 25.0
    return rsp.C(torch.from_numpy(re).to(dev), torch.from_numpy(im).to(dev))


def _assert_equal(got, want):
    torch.cuda.synchronize()
    assert torch.equal(got.threshold, want.threshold), (
        (got.threshold - want.threshold).abs().max().item())
    assert torch.equal(got.peaks, want.peaks)


@pytest.mark.parametrize("n", [256, 512, 1024, 1280])
@pytest.mark.parametrize("regs, raw", WINDOW_REGS)
def test_mag_gos_cfar_is_exact_on_integer_spectra(dev, n, regs, raw):
    cfg = _gos_cfg(1024)
    spec = _int_spec((3, 5, n), dev, seed=regs["ref_window_size"] + n)
    rt = dataclasses.replace(_gos_rt(1024, dict(regs, mag_mode=1), raw),
                             cfar_fft_size=n)
    before = dict(_build.LAUNCHES)
    got = kcfar.mag_gos_cfar(spec, rt, cfg.cfar)
    assert _took(before) == {"mag_gos_cfar": 1}
    _assert_equal(got, kcfar.mag_gos_cfar_reference(spec, rt, cfg.cfar))


# windows cut by the active range: the CFAR FFT-size register, an explicit
# range (a range-sharded tail's), one with the magnitude given, and a range
# narrower than the widest window
CUTS = ["cfar_fft_size", "active range", "active range, given",
        "narrow range, given"]


@pytest.mark.parametrize("n", [256, 512, 1024, 1280])
@pytest.mark.parametrize("cut", CUTS)
@pytest.mark.parametrize("w", [2, 8, 32, 64])
def test_mag_gos_cfar_is_exact_on_cut_windows(dev, n, cut, w):
    cfg = _gos_cfg(1024)
    spec = _int_spec((4, n), dev, seed=7 * w + n)
    regs, raw = _window_regs(w, "middle")
    rt = dataclasses.replace(_gos_rt(1024, dict(regs, mag_mode=1), raw),
                             cfar_fft_size=n - 77)
    kw = {}
    if cut != "cfar_fft_size":
        rt = dataclasses.replace(rt, cfar_fft_size=n)
        kw = dict(active_lo=37, active_hi=n - 101)
        if cut.startswith("narrow"):
            kw = dict(active_lo=100, active_hi=120)
    x = spec
    if cut.endswith("given"):
        x = logmag(spec, rt.mag_mode)
        kw["mag_given"] = True
    before = dict(_build.LAUNCHES)
    got = kcfar.mag_gos_cfar(x, rt, cfg.cfar, **kw)
    assert _took(before) == {"mag_gos_cfar": 1}
    _assert_equal(got, kcfar.mag_gos_cfar_reference(x, rt, cfg.cfar, **kw))


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
            dict(expand=(1,), lsb=(0, 2)), dict(expand=(0, 1, 2, 3)),
            dict(expand=(4, 5, 8, 9), lsb=(0, 3, 6, 7))]
INT_SIZES = [256, 512, 1024, 2048, 4096, 8192, 16384]


def _int_launch(n, gos=False):
    """The launch name of Kernel F (or G) at frames of n: the row plan up to
    1024, the mid-size route (csrc/int_mid.cu) up to 16384."""
    return f"chain_int{'_gos' if gos else ''}{'' if n <= 1024 else '_mid'}"


@pytest.mark.parametrize("n", INT_SIZES)
@pytest.mark.parametrize("regs", INT_REGS)
@pytest.mark.parametrize("fft", INT_FFTS)
def test_chain_int_matches_reference(dev, n, regs, fft):
    cfg = _cfg(n)
    fft_cfg = _fft(n, **fft)
    x = _int_iq((9, n), dev, seed=n)
    rt = rsp.RuntimeConfig.make(**{"fft_size": n, **regs})
    before = _build.LAUNCHES[_int_launch(n)]
    got = kint.chain_int(x, rt, fft_cfg, cfg.cfar)
    assert _build.LAUNCHES[_int_launch(n)] == before + 1
    _assert_exact(got, kint.chain_int_reference(x, rt, fft_cfg, cfg.cfar))


@pytest.mark.parametrize("n", INT_SIZES)
def test_chain_int_routes_by_frame_size(dev, n, monkeypatch):
    """Frames of 256-1024 take the row-plan entry, 2048-16384 the mid-size
    entry (csrc/int_mid.cu); full-scale frames through four expanding stages
    saturate the square sums, exact on both routes."""
    symbols = []
    kernel = kint._int_kernel

    def record(name, symbol, *args):
        symbols.append(symbol)
        return kernel(name, symbol, *args)

    monkeypatch.setattr(kint, "_int_kernel", record)
    cfg = _cfg(n)
    fft_cfg = _fft(n, expand=(0, 1, 2, 3))
    x = _int_iq((6, n), dev, seed=n + 5)
    rt = rsp.RuntimeConfig.make(fft_size=n, mag_mode=1, div_sum=0,
                                peak_grouping=1)
    got = kint.chain_int(x, rt, fft_cfg, cfg.cfar)
    assert symbols == ["rsp_chain_int_rows" if n <= 1024 else "rsp_int_mid"]
    want = kint.chain_int_reference(x, rt, fft_cfg, cfg.cfar)
    _assert_exact(got, want)
    assert bool((want.threshold < 0).any())   # the sums and products wrap


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
    before = _build.LAUNCHES[_int_launch(n, True)]
    got = kint.chain_int_gos(x, rt, fft_cfg, cfg.cfar)
    assert _build.LAUNCHES[_int_launch(n, True)] == before + 1
    _assert_exact(got, kint.chain_int_gos_reference(x, rt, fft_cfg, cfg.cfar))


# the warp selection's edge cases on int32 (the CPU twins are in
# tests/test_torch_int_kernels.py): (registers over GOS, frames, expanding
# FFT stages). Full-scale frames through 5 or 7 expanding stages saturate
# the square sum to INT32_MAX, the padding's value, in a third or more of
# the cells; impulses give all-equal magnitudes
INT_GOS_EDGES = {
    "SQR saturated, high ranks": (
        dict(mag_mode=1, ref_window_size=16, guard_window_size=2,
             index_lagg=15, index_lead=12), "full", 5),
    "SQR saturated, ranks 0 / 8, cut": (
        dict(mag_mode=1, ref_window_size=16, guard_window_size=4,
             index_lagg=0, index_lead=8, cfar_fft_size=180), "full", 7),
    "all equal": (dict(ref_window_size=8, guard_window_size=2, index_lagg=3,
                       index_lead=7), "impulses", 0),
    "ranks 0 / w - 1, cut": (
        dict(ref_window_size=16, guard_window_size=3, index_lagg=0,
             index_lead=15, cfar_fft_size=200), "random", 0),
    "w 2": (dict(ref_window_size=2, guard_window_size=1, index_lagg=1,
                 index_lead=0, peak_grouping=1), "random", 0),
    "w 64, cut": (dict(ref_window_size=64, guard_window_size=8,
                       index_lagg=63, index_lead=40, cfar_fft_size=230),
                  "random", 0),
    "w 64, SQR saturated": (
        dict(mag_mode=1, ref_window_size=64, guard_window_size=5,
             index_lagg=50, index_lead=10), "full", 5),
}


@pytest.mark.parametrize("n", [256, 1024, 4096, 16384])
@pytest.mark.parametrize("case", list(INT_GOS_EDGES))
def test_chain_int_gos_is_exact_at_selection_edges(dev, n, case):
    regs, frames, expanding = INT_GOS_EDGES[case]
    if frames == "impulses":
        re = torch.zeros(3, n, dtype=torch.int32, device=dev)
        re[:, 0] = torch.tensor([1000, 2000, 3000], dtype=torch.int32)
        x = rsp.C(re, torch.zeros_like(re))
    else:
        x = _int_iq((5, n), dev, seed=n + 3,
                    amp=32767 if frames == "full" else 30000)
    cfg = _gos_cfg(n)
    fft_cfg = _fft(n, expand=tuple(range(expanding)))
    rt = rsp.RuntimeConfig.make(**{"fft_size": n, **GOS, **regs})
    before = _build.LAUNCHES[_int_launch(n, True)]
    got = kint.chain_int_gos(x, rt, fft_cfg, cfg.cfar)
    assert _build.LAUNCHES[_int_launch(n, True)] == before + 1
    _assert_exact(got, kint.chain_int_gos_reference(x, rt, fft_cfg,
                                                    cfg.cfar))


# ---- Kernels D and G on the row plan: part-filled blocks ----

# frames a block of the row plan (csrc/row_fft.cuh RspRowPlan::kRows)
ROW_FRAMES = {256: 16, 512: 8, 1024: 4}
PART_FRAMES = ["1", "3", "rows + 1", "headline"]


def _part_count(n, frames):
    """1, 3 or kRows + 1 frames, or the headline's 64 x 256 x 1024 samples
    as frames of n."""
    return {"1": 1, "3": 3, "rows + 1": ROW_FRAMES[n] + 1,
            "headline": 64 * 256 * 1024 // n}[frames]


def _by_frames(fn, x, step=2048):
    """``fn`` over chunks of ``step`` frames of ``x``, outputs concatenated:
    the plain GOS version's window stacks at the headline."""
    outs = [fn(rsp.C(x.re[k:k + step], x.im[k:k + step]))
            for k in range(0, x.shape[0], step)]
    return rsp.CfarOutput(threshold=torch.cat([o.threshold for o in outs]),
                          peaks=torch.cat([o.peaks for o in outs]))


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("frames", PART_FRAMES)
@pytest.mark.parametrize("regs", [
    dict(), dict(cfar_mode=3, sub_window_size=8),
    dict(cfar_algorithm=0, cfar_mode=1, peak_grouping=1)],
    ids=["GOS", "CASH sub_w 8", "CA sums"])
def test_chain_gos_row_plan_over_part_filled_blocks(dev, n, frames, regs):
    """Kernel D at frame counts that leave the last block of the row plan
    part filled (a served request's one frame, 3, kRows + 1) and at the
    headline: the dead frames' threads take part in the selection's
    barriers and write nothing."""
    cfg = _gos_cfg(n)
    count = _part_count(n, frames)
    x = _iq((count + 1, n), dev, seed=count)
    sub = rsp.C(x.re[:count], x.im[:count])
    rt = rsp.RuntimeConfig.make(**{"fft_size": n, **GOS, **regs})
    before = _build.LAUNCHES["chain_gos"]
    got = kchain.chain_gos(sub, rt, cfg.fft, cfg.cfar)
    assert _build.LAUNCHES["chain_gos"] == before + 1
    assert got.threshold.shape == (count, n)
    _assert_close(got, _by_frames(lambda c: kchain.chain_gos_reference(
        c, rt, cfg.fft, cfg.cfar), sub))
    assert _build.BUILDS == 1


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("frames", PART_FRAMES)
@pytest.mark.parametrize("regs", [
    dict(), dict(cfar_algorithm=0, cfar_mode=1, mag_mode=1, div_sum=0)],
    ids=["GOS", "CA sums"])
def test_chain_int_gos_row_plan_over_part_filled_blocks(dev, n, frames, regs,
                                                        monkeypatch):
    """Kernel G's frames of 256-1024 take the row-plan entry, exact at part
    filled blocks and at the headline."""
    symbols = []
    kernel = kint._int_kernel

    def record(name, symbol, *args):
        symbols.append(symbol)
        return kernel(name, symbol, *args)

    monkeypatch.setattr(kint, "_int_kernel", record)
    cfg = _gos_cfg(n)
    count = _part_count(n, frames)
    x = _int_iq((count, n), dev, seed=count, amp=30000)
    rt = rsp.RuntimeConfig.make(**{"fft_size": n, **GOS, **regs})
    got = kint.chain_int_gos(x, rt, cfg.fft, cfg.cfar)
    assert symbols == ["rsp_chain_int_gos_rows"]
    _assert_exact(got, kint.chain_int_gos_reference(x, rt, cfg.fft, cfg.cfar))
    assert _build.BUILDS == 1

# ---- Kernels D and G count their peaks (CfarOutput.detections) ----

# frames of 1, 3 and 17 leave the last block part filled (at N = 256 a warp
# holds two frames, one live and one dead), 64 fill the blocks
COUNT_FRAMES = [1, 3, 17, 64]
MOST = dict(index_lagg=0, index_lead=0, threshold_scaler=0.05)
COUNT_REGS = {
    "GOS": dict(),
    "GOSCA GO, grouping": dict(cfar_mode=1, index_lagg=8, index_lead=24,
                               peak_grouping=1),
    "GOSCA SO, cut": dict(cfar_mode=2, cfar_fft_size=200),
    "CASH": dict(cfar_mode=3, sub_window_size=8),
    "CA sums, grouping": dict(cfar_algorithm=0, cfar_mode=1, peak_grouping=1),
    "most detect": MOST,
    "most detect, cut, grouping": dict(MOST, cfar_fft_size=300,
                                       peak_grouping=1),
    "most detect, CASH, cut": dict(MOST, cfar_mode=3, sub_window_size=4,
                                   cfar_fft_size=250),
    "most detect, CA sums": dict(MOST, cfar_algorithm=0),
}


def _uncounted(kernel, x, rt, cfg):
    """Kernel D (``chain_gos``) or G (``chain_int_gos``) through its C entry
    with a null counter: no memset and no atomics."""
    import ctypes

    from rsp_chains_tpu_torch.ops.fft import fft_scale

    n, P, I = x.shape[-1], ctypes.c_void_p, ctypes.c_int
    if kernel == "chain_gos":
        fn = kcfar.entry("rsp_chain_gos", P, I, ctypes.c_float,
                         kcfar.GosRegs, P)
        return kcfar.launch(kernel, x, fn,
                            kchain._row_twiddles(n, x.device).data_ptr(),
                            n.bit_length() - 1, fft_scale(n, cfg.fft),
                            kcfar.gos_registers(rt, cfg.cfar, n), None)
    fn = kcfar.entry("rsp_chain_int_gos_rows", P, I, I, I, kint.IntRegs, P)
    return kcfar.launch(kernel, x, fn,
                        kint._int_twiddles(n, x.device).data_ptr(),
                        n.bit_length() - 1, *kint.fft_masks(cfg.fft, n),
                        kint.int_registers(rt, cfg.cfar, n), None,
                        dtype=torch.int32)


def _counted_run(kernel, n, frames, regs, zeros=False):
    """(the wrapper's output, the null counter's, the plain version's) of D
    or G over ``frames`` frames of n."""
    cfg = _gos_cfg(n)
    rt = rsp.RuntimeConfig.make(**{"fft_size": n, **GOS, **regs})
    if kernel == "chain_gos":
        x = _iq((frames, n), torch.device("cuda", 0), seed=frames + n)
        run, plain = kchain.chain_gos, kchain.chain_gos_reference
    else:
        x = _int_iq((frames, n), torch.device("cuda", 0), seed=frames + n,
                    amp=30000)
        run, plain = kint.chain_int_gos, kint.chain_int_gos_reference
    if zeros:
        x = rsp.C(torch.zeros_like(x.re), torch.zeros_like(x.im))
    before = _build.LAUNCHES[kernel]
    got = run(x, rt, cfg.fft, cfg.cfar)
    assert _build.LAUNCHES[kernel] == before + 1
    return (got, _uncounted(kernel, x, rt, cfg),
            _by_frames(lambda c: plain(c, rt, cfg.fft, cfg.cfar), x))


def _assert_counted(got, uncounted):
    """The kernel's count equals the sum of its peaks, and thresholds and
    peaks equal the null counter's byte for byte."""
    torch.cuda.synchronize()
    assert uncounted.detections is None
    assert got.detections.dtype == torch.int64 and got.detections.dim() == 0
    assert got.detections.device == got.peaks.device
    assert int(got.detections.item()) == int(got.peaks.sum().item())
    assert torch.equal(got.threshold.view(torch.int32),
                       uncounted.threshold.view(torch.int32))
    assert torch.equal(got.peaks, uncounted.peaks)


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("frames", COUNT_FRAMES)
@pytest.mark.parametrize("case", list(COUNT_REGS))
@pytest.mark.parametrize("kernel", ["chain_gos", "chain_int_gos"])
def test_kernels_d_and_g_count_their_peaks(dev, kernel, n, frames, case):
    if kernel == "chain_int_gos" and COUNT_REGS[case].get("cfar_mode") == 3:
        pytest.skip("G has no CASH datapath: the integer ops run CASH")
    got, uncounted, want = _counted_run(kernel, n, frames, COUNT_REGS[case])
    _assert_counted(got, uncounted)
    if kernel == "chain_gos":
        _assert_close(got, want)
    else:
        _assert_exact(got, want)
    active = min(int(COUNT_REGS[case].get("cfar_fft_size", n)), n)
    if case.startswith("most"):
        # most active cells detect; with grouping, most local maxima
        share = 0.2 if "grouping" in case else 0.5
        assert int(got.detections.item()) > share * frames * active


@pytest.mark.parametrize("n", [256, 512, 1024])
@pytest.mark.parametrize("frames", [1, 17])
@pytest.mark.parametrize("case", ["GOS", "CASH", "CA sums, grouping"])
@pytest.mark.parametrize("kernel", ["chain_gos", "chain_int_gos"])
def test_kernels_d_and_g_count_zero_on_an_all_zero_cpi(dev, kernel, n,
                                                       frames, case):
    if kernel == "chain_int_gos" and case == "CASH":
        pytest.skip("G has no CASH datapath: the integer ops run CASH")
    got, uncounted, want = _counted_run(kernel, n, frames, COUNT_REGS[case],
                                        zeros=True)
    _assert_counted(got, uncounted)
    assert int(got.detections.item()) == 0
    assert torch.equal(got.peaks, want.peaks)


def test_kernels_d_and_g_on_no_frames_make_no_count(dev):
    cfg = _gos_cfg(1024)
    rt = rsp.RuntimeConfig.make(fft_size=1024, **GOS)
    x = _iq((0, 1024), dev)
    assert kchain.chain_gos(x, rt, cfg.fft, cfg.cfar).detections is None
    xi = _int_iq((0, 1024), dev)
    assert kint.chain_int_gos(xi, rt, cfg.fft, cfg.cfar).detections is None


@pytest.mark.parametrize("bit_true", [False, True], ids=["float", "bit-true"])
def test_streamed_counts_equal_the_peaks_across_ca_and_gos_registers(
        dev, bit_true):
    """A stream whose registers switch between CA (Kernel A or F, summed by
    ``peaks.sum``) and GOS (Kernel D or G, counted by the kernel): every
    delivered count equals its CPI's peaks, and the kernel counted exactly
    the GOS CPIs."""
    from rsp_chains_tpu_torch.io import StreamingPipeline

    cfg = rsp.ChainConfig()
    if bit_true:
        cfg = dataclasses.replace(cfg, fixed_point=rsp.FixedPointConfig(
            enabled=True, width=16, bin_point=0, bit_true=True))
    chain = rsp.fft_mag_cfar_chain(cfg)
    ca = rsp.RuntimeConfig.make(fft_size=1024, div_sum=5)
    gos = ca.merge_regs(**GOS)
    regs = [gos, ca, gos, gos, ca, ca, gos, ca]
    schedule = iter(regs)
    cpis = [np.round(c * 250) for c in _stream_cpis(len(regs),
                                                    shape=(16, 1024))]
    got = {}

    def keep(seq, out, m):
        got[seq] = (m.detections, int(out.peaks.sum().item()),
                    out.detections is not None)

    pipe = StreamingPipeline(lambda x, rt: chain(x, next(schedule)), None,
                             on_result=keep, device=dev)
    _build.LAUNCHES.clear()
    with pipe:
        for s, c in enumerate(cpis):
            pipe.submit(s, c)
        _wait_for(lambda: len(got) == len(cpis), "every CPI")
    assert pipe.stats.frames_failed == 0
    d, a = ("chain_int_gos", "chain_int") if bit_true else ("chain_gos",
                                                             "chain_ca")
    n_gos = sum(r is gos for r in regs)
    assert _build.LAUNCHES[d] == n_gos
    assert _build.LAUNCHES[a] == len(regs) - n_gos
    for s, r in enumerate(regs):
        assert got[s][0] == got[s][1], s
        assert got[s][2] == (r is gos), s
    assert pipe.stats.phase_totals()["n_kernel_counts"] == n_gos
    assert pipe.detections_total == sum(g[1] for g in got.values())


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


# ---- Kernels F and G at N = 2048-16384: the mid-size route (int_mid.cu) ----

@pytest.mark.parametrize("n", [2048, 4096, 8192, 16384])
@pytest.mark.parametrize("frames", [1, 3, 6])
@pytest.mark.parametrize("fft", [dict(), dict(expand=(0, 1, 9), lsb=(2,)),
                                 dict(lsb=(0, 5)),
                                 dict(expand=tuple(range(7)))])
def test_mid_route_is_exact_over_part_filled_blocks_and_stage_flags(
        dev, n, frames, fft):
    """Frame counts that leave the last block part filled (4 frames a block
    at 2048, 2 at 4096), stage 0 expanding or keeping the LSB (at 16384 the
    stage each block of the cluster runs on both halves), full-scale frames;
    F, G and G's algorithm 0 through ``fft_mag_cfar_chain``, one launch
    each, exact against the integer ops."""
    x = _int_iq((frames, n), dev, seed=n % 83 + frames, amp=32767)
    for variant, regs, kernel in (
            (rsp.CfarVariant.CA, dict(cfar_algorithm=0, peak_grouping=1,
                                      cfar_fft_size=n - 100), "chain_int_mid"),
            (rsp.CfarVariant.GOSCA, dict(), "chain_int_gos_mid"),
            (rsp.CfarVariant.GOSCA, dict(cfar_algorithm=0, cfar_mode=1),
             "chain_int_mid")):
        cfg = dataclasses.replace(_split_cfg(variant, n), fft=_fft(n, **fft))
        chain = rsp.fft_mag_cfar_chain(cfg)
        rt = rsp.RuntimeConfig.make(**{"fft_size": n, **GOS, **regs})
        before = dict(_build.LAUNCHES)
        got = chain(x, rt)
        after = dict(_build.LAUNCHES)
        assert {k: after[k] - before.get(k, 0) for k in after
                if after[k] != before.get(k, 0)} == {kernel: 1}
        _assert_exact(got, kint.int_ops_chain(x, rt, cfg))


def test_mid_route_register_writes_build_once(dev):
    for n in (2048, 16384):
        chain = rsp.fft_mag_cfar_chain(_split_cfg(rsp.CfarVariant.GOSCA, n))
        x = _int_iq((2, n), dev)
        for regs in INT_GOS_REGS + [dict(cfar_algorithm=0)]:
            chain(x, rsp.RuntimeConfig.make(**{"fft_size": n, **GOS,
                                               **regs}))
    torch.cuda.synchronize()
    assert _build.BUILDS == 1


# ---- Kernels F and G beyond N = 16384: the split route (int_split.cu) ----

# (name, the elaboration's variant, registers over GOS, the split route's
# launch name)
SPLIT_POINTS = [
    ("CA", rsp.CfarVariant.CA, dict(cfar_algorithm=0), "chain_int_split"),
    ("GO grouping, cut", rsp.CfarVariant.CA,
     dict(cfar_algorithm=0, cfar_mode=1, peak_grouping=1,
          cfar_fft_size=20000), "chain_int_split"),
    ("GOS", rsp.CfarVariant.GOSCA, dict(), "chain_int_gos_split"),
    ("GOS w64, cut, SQR", rsp.CfarVariant.GOSCA,
     dict(ref_window_size=64, guard_window_size=8, index_lagg=63,
          index_lead=5, cfar_fft_size=12345, mag_mode=1),
     "chain_int_gos_split"),
    ("GOSCA algorithm 0", rsp.CfarVariant.GOSCA, dict(cfar_algorithm=0),
     "chain_int_split"),
]


def _split_cfg(variant, n, **fft):
    return rsp.ChainConfig(
        fft=rsp.FftConfig(max_size=n, **fft),
        cfar=rsp.CfarConfig(max_ref_window=64, variant=variant,
                            include_cash=variant is rsp.CfarVariant.GOSCA,
                            max_fft_size=n),
        fixed_point=rsp.FixedPointConfig(enabled=True, width=16, bin_point=0,
                                         bit_true=True))


@pytest.mark.parametrize("n", [32768, 65536])
@pytest.mark.parametrize("point", SPLIT_POINTS, ids=[p[0] for p in
                                                     SPLIT_POINTS])
def test_bit_true_chain_beyond_the_frame_per_block_bound_is_exact(dev, n,
                                                                  point):
    """Through ``fft_mag_cfar_chain``: the split route, exact against the
    plain versions (a GOSCA elaboration's algorithm-0 registers take F's)."""
    _, variant, regs, kernel = point
    cfg = _split_cfg(variant, n)
    chain = rsp.fft_mag_cfar_chain(cfg)
    assert chain.stage_names == ("fft_mag_cfar_int_fused",)
    x = _int_iq((3, n), dev, seed=n % 97, amp=8000)
    rt = rsp.RuntimeConfig.make(**{"fft_size": n, **GOS, **regs})
    before = dict(_build.LAUNCHES)
    got = chain(x, rt)
    after = dict(_build.LAUNCHES)
    assert {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)} == {kernel: 1}
    _assert_exact(got, kint.int_ops_chain(x, rt, cfg))
    assert bool(got.peaks.any())


@pytest.mark.parametrize("n, frames", [(32768, 2), (1 << 19, 1),
                                       (1 << 20, 1)])
@pytest.mark.parametrize("fft", [dict(), dict(expand=(0, 1, 9)),
                                 dict(expand=(1, 7), lsb=(0, 12)),
                                 dict(expand=tuple(range(7)))])
def test_split_route_is_exact_at_its_stage_flags(dev, n, frames, fft):
    """Expanding and keepLSB stages in the head and the body, and one or two
    head launches (N = 2^19 and 2^20), full-scale frames; F and G."""
    x = _int_iq((frames, n), dev, seed=n % 89 + len(fft), amp=32767)
    for variant, regs in ((rsp.CfarVariant.CA, dict(cfar_algorithm=0)),
                          (rsp.CfarVariant.GOSCA, dict())):
        cfg = _split_cfg(variant, n)
        fft_cfg = _fft(n, **fft)
        rt = rsp.RuntimeConfig.make(**{"fft_size": n, **GOS, **regs})
        fn, ref = ((kint.chain_int, kint.chain_int_reference)
                   if variant is rsp.CfarVariant.CA else
                   (kint.chain_int_gos, kint.chain_int_gos_reference))
        _assert_exact(fn(x, rt, fft_cfg, cfg.cfar),
                      ref(x, rt, fft_cfg, cfg.cfar))


@pytest.mark.parametrize("variant, regs, kernel", [
    (rsp.CfarVariant.CA, dict(cfar_algorithm=0, peak_grouping=1,
                              cfar_fft_size=(1 << 18) - 3000),
     "chain_int_split"),
    (rsp.CfarVariant.GOSCA, dict(), "chain_int_gos_split"),
], ids=["F", "G"])
def test_split_route_is_exact_on_one_frame_of_2_18(dev, variant, regs,
                                                   kernel):
    """One frame of 2^18, the first size whose head takes five stages in
    one launch; expanding and keepLSB stages in the head and the body;
    exact against the plain version, one launch."""
    n = 1 << 18
    x = _int_iq((1, n), dev, seed=18, amp=20000)
    cfg = _split_cfg(variant, n)
    fft_cfg = _fft(n, expand=(1, 4, 8), lsb=(0, 5, 12))
    rt = rsp.RuntimeConfig.make(**{"fft_size": n, **GOS, **regs})
    fn, ref = ((kint.chain_int, kint.chain_int_reference)
               if kernel == "chain_int_split" else
               (kint.chain_int_gos, kint.chain_int_gos_reference))
    before = _build.LAUNCHES[kernel]
    got = fn(x, rt, fft_cfg, cfg.cfar)
    assert _build.LAUNCHES[kernel] == before + 1
    _assert_exact(got, ref(x, rt, fft_cfg, cfg.cfar))
    assert bool(got.peaks.any())


def test_split_route_register_writes_build_once(dev):
    chain = rsp.fft_mag_cfar_chain(_split_cfg(rsp.CfarVariant.GOSCA, 32768))
    x = _int_iq((2, 32768), dev)
    for regs in INT_GOS_REGS + [dict(cfar_algorithm=0)]:
        chain(x, rsp.RuntimeConfig.make(**{"fft_size": 32768, **GOS, **regs}))
    torch.cuda.synchronize()
    assert _build.BUILDS == 1


# ---- the range-Doppler family: Kernels H (rd_ca / rd_map), I (pc_ca) and
# J (rd_2d) ----

def _rd_cfg(p, n, variant=rsp.CfarVariant.CA, include_cash=False,
            window="hann", fft_shift=True, scaling=rsp.FftScaling.DIV_N):
    return rsp.ChainConfig(
        fft=rsp.FftConfig(max_size=n),
        matched_filter=rsp.MatchedFilterConfig(num_taps=128, fft_size=n),
        doppler=rsp.DopplerConfig(num_pulses=p, window=window,
                                  fft_shift=fft_shift, scaling=scaling),
        cfar=rsp.CfarConfig(max_ref_window=64, max_fft_size=n,
                            variant=variant, include_cash=include_cash))


TAPS = rsp.golden.lfm_chirp(128, 0.0, 0.25)


def _cpi(shape, dev, seed=0):
    """CPIs with a moving chirp target at range 40 over noise."""
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape) + 1j * rng.randn(*shape)
    x[..., 40:168] += 3 * TAPS * np.exp(0.7j * np.arange(shape[-2]))[:, None]
    return rsp.as_pair(x.astype(np.complex64), device=dev)


def _assert_map_close(got, want):
    torch.cuda.synchronize()
    err = max((got.re - want.re).abs().max().item(),
              (got.im - want.im).abs().max().item())
    scale = max(want.re.abs().max().item(), want.im.abs().max().item())
    assert err / scale < 1e-4, err / scale


# every pulse count of the Doppler column plan (8 ... 512) at every range
# frame of the row plan (256, 512, 1024)
RD_SHAPES = [(p, n) for p in (8, 16, 32, 64, 128, 256, 512)
             for n in (256, 512, 1024)]


@pytest.mark.parametrize("p, n", RD_SHAPES)
@pytest.mark.parametrize("regs", REGS)
def test_rd_ca_matches_reference(dev, p, n, regs):
    cfg = _rd_cfg(p, n)
    x = _cpi((2, p, n), dev)
    rt = rsp.RuntimeConfig.make(**{"fft_size": n, **regs})
    before = _build.LAUNCHES["rd_ca"]
    got = krd.fused_rd_chain(x, rt, TAPS, cfg)
    assert _build.LAUNCHES["rd_ca"] == before + 1
    _assert_close(got, krd.fused_rd_chain_reference(x, rt, TAPS, cfg))


@pytest.mark.parametrize("p, n", RD_SHAPES)
@pytest.mark.parametrize("window, fft_shift, scaling", [
    ("hann", True, rsp.FftScaling.DIV_N),
    (None, False, rsp.FftScaling.NONE),
    ("taylor", True, rsp.FftScaling.SQRT_N),
])
def test_rd_map_matches_reference(dev, p, n, window, fft_shift, scaling):
    cfg = _rd_cfg(p, n, window=window, fft_shift=fft_shift, scaling=scaling)
    x = _cpi((3, p, n), dev, seed=1)
    rt = rsp.RuntimeConfig.make(fft_size=n)
    before = _build.LAUNCHES["rd_map"]
    got = krd.fused_rd_chain(x, rt, TAPS, cfg, emit="map")
    assert _build.LAUNCHES["rd_map"] == before + 1
    _assert_map_close(got, krd.fused_rd_chain_reference(x, rt, TAPS, cfg,
                                                        emit="map"))


# the row launch takes 256 / (N / 16) rows a block: CPI batches whose rows
# leave the last block part empty
@pytest.mark.parametrize("batch, p, n", [(1, 8, 256), (3, 8, 256),
                                         (5, 8, 512), (1, 16, 1024)])
@pytest.mark.parametrize("emit", ["cfar", "map"])
def test_rd_rows_of_a_part_filled_block(dev, batch, p, n, emit):
    cfg = _rd_cfg(p, n)
    x = _cpi((batch, p, n), dev, seed=batch)
    rt = rsp.RuntimeConfig.make(fft_size=n, peak_grouping=1)
    name = "rd_ca" if emit == "cfar" else "rd_map"
    before = _build.LAUNCHES[name]
    got = krd.fused_rd_chain(x, rt, TAPS, cfg, emit=emit)
    assert _build.LAUNCHES[name] == before + 1
    want = krd.fused_rd_chain_reference(x, rt, TAPS, cfg, emit=emit)
    if emit == "map":
        _assert_map_close(got, want)
    else:
        _assert_close(got, want)


def _pc_cfg(n):
    return rsp.ChainConfig(
        fft=rsp.FftConfig(max_size=n),
        matched_filter=rsp.MatchedFilterConfig(num_taps=128, fft_size=n),
        cfar=rsp.CfarConfig(max_ref_window=64, max_fft_size=n,
                            variant=rsp.CfarVariant.CA, include_cash=False))


@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("regs", REGS)
def test_pc_ca_matches_reference(dev, n, regs):
    from rsp_chains_tpu_torch.ops.matched_filter import h_planes

    cfg = _pc_cfg(n)
    x = _cpi((11, n), dev, seed=2)
    h = h_planes(TAPS, n, True, dev)
    rt = rsp.RuntimeConfig.make(**{"fft_size": n, **regs})
    before = _build.LAUNCHES["pc_ca"]
    got = kchain.pc_ca(x, rt, cfg.fft, cfg.cfar, h)
    assert _build.LAUNCHES["pc_ca"] == before + 1
    _assert_close(got, kchain.pc_ca_reference(x, rt, cfg.fft, cfg.cfar, h))


@pytest.mark.parametrize("n", [256, 2048, 4096])
@pytest.mark.parametrize("frames", [1, 3, 17])
def test_pc_ca_part_filled_block(dev, n, frames):
    """Kernel I packs 256 / (N / 16) frames a block: 16 at 256, 2 at 2048,
    one at 4096; a block's rows past the last frame write nothing."""
    from rsp_chains_tpu_torch.ops.matched_filter import h_planes

    cfg = _pc_cfg(n)
    x = _cpi((frames, n), dev, seed=frames)
    h = h_planes(TAPS, n, True, dev)
    rt = rsp.RuntimeConfig.make(fft_size=n, peak_grouping=1)
    got = kchain.pc_ca(x, rt, cfg.fft, cfg.cfar, h)
    assert got.threshold.shape == (frames, n)
    _assert_close(got, kchain.pc_ca_reference(x, rt, cfg.fft, cfg.cfar, h))


def test_mag_cfar_and_pc_ca_register_writes_build_once(dev):
    from rsp_chains_tpu_torch.ops.matched_filter import h_planes

    cfg = _pc_cfg(4096)
    x = _cpi((3, 4096), dev)
    h = h_planes(TAPS, 4096, True, dev)
    for regs in SWEEP13:
        rt = rsp.RuntimeConfig.make(**{"fft_size": 4096, **regs})
        kchain.pc_ca(x, rt, cfg.fft, cfg.cfar, h)
        kcfar.mag_cfar(x, rt, cfg.cfar)
    torch.cuda.synchronize()
    assert _build.BUILDS == 1


RD2_REGS = [
    dict(ref_range=8, guard_range=2, ref_doppler=4, guard_doppler=1,
         threshold_scaler=6.0),
    dict(ref_range=16, guard_range=4, ref_doppler=8, guard_doppler=2,
         threshold_scaler=4.0, peak_grouping=1),
    dict(ref_range=1, guard_range=0, ref_doppler=1, guard_doppler=0,
         threshold_scaler=3.0),
    dict(ref_range=4, guard_range=1, ref_doppler=2, guard_doppler=1,
         threshold_scaler=2.0, log_or_linear=0, active_range=768),
    dict(ref_range=8, guard_range=2, ref_doppler=4, guard_doppler=1,
         threshold_scaler=6.0, active_range=200, peak_grouping=1),
]


@pytest.mark.parametrize("p, n", RD_SHAPES)
@pytest.mark.parametrize("regs2", RD2_REGS)
@pytest.mark.parametrize("mag_mode", [2, 3])
def test_rd_2d_matches_reference(dev, p, n, regs2, mag_mode):
    cfg = _rd_cfg(p, n)
    cfg2d = rsp.Cfar2dConfig()
    x = _cpi((2, p, n), dev, seed=3)
    rt = rsp.RuntimeConfig.make(fft_size=n, mag_mode=mag_mode)
    rt2 = rsp.Cfar2dRuntime.make(**regs2)
    before = _build.LAUNCHES["rd_2d"]
    got = krd.fused_rd_2d_chain(x, rt, rt2, TAPS, cfg, cfg2d)
    assert _build.LAUNCHES["rd_2d"] == before + 1
    _assert_close(got, krd.fused_rd_2d_chain_reference(x, rt, rt2, TAPS, cfg,
                                                       cfg2d))


def test_rd_2d_clamps_raw_register_writes(dev):
    cfg = _rd_cfg(64, 1024)
    cfg2d = rsp.Cfar2dConfig(max_ref_range=8, max_guard_range=2,
                             max_ref_doppler=4, max_guard_doppler=1)
    x = _cpi((2, 64, 1024), dev, seed=4)
    rt = rsp.RuntimeConfig.make(fft_size=1024)
    rt2 = dataclasses.replace(
        rsp.Cfar2dRuntime.make(ref_range=8, guard_range=2, ref_doppler=4,
                               guard_doppler=1, threshold_scaler=5.0),
        ref_range=40, guard_range=-3, ref_doppler=0, guard_doppler=9,
        active_range=5000)
    got = krd.fused_rd_2d_chain(x, rt, rt2, TAPS, cfg, cfg2d)
    _assert_close(got, krd.fused_rd_2d_chain_reference(x, rt, rt2, TAPS, cfg,
                                                       cfg2d))


@pytest.mark.parametrize("p", [8, 16, 64, 128, 512])
@pytest.mark.parametrize("ref_doppler, guard_doppler", [
    (52, 8), (64, 16), (250, 5), (600, 0)])
def test_rd_2d_takes_any_doppler_reach(dev, p, ref_doppler, guard_doppler):
    # Doppler reaches past any fixed tile halo, up to one wider than the CPI
    cfg = _rd_cfg(p, 1024)
    cfg2d = rsp.Cfar2dConfig(max_ref_doppler=ref_doppler,
                             max_guard_doppler=guard_doppler)
    x = _cpi((2, p, 1024), dev, seed=9)
    rt = rsp.RuntimeConfig.make(fft_size=1024)
    rt2 = rsp.Cfar2dRuntime.make(ref_range=16, guard_range=4,
                                 ref_doppler=ref_doppler,
                                 guard_doppler=guard_doppler,
                                 threshold_scaler=2.5, peak_grouping=1)
    before = _build.LAUNCHES["rd_2d"]
    got = krd.fused_rd_2d_chain(x, rt, rt2, TAPS, cfg, cfg2d)
    assert _build.LAUNCHES["rd_2d"] == before + 1
    _assert_close(got, krd.fused_rd_2d_chain_reference(x, rt, rt2, TAPS, cfg,
                                                       cfg2d))


# the detector's edge cases (csrc/cfar_2d.cuh), each at a CPI whose map has
# one 32-row tile cut by its end (P = 8, 16), whole tiles (64) and many
# (256): g = 0, w = 1, an active range clipped on both sides (active_lo is
# set in the register struct; the registers leave it at 0), grouping at a
# scaler low enough that the map's edges and tile seams hold peaks
RD2_EDGES = {
    "g 0": (dict(ref_range=8, guard_range=0, ref_doppler=4, guard_doppler=0,
                 threshold_scaler=3.0), 0, None),
    "w 1": (dict(ref_range=1, guard_range=2, ref_doppler=1, guard_doppler=1,
                 threshold_scaler=3.0), 0, None),
    "clipped both sides": (dict(ref_range=8, guard_range=2, ref_doppler=4,
                                guard_doppler=1, threshold_scaler=2.0,
                                peak_grouping=1), 37, 200),
    "clipped inside a tile": (dict(ref_range=3, guard_range=1, ref_doppler=2,
                                   guard_doppler=1, threshold_scaler=2.0),
                              130, 141),
    "grouping at the edges": (dict(ref_range=2, guard_range=1, ref_doppler=2,
                                   guard_doppler=0, threshold_scaler=1.0,
                                   peak_grouping=1), 0, None),
}


@pytest.mark.parametrize("p", [8, 16, 64, 256])
@pytest.mark.parametrize("case", list(RD2_EDGES))
def test_rd_2d_edge_cases(dev, p, case):
    from rsp_chains_tpu_torch.ops.cfar_2d import cfar_2d_op

    regs2, lo, hi = RD2_EDGES[case]
    n = 256
    cfg = _rd_cfg(p, n)
    cfg2d = rsp.Cfar2dConfig()
    x = _cpi((2, p, n), dev, seed=p)
    rt = rsp.RuntimeConfig.make(fft_size=n)
    rt2 = rsp.Cfar2dRuntime.make(**regs2)
    regs = krd.cfar_2d_registers(rt, rt2, cfg2d, n)
    regs.active_lo = lo
    hi = regs.active_hi if hi is None else hi
    regs.active_hi = hi
    got = krd.rd_2d_launch(x, regs, TAPS, cfg)
    mag = logmag(krd.rd_front_reference(x, TAPS, cfg), rt.mag_mode)
    want = cfar_2d_op(mag, rt2, cfg2d, active_lo=lo, active_hi=hi)
    _assert_close(got, want)
    if case == "grouping at the edges":
        edges = torch.zeros_like(want.peaks)
        edges[..., 0, :] = edges[..., -1, :] = True
        edges[..., :, 0] = edges[..., :, -1] = True
        assert (want.peaks & edges).any()
        assert torch.equal(got.peaks & edges, want.peaks & edges)


def test_rd_2d_takes_more_cpis_than_a_grid_axis_of_65535(dev):
    p, n, batch = 8, 256, 65537
    cfg = _rd_cfg(p, n)
    cfg2d = rsp.Cfar2dConfig()
    rng = torch.Generator(device=dev).manual_seed(10)
    x = rsp.C(*(torch.randn(batch, p, n, device=dev, generator=rng)
                for _ in range(2)))
    rt = rsp.RuntimeConfig.make(fft_size=n)
    rt2 = rsp.Cfar2dRuntime.make(ref_range=8, guard_range=2, ref_doppler=4,
                                 guard_doppler=1, threshold_scaler=2.5)
    got = krd.fused_rd_2d_chain(x, rt, rt2, TAPS, cfg, cfg2d)
    for sl in (slice(0, 2), slice(batch - 2, batch)):
        want = krd.fused_rd_2d_chain_reference(
            rsp.C(x.re[sl], x.im[sl]), rt, rt2, TAPS, cfg, cfg2d)
        _assert_close(type(got)(threshold=got.threshold[sl],
                                peaks=got.peaks[sl]), want)


def _took(before):
    after = dict(_build.LAUNCHES)
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


def _plain(cfg):
    return dataclasses.replace(cfg, cfar=dataclasses.replace(
        cfg.cfar, use_pallas=False))


@pytest.mark.parametrize("variant, include_cash, regs, stages, kernels", [
    (rsp.CfarVariant.CA, False, dict(), ("rd_fused",), {"rd_ca": 1}),
    (rsp.CfarVariant.CA, False, dict(cfar_fft_size=768, cfar_mode=1),
     ("rd_fused",), {"rd_ca": 1}),
    (rsp.CfarVariant.GOSCA, True, GOS, ("rd_map_fused", "mag_gos_cfar_fused"),
     {"rd_map": 1, "mag_gos_cfar": 1}),
    (rsp.CfarVariant.GOSCA, True, dict(), ("rd_map_fused",
                                           "mag_gos_cfar_fused"),
     {"rd_map": 1, "mag_cfar": 1}),
])
def test_range_doppler_chain_launches_its_kernels(dev, variant, include_cash,
                                                  regs, stages, kernels):
    cfg = _rd_cfg(64, 1024, variant=variant, include_cash=include_cash)
    chain = rsp.range_doppler_chain(cfg, taps=TAPS)
    assert chain.stage_names == stages
    x = _cpi((3, 64, 1024), dev, seed=5)
    rt = rsp.RuntimeConfig.make(**{"fft_size": 1024, **regs})
    before = dict(_build.LAUNCHES)
    got = chain(x, rt)
    assert _took(before) == kernels
    plain = rsp.range_doppler_chain(_plain(cfg), taps=TAPS)
    assert plain.stage_names == ("matched_filter", "doppler_fft", "logmag",
                                 "cfar")
    _assert_close(got, plain(x, rt))


def test_range_doppler_chain_detects_the_target_cell(dev):
    p, n, delay, fd = 256, 1024, 300, 0.125
    cfg = _rd_cfg(p, n)
    cpi = rsp.golden.chirp_with_targets(p, n, TAPS, [(delay, 1.0, fd)])
    rt = rsp.RuntimeConfig.make(fft_size=n, ref_window_size=32,
                                guard_window_size=4, threshold_scaler=8.0,
                                div_sum=5, peak_grouping=1)
    out = rsp.range_doppler_chain(cfg, taps=TAPS)(cpi.astype(np.complex64), rt)
    rd = krd.fused_rd_chain(rsp.as_pair(cpi.astype(np.complex64), device=dev),
                            rt, TAPS, cfg, emit="map")
    mag = (rd.re ** 2 + rd.im ** 2).cpu().numpy()
    cell = (p // 2 + int(fd * p), delay)
    assert np.unravel_index(mag.argmax(), mag.shape) == cell
    assert bool(out.peaks[cell])


@pytest.mark.parametrize("regs, kernel", [
    (dict(), "pc_ca"), (dict(fft_size=2048), "mag_cfar")])
def test_pulse_compression_chain_launches_the_kernel_its_registers_select(
        dev, regs, kernel):
    cfg = _pc_cfg(4096)
    chain = rsp.pulse_compression_chain(cfg, taps=TAPS)
    assert chain.stage_names == ("pc_fused",)
    x = _cpi((6, 4096), dev, seed=6)
    rt = rsp.RuntimeConfig.make(**{"fft_size": 4096, **regs})
    before = dict(_build.LAUNCHES)
    got = chain(x, rt)
    assert _took(before) == {kernel: 1}
    plain = rsp.pulse_compression_chain(_plain(cfg), taps=TAPS)
    assert plain.stage_names == ("spectral_mf", "logmag", "cfar")
    _assert_close(got, plain(x, rt))


def test_rx_rd_tx_chain_launches_rd_ca(dev):
    cfg = _rd_cfg(64, 1024)
    chain = rsp.rx_rd_tx_chain(cfg, taps=TAPS)
    assert chain.stage_names == ("rx_unpack", "rd_fused", "tx_pack")
    w = _words((2, 64, 1024), dev, seed=7)
    rt = rsp.RuntimeConfig.make(fft_size=1024)
    before = dict(_build.LAUNCHES)
    got = chain(w, rt)
    assert _took(before) == {"rd_ca": 1}
    _assert_wire_bar(got, rsp.rx_rd_tx_chain(_plain(cfg), taps=TAPS)(w, rt),
                     10)


@pytest.mark.parametrize("cfg2d, kernels", [
    (rsp.Cfar2dConfig(), {"rd_2d": 1}),
    (rsp.Cfar2dConfig(max_ref_range=4, max_guard_range=1, max_ref_doppler=2,
                      max_guard_doppler=1, include_os=True), {"rd_map": 1}),
    (rsp.Cfar2dConfig(max_ref_doppler=64, max_guard_doppler=16),
     {"rd_2d": 1}),
])
def test_rd_2d_cfar_chain_launches_its_kernels(dev, cfg2d, kernels):
    cfg = _rd_cfg(64, 1024)
    run = rsp.rd_2d_cfar_chain(cfg, taps=TAPS, cfg2d=cfg2d)
    x = _cpi((2, 64, 1024), dev, seed=8)
    rt = rsp.RuntimeConfig.make(fft_size=1024)
    rt2 = rsp.Cfar2dRuntime.make(ref_range=4, guard_range=1, ref_doppler=2,
                                 guard_doppler=1, threshold_scaler=5.0,
                                 peak_grouping=1)
    before = dict(_build.LAUNCHES)
    got = run(x, rt, rt2)
    assert _took(before) == kernels
    plain = rsp.rd_2d_cfar_chain(_plain(cfg), taps=TAPS, cfg2d=cfg2d)
    assert not plain.fusable
    _assert_close(got, plain(x, rt, rt2))


def test_rd_register_writes_build_once(dev):
    cfg = _rd_cfg(64, 1024)
    x = _cpi((2, 64, 1024), dev)
    chain = rsp.range_doppler_chain(cfg, taps=TAPS)
    for regs in REGS:
        chain(x, rsp.RuntimeConfig.make(**{"fft_size": 1024, **regs}))
    run = rsp.rd_2d_cfar_chain(cfg, taps=TAPS)
    rt = rsp.RuntimeConfig.make(fft_size=1024)
    for regs2 in RD2_REGS:
        run(x, rt, rsp.Cfar2dRuntime.make(**regs2))
    torch.cuda.synchronize()
    assert _build.BUILDS == 1


def test_rd_wrappers_refuse_bad_operands(dev):
    cfg = _rd_cfg(64, 1024)
    rt = rsp.RuntimeConfig.make(fft_size=1024)
    x = _cpi((2, 64, 1024), dev)
    with pytest.raises(ValueError):
        krd.fused_rd_chain(rsp.C(x.re.double(), x.im.double()), rt, TAPS, cfg)
    with pytest.raises(ValueError):
        krd.fused_rd_chain(rsp.C(x.re, x.im.cpu()), rt, TAPS, cfg)
    with pytest.raises(ValueError, match="num_pulses"):
        krd.fused_rd_chain(rsp.C(x.re[:, :32].contiguous(),
                                 x.im[:, :32].contiguous()), rt, TAPS, cfg)
    with pytest.raises(ValueError, match="OS body"):
        krd.fused_rd_2d_chain(x, rt, rsp.Cfar2dRuntime.make(
            ref_range=2, guard_range=1, ref_doppler=1, guard_doppler=0,
            threshold_scaler=3.0), TAPS, cfg, rsp.Cfar2dConfig(
            max_ref_range=4, max_guard_range=1, max_ref_doppler=2,
            max_guard_doppler=1, include_os=True))
    h = torch.zeros(2, 4096, device=dev)
    pcfg = _pc_cfg(4096)
    with pytest.raises(ValueError, match="h must lie"):
        kchain.pc_ca(_cpi((2, 4096), dev), rt, pcfg.fft, pcfg.cfar, h.cpu())


# ---- the sharded chains: Kernels K (halo_exchange) and L (mag_extend), and
# B / C with an active range and a given magnitude ----

def _vmesh(dev, ch, rng):
    """A mesh of ch x rng virtual shards of one card."""
    return SP.make_mesh(ch, rng, [dev] * (ch * rng))


def _blocks(shards, shape, dev, seed=0, pair=False):
    g = torch.Generator(device=dev).manual_seed(seed)

    def one():
        return torch.randn(shape, device=dev, generator=g) * 3

    return [rsp.C(one(), one()) if pair else one() for _ in range(shards)]


@pytest.mark.parametrize("shards, shape, halo", [
    (4, (5, 7, 256), 128), (8, (3, 128), 128), (2, (9, 512), 37),
    (1, (4, 256), 64), (3, (6, 200), 200), (4, (0, 256), 16)])
def test_halo_exchange_matches_reference(dev, shards, shape, halo):
    blocks = _blocks(shards, shape, dev)
    before = dict(_build.LAUNCHES)
    got = khalo.halo_exchange(blocks, halo)
    assert _took(before) == ({"halo_exchange": shards} if shape[0] else {})
    torch.cuda.synchronize()
    for (gl, gr), (wl, wr) in zip(got,
                                  khalo.halo_exchange_reference(blocks, halo)):
        assert gl.device == wl.device and torch.equal(gl, wl)
        assert torch.equal(gr, wr)


@pytest.mark.parametrize("mag_mode", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("shards, shape, halo", [
    (4, (16, 256), 128), (2, (3, 5, 1024), 128), (1, (8, 384), 128),
    (5, (7, 128), 100), (4, (4, 256), 0)])
def test_mag_extend_matches_reference(dev, mag_mode, shards, shape, halo):
    blocks = _blocks(shards, shape, dev, seed=mag_mode, pair=True)
    before = dict(_build.LAUNCHES)
    got = khalo.mag_extend(blocks, halo, mag_mode)
    assert _took(before) == {"mag_extend": shards}
    want = khalo.mag_extend_reference(blocks, halo, mag_mode)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert g.shape == w.shape == shape[:-1] + (shape[-1] + 2 * halo,)
        assert (g - w).abs().max().item() <= 1e-6 * w.abs().max().item()


@pytest.mark.parametrize("lo, hi", [(128, 384), (0, 512), (0, 250),
                                    (100, 180)])
@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("regs", REGS[:5])
def test_mag_cfar_with_an_active_range_matches_reference(dev, lo, hi, given,
                                                         regs):
    cfg = _cfg(512)
    rt = rsp.RuntimeConfig.make(**{"fft_size": 512, **regs})
    spec = fft_op(_iq((11, 512), dev, seed=lo), None, cfg.fft)
    x = logmag(spec, rt.mag_mode) if given else spec
    before = dict(_build.LAUNCHES)
    got = kcfar.mag_cfar(x, rt, cfg.cfar, active_lo=lo, active_hi=hi,
                         mag_given=given)
    assert _took(before) == {"mag_cfar": 1}
    _assert_close(got, kcfar.mag_cfar_reference(
        x, rt, cfg.cfar, active_lo=lo, active_hi=hi, mag_given=given))
    assert not got.peaks[..., :lo].any() and not got.peaks[..., hi:].any()


@pytest.mark.parametrize("lo, hi", [(128, 384), (0, 768), (0, 500)])
@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("regs, raw", GOS_REGS[:4] + GOS_REGS[7:10])
def test_mag_gos_cfar_with_an_active_range_matches_reference(dev, lo, hi,
                                                             given, regs, raw):
    cfg = _gos_cfg(1024)     # 768-cell rows: a halo-extended shard's
    rt = _gos_rt(1024, regs, raw)
    spec = rsp.C(*_blocks(2, (5, 768), dev, seed=hi))
    x = logmag(spec, rt.mag_mode) if given else spec
    before = dict(_build.LAUNCHES)
    got = kcfar.mag_gos_cfar(x, rt, cfg.cfar, active_lo=lo, active_hi=hi,
                             mag_given=given)
    assert _took(before) == {"mag_gos_cfar": 1}
    _assert_close(got, kcfar.mag_gos_cfar_reference(
        x, rt, cfg.cfar, active_lo=lo, active_hi=hi, mag_given=given))


def _sharded_cfg(variant=rsp.CfarVariant.CA, include_cash=False, rdma=True,
                 n=1024):
    return rsp.ChainConfig(
        fft=rsp.FftConfig(max_size=n),
        cfar=rsp.CfarConfig(max_ref_window=64, max_fft_size=n,
                            variant=variant, include_cash=include_cash,
                            use_rdma_halo=rdma))


HL = dict(fft_size=1024, ref_window_size=32, guard_window_size=4,
          threshold_scaler=3.5, div_sum=5)


@pytest.mark.parametrize("variant, cash, rdma, regs, kernels", [
    (rsp.CfarVariant.CA, False, True, dict(),
     {"mag_extend": 4, "mag_cfar": 4}),
    (rsp.CfarVariant.CA, False, False, dict(cfar_mode=1), {"mag_cfar": 4}),
    (rsp.CfarVariant.GOSCA, True, True, GOS,
     {"mag_extend": 4, "mag_gos_cfar": 4}),
    (rsp.CfarVariant.GOSCA, True, True, dict(cfar_mode=3, sub_window_size=8),
     {"mag_extend": 4, "mag_gos_cfar": 4}),
    (rsp.CfarVariant.GOSCA, True, True, dict(),
     {"mag_extend": 4, "mag_cfar": 4}),
    (rsp.CfarVariant.GOSCA, True, False, GOS, {"mag_gos_cfar": 4}),
])
def test_range_sharded_mag_cfar_launches_its_kernels(dev, variant, cash, rdma,
                                                     regs, kernels):
    cfg = _sharded_cfg(variant, cash, rdma)
    rt = rsp.RuntimeConfig.make(**{**HL, **regs})
    spec = fft_op(_iq((6, 1024), dev, seed=3), None, cfg.fft)
    before = dict(_build.LAUNCHES)
    got = SP.range_sharded_mag_cfar(cfg, _vmesh(dev, 1, 4))(spec, rt)
    assert _took(before) == kernels
    _assert_close(got, kcfar.mag_cfar_reference(spec, rt, cfg.cfar))


@pytest.mark.parametrize("ch, rng, variant, cash, regs, kernels", [
    (1, 4, rsp.CfarVariant.CA, False, dict(),
     {"mag_extend": 4, "mag_cfar": 4}),
    (2, 2, rsp.CfarVariant.CA, False, dict(peak_grouping=1),
     {"mag_extend": 4, "mag_cfar": 4}),
    (4, 1, rsp.CfarVariant.CA, False, dict(), {"chain_ca": 4}),
    (4, 1, rsp.CfarVariant.GOSCA, True, GOS, {"chain_gos": 4}),
    (4, 1, rsp.CfarVariant.CA, False, dict(fft_size=512), {"mag_cfar": 4}),
    (2, 4, rsp.CfarVariant.GOSCA, True, GOS,
     {"mag_extend": 8, "mag_gos_cfar": 8}),
])
def test_make_sharded_pipeline_launches_its_kernels(dev, ch, rng, variant,
                                                    cash, regs, kernels):
    cfg = _sharded_cfg(variant, cash)
    rt = rsp.RuntimeConfig.make(**{**HL, **regs})
    x = _iq((8, 1024), dev, seed=4)
    before = dict(_build.LAUNCHES)
    got = SP.make_sharded_pipeline(cfg, _vmesh(dev, ch, rng))(x, rt)
    assert _took(before) == kernels
    _assert_close(got, rsp.fft_mag_cfar_chain(_plain(cfg))(x, rt))


@pytest.mark.parametrize("variant, cash, use_pallas, regs, kernels", [
    (rsp.CfarVariant.CA, False, True, dict(),
     {"rd_map": 2, "mag_extend": 4, "mag_cfar": 4}),
    (rsp.CfarVariant.GOSCA, True, True, GOS,
     {"rd_map": 2, "mag_extend": 4, "mag_gos_cfar": 4}),
    (rsp.CfarVariant.GOSCA, True, False, GOS, {}),
])
def test_make_sharded_rd_pipeline_launches_its_kernels(dev, variant, cash,
                                                       use_pallas, regs,
                                                       kernels):
    cfg = _rd_cfg(64, 1024, variant=variant, include_cash=cash)
    cfg = dataclasses.replace(cfg, cfar=dataclasses.replace(
        cfg.cfar, use_pallas=use_pallas, use_rdma_halo=True))
    rt = rsp.RuntimeConfig.make(**{**HL, **regs})
    x = _cpi((4, 64, 1024), dev, seed=9)
    before = dict(_build.LAUNCHES)
    got = SP.make_sharded_rd_pipeline(cfg, _vmesh(dev, 2, 2), TAPS)(x, rt)
    assert _took(before) == kernels
    _assert_close(got, rsp.range_doppler_chain(_plain(cfg), taps=TAPS)(x, rt))


def test_the_plain_sharded_entry_points_on_a_virtual_mesh(dev):
    """range_sharded_fir, channel_sharded and cfar_2d_halo_shard on CUDA
    blocks: the plain ops where the JAX package runs XLA, and the chain's
    kernel per channel shard."""
    mesh = _vmesh(dev, 2, 4)
    x = _iq((2, 2048), dev, seed=11)
    taps = np.exp(0.3j * np.arange(33)).astype(np.complex64)
    before = dict(_build.LAUNCHES)
    y = SP.range_sharded_fir(taps, mesh)(x)
    assert _took(before) == {}
    want = overlap_save_fir(x, taps)
    torch.cuda.synchronize()
    err = max((y.re - want.re).abs().max().item(),
              (y.im - want.im).abs().max().item())
    assert err <= 1e-5 * want.re.abs().max().item()

    chain = rsp.fft_mag_cfar_chain(_cfg(1024))
    frames = _iq((4, 1024), dev, seed=12)
    rt = rsp.RuntimeConfig.make(**HL)
    before = dict(_build.LAUNCHES)
    got = SP.channel_sharded(chain, _vmesh(dev, 4, 1))(frames, rt)
    assert _took(before) == {"chain_ca": 4}
    _assert_close(got, chain(frames, rt))

    cfg2d = rsp.Cfar2dConfig(max_ref_range=16, max_guard_range=4,
                             max_ref_doppler=8, max_guard_doppler=2)
    rt2 = rsp.Cfar2dRuntime.make(ref_range=8, guard_range=2, ref_doppler=4,
                                 guard_doppler=1, threshold_scaler=3.0)
    mag = torch.rand(2, 16, 1024, device=dev) + 0.1
    before = dict(_build.LAUNCHES)
    out = SP.gather([SP.cfar_2d_halo_shard(row, rt2, cfg2d) for row in
                     SP.scatter(mag, mesh, channels=True, ranges=True)])
    assert _took(before) == {}
    _assert_close(out, rsp.cfar_2d_op(mag, rt2, cfg2d))


def test_dryrun_multichip_on_a_virtual_mesh(dev):
    from rsp_chains_tpu_torch.parallel.dryrun import dryrun_multichip

    before = dict(_build.LAUNCHES)
    report = dryrun_multichip([dev] * 8)
    took = _took(before)
    assert took["rd_map"] == 4 and took["mag_extend"] == 2, took
    assert all(rel < 1e-3 for rel, _ in report.values()), report


SWEEP13 = [dict(), dict(fft_size=256), dict(fft_size=64), dict(mag_mode=1),
           dict(mag_mode=3, log_or_linear=0, threshold_scaler=2.0),
           dict(cfar_mode=1), dict(cfar_mode=2),
           dict(cfar_mode=3, sub_window_size=8),
           dict(cfar_algorithm=1, index_lagg=20, index_lead=20),
           dict(ref_window_size=16, guard_window_size=2, div_sum=4),
           dict(ref_window_size=64, guard_window_size=8, div_sum=6),
           dict(peak_grouping=1), dict(threshold_scaler=10.0)]


def test_sharded_tail_register_writes_build_once(dev):
    """The 13-register sweep of tests/test_no_recompile.py on the sharded
    tail, kernel halo and given magnitude included: one build."""
    cfg = _sharded_cfg(rsp.CfarVariant.GOSCA, True)
    pipe = SP.make_sharded_pipeline(cfg, _vmesh(dev, 2, 2))
    x = _iq((4, 1024), dev, seed=13)
    before = dict(_build.LAUNCHES)
    for regs in SWEEP13:
        rt = rsp.RuntimeConfig.make(**{"fft_size": 1024,
                                       "ref_window_size": 32,
                                       "guard_window_size": 4, **regs})
        _assert_close(pipe(x, rt), rsp.fft_mag_cfar_chain(_plain(cfg))(x, rt))
    took = _took(before)
    assert took["mag_extend"] == 4 * len(SWEEP13)
    assert (took.get("mag_cfar", 0) + took.get("mag_gos_cfar", 0)
            == 4 * len(SWEEP13))
    assert _build.BUILDS == 1


def test_halo_wrappers_refuse_bad_operands(dev):
    a = torch.zeros(2, 256, device=dev)
    with pytest.raises(ValueError):
        khalo.halo_exchange([a, a.double()], 16)
    with pytest.raises(ValueError):
        khalo.halo_exchange([a, torch.zeros(256, 2, device=dev).t()], 16)
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA"):
        khalo.halo_exchange([a, a.cpu()], 16)
    with pytest.raises(ValueError, match="real tensor"):
        kcfar.mag_cfar(rsp.C(a, a), rsp.RuntimeConfig.make(fft_size=256),
                       _cfg(256).cfar, mag_given=True)


# ---- several cards: the halo kernels read their neighbours' memory over
# the peer link ----

@pytest.fixture()
def cards(dev):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs two CUDA cards or more")
    return [torch.device("cuda", i) for i in range(n)]


def _spread(blocks, cards):
    return [b.to(cards[i % len(cards)]) if isinstance(b, torch.Tensor)
            else rsp.C(b.re.to(cards[i % len(cards)]),
                       b.im.to(cards[i % len(cards)]))
            for i, b in enumerate(blocks)]


def test_halo_kernels_across_cards(cards):
    blocks = _spread(_blocks(4, (64, 256), cards[0], seed=21), cards)
    got = khalo.halo_exchange(blocks, 128)
    want = khalo.halo_exchange_reference(blocks, 128)
    pairs = _spread(_blocks(4, (64, 256), cards[0], seed=22, pair=True), cards)
    ext = khalo.mag_extend(pairs, 128, 2)
    ext_want = khalo.mag_extend_reference(pairs, 128, 2)
    for d in cards:
        torch.cuda.synchronize(d)
    for (gl, gr), (wl, wr), g, w, b in zip(got, want, ext, ext_want, blocks):
        assert gl.device == b.device == g.device
        assert torch.equal(gl, wl) and torch.equal(gr, wr)
        assert (g - w).abs().max().item() <= 1e-6 * w.abs().max().item()


def test_sharded_pipelines_across_cards(cards):
    devs = [cards[i % len(cards)] for i in range(4)]
    cfg = _sharded_cfg()
    rt = rsp.RuntimeConfig.make(**HL)
    x = _iq((8, 1024), cards[0], seed=23)
    want = rsp.fft_mag_cfar_chain(_plain(cfg))(x, rt)
    for ch, rng in ((1, 4), (2, 2), (4, 1)):
        got = SP.make_sharded_pipeline(cfg, SP.make_mesh(ch, rng, devs))(x, rt)
        _assert_close(got, want)
    rd = _rd_cfg(64, 1024)
    rd = dataclasses.replace(rd, cfar=dataclasses.replace(rd.cfar,
                                                          use_rdma_halo=True))
    cpi = _cpi((2, 64, 1024), cards[0], seed=24)
    _assert_close(SP.make_sharded_rd_pipeline(rd, SP.make_mesh(2, 2, devs),
                                              TAPS)(cpi, rt),
                  rsp.range_doppler_chain(_plain(rd), taps=TAPS)(cpi, rt))


@pytest.mark.parametrize("reader", [0, 1])
def test_a_neighbours_block_is_not_reused_before_the_read(cards, reader):
    """The reader's stream is held back; the neighbour's block is freed and
    its memory handed to new work on the neighbour's stream at once. The
    halo must still hold the old cells: the neighbour's stream waits for the
    read."""
    owner = 1 - reader
    devs = [cards[0], cards[1]]
    blocks = [torch.full((256, 512), float(i + 1), device=devs[i])
              for i in range(2)]
    torch.cuda.synchronize(devs[0])
    torch.cuda.synchronize(devs[1])
    with torch.cuda.device(devs[reader]):
        torch.cuda._sleep(200_000_000)      # ~0.1 s on the reader's stream
    out = khalo.halo_exchange(blocks, 128)
    ptr = blocks[owner].data_ptr()
    blocks[owner] = None                    # freed to the owner's allocator
    with torch.cuda.device(devs[owner]):
        reused = torch.full((256, 512), -7.0, device=devs[owner])
    assert reused.data_ptr() == ptr         # the same memory, new work
    torch.cuda.synchronize(devs[0])
    torch.cuda.synchronize(devs[1])
    halo = out[reader][1 if reader == 0 else 0]
    assert torch.equal(halo, torch.full_like(halo, float(owner + 1)))


# ---- the signal sources ----

def _nco_cfg(lut, **kw):
    return rsp.NcoConfig(quantized_lut=lut != "float",
                         n_interpolation_terms=int(lut == "interpolated"),
                         **kw)


def _lfm_words(frames, n, seed=0):
    """LFM ramps of fractional words, 16 + up to 64 over a frame, each frame
    its own sweep."""
    rng = np.random.RandomState(seed)
    sweep = rng.uniform(8.0, 64.0, size=(frames, 1))
    return (16.0 + sweep * np.arange(n) / n).astype(np.float32)


@pytest.mark.parametrize("dither", [False, True])
@pytest.mark.parametrize("raster", [False, True])
@pytest.mark.parametrize("lut", ["float", "table", "interpolated"])
def test_nco_integer_words_on_the_card_equal_the_cpu(dev, lut, raster,
                                                     dither):
    """Integer-valued words below 2^24 sum exactly in any order, so the
    card's scan gives the CPU's phases and every path the CPU's samples."""
    cfg = _nco_cfg(lut, rasterized_mode=raster, dither_enable=dither)
    w = np.random.RandomState(1).randint(-40, 41, (16, 1024)).astype(
        np.float32)
    want = tnco.nco(torch.from_numpy(w), cfg, phase_offset=5.0, pair=True)
    got = tnco.nco(torch.from_numpy(w).to(dev), cfg, phase_offset=5.0,
                   pair=True)
    torch.cuda.synchronize()
    assert got.re.device.type == "cuda"
    for g, c in ((got.re, want.re), (got.im, want.im)):
        if lut == "float":
            # cos and sin on the card round within a few ulps of the CPU's
            assert (g.cpu() - c).abs().max().item() <= 1e-5 * cfg.amplitude
        else:
            assert torch.equal(g.cpu(), c)


@pytest.mark.parametrize("lut", ["float", "table", "interpolated"])
def test_nco_fractional_words_on_the_card_within_the_scan_tolerance(dev, lut):
    """Fractional words (LFM ramps): the card's parallel scan and the CPU's
    sequential sum round differently. Tolerance: 32 ulps of the largest
    phase; so on the float and interpolated paths max|d| <= amplitude *
    2 pi / 2^phase_width * that + 1e-5 * amplitude. On the table path a
    sample may sit one table step from the CPU's only where the CPU's table
    position lies within that tolerance of a rounding edge, and at most
    0.5 % of the samples do (74 of 65,536 measured on an H100)."""
    cfg = _nco_cfg(lut)
    w = _lfm_words(64, 1024)
    want = tnco.nco(torch.from_numpy(w), cfg, pair=True)
    got = tnco.nco(torch.from_numpy(w).to(dev), cfg, pair=True)
    torch.cuda.synchronize()
    phase = np.cumsum(w.astype(np.float64), axis=-1)
    dphase = 32 * np.spacing(np.float32(phase.max()))
    modulus = 2 ** cfg.phase_width
    if lut != "table":
        tol = (cfg.amplitude * 2 * np.pi / modulus * dphase
               + 1e-5 * cfg.amplitude)
        for g, c in ((got.re, want.re), (got.im, want.im)):
            assert (g.cpu() - c).abs().max().item() <= tol
        return
    lut_np = tnco._lut_np(cfg.table_size, cfg.table_width)
    index = {(float(v.real), float(v.imag)): i for i, v in enumerate(lut_np)}
    g = list(zip(got.re.cpu().flatten().tolist(),
                 got.im.cpu().flatten().tolist()))
    c = list(zip(want.re.flatten().tolist(), want.im.flatten().tolist()))
    apart = {k: (index[a] - index[b]) % len(lut_np)
             for k, (a, b) in enumerate(zip(g, c)) if a != b}
    print(f"table path: {len(apart)} of {len(c)} samples one step apart")
    assert all(d in (1, len(lut_np) - 1) for d in apart.values())
    # the table position rounds half to even: the CPU's phase in table steps
    per_phase = len(lut_np) / modulus
    pos = (torch.cumsum(torch.from_numpy(w), -1).numpy().flatten()
           * np.float32(per_phase))
    edge = np.abs(pos - np.floor(pos) - 0.5) <= dphase * per_phase
    assert edge[list(apart)].all()
    assert len(apart) <= 0.005 * len(c)


@pytest.mark.parametrize("shape", [(1024,), (3, 1024), (2, 5, 7),
                                   (8, 256, 1024)])
def test_the_dither_built_on_the_card_equals_the_numpy_stream(dev, shape):
    got = tnco.dither_stream(0x5EED, shape, dev)
    assert got.device.type == "cuda" and got.dtype == torch.float32
    assert np.array_equal(got.cpu().numpy(),
                          tnco.dither_stream_np(0x5EED, shape))


def _walk(shape, seed=0, scale=40.0):
    """A seeded random-walk profile: a broadband frame with a noise floor."""
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * scale).astype(np.float32)


def test_source_register_sweep_builds_once_and_launches_its_kernels(dev):
    """``nco_freq_word``, ``phase_offset`` and ``plfg_profile`` (a CUDA
    tensor) written into the float CA ``rsp_chain_vanilla``: Kernel B once a
    call, equal to the plain chain on the card; the fixed-point default
    launches nothing; ``BUILDS`` stays 1."""
    _build.library()
    cfg = _cfg(1024)
    chain = rsp.rsp_chain_vanilla(cfg)
    plain = rsp.rsp_chain_vanilla(_plain(cfg))
    default = rsp.rsp_chain_vanilla()
    assert chain.device.type == "cuda"
    assert chain.stage_names == ("plfg_nco", "fft", "mag_cfar_fused")
    walk = torch.from_numpy(_walk((8, 1024))).to(dev)
    lfm = torch.from_numpy(_lfm_words(1, 1024)[0] - 16.0).to(dev)
    points = [dict(nco_freq_word=s) for s in (8, 16, 64)]
    points += [dict(nco_freq_word=16, phase_offset=37.5),
               dict(nco_freq_word=16, plfg_profile=walk),
               dict(nco_freq_word=24, phase_offset=3.0, plfg_profile=walk),
               dict(nco_freq_word=16, plfg_profile=lfm)]
    _build.LAUNCHES.clear()
    for i, kw in enumerate(points):
        rt = rsp.RuntimeConfig.make(fft_size=1024, div_sum=5, **kw)
        got = chain(None, rt)
        assert _build.LAUNCHES["mag_cfar"] == i + 1
        # both chains run the same torch NCO and cuFFT on the card, so only
        # Kernel B and the plain magnitude + CFAR differ: the bench bar holds
        # at every point, the noiseless tones included
        want = plain(None, rt)
        _assert_close(got, want)
        if "plfg_profile" not in kw:
            peak = kw["nco_freq_word"] * 1024 // 512
            assert bool(got.peaks[peak]) and bool(want.peaks[peak])
            before = dict(_build.LAUNCHES)
            out = default(None, rt)
            assert dict(_build.LAUNCHES) == before
            assert torch.nonzero(out.peaks).flatten().tolist() == [peak]
    torch.cuda.synchronize()
    assert _build.BUILDS == 1


@pytest.mark.parametrize("regs, kernel", [
    (dict(cfar_algorithm=1, index_lagg=16, index_lead=16), "mag_gos_cfar"),
    (dict(), "mag_cfar")])
def test_source_tops_launch_b_or_c_by_the_registers(dev, regs, kernel):
    """``chain_with_mem`` and ``real_rx_chain`` at the default
    ``ChainConfig()`` (GOSCA + CASH): Kernel C under GOS registers, B under
    CA registers, each held against the plain chain on the card."""
    cfg = rsp.ChainConfig()
    rom = _iq((4, 1024), dev, seed=3)
    mem, mem_plain = (rsp.chain_with_mem(c, rom) for c in (cfg, _plain(cfg)))
    real = np.random.RandomState(4).randn(4, 1024).astype(np.float32) * 100
    real[:, ::8] += 500.0
    rx, rx_plain = (rsp.real_rx_chain(c) for c in (cfg, _plain(cfg)))
    rt = rsp.RuntimeConfig.make(fft_size=1024, div_sum=5, **regs)
    rt_rx = rt.merge_regs(cfar_fft_size=512)
    for run, ref, x, r in ((mem, mem_plain, None, rt),
                           (rx, rx_plain, real, rt_rx)):
        _build.LAUNCHES.clear()
        got = run(x, r)
        assert dict(_build.LAUNCHES) == {kernel: 1}
        _assert_close(got, ref(x, r))
    off = mem(None, rt.merge_regs(mem_start_reading=0))
    assert not off.peaks.any()


# ---- the serving plane on the card ----

def _stream_cpis(n, seed=7, shape=(4, 64, 1024)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape, np.float32)
             + 1j * rng.standard_normal(shape, np.float32)).astype(np.complex64)
            for _ in range(n)]


def _wait_for(cond, what, limit=120):
    import time

    t0 = time.time()
    while not cond():
        assert time.time() - t0 < limit, f"timed out waiting for {what}"
        time.sleep(0.002)


@pytest.mark.parametrize("block_every", [1, 4])
def test_the_pipeline_on_the_card_with_a_two_slot_ring_is_bit_equal(
        dev, block_every):
    """Host CPIs through the pinned ring of two slots, a slow consumer, the
    copy stream and the compute stream: each CPI equals a direct call on
    the card bit for bit and the plain chain within the bench bar, Kernel A
    once a CPI, and the detection total is exact."""
    import time

    from rsp_chains_tpu_torch.io import StreamingPipeline

    chain = rsp.fft_mag_cfar_chain(_cfg(1024))
    rt = rsp.RuntimeConfig.make(fft_size=1024, div_sum=5)
    cpis = _stream_cpis(12)
    got = {}

    def slow(seq, out, m):
        time.sleep(0.02)
        got[seq] = (out.threshold.clone(), out.peaks.clone())

    pipe = StreamingPipeline(chain, rt, on_result=slow,
                             block_every=block_every, detections_every=3)
    _build.LAUNCHES.clear()
    with pipe:
        for s, c in enumerate(cpis):
            pipe.submit(s, c)
        _wait_for(lambda: len(got) == len(cpis), "every CPI")
    assert _build.LAUNCHES["chain_ca"] == len(cpis)
    assert pipe.stats.frames_failed == 0 and pipe.device_error is None
    plain = rsp.fft_mag_cfar_chain(_plain(_cfg(1024)))
    total = 0
    for s, c in enumerate(cpis):
        want = chain(c, rt)
        assert torch.equal(got[s][0], want.threshold)
        assert torch.equal(got[s][1], want.peaks)
        _assert_close(rsp.CfarOutput(*got[s]), plain(c, rt))
        total += int(want.peaks.sum())
    assert pipe.flush_detections() == total


def test_the_chain_server_on_kernel_a_answers_direct_words(dev):
    """Each served frame's words equal a direct call's bit for bit and the
    plain chain's within the wire bar."""
    from rsp_chains_tpu_torch import packing
    from rsp_chains_tpu_torch.io import native
    from rsp_chains_tpu_torch.io.server import ChainServer, request_frames

    chain = rsp.fft_mag_cfar_chain(_cfg(1024))
    rt = rsp.RuntimeConfig.make(fft_size=1024, div_sum=5)
    frames = [f * 300 for f in _stream_cpis(1, shape=(16, 1024))[0]]
    _build.LAUNCHES.clear()
    with ChainServer(chain, rt, frame_len=1024, log2_fft_size=10) as srv:
        replies = request_frames("127.0.0.1", srv.port, frames, timeout=60)
    assert _build.LAUNCHES["chain_ca"] == len(frames)
    assert [r.seq for r in replies] == list(range(len(frames)))
    plain = rsp.fft_mag_cfar_chain(_plain(_cfg(1024)))
    for r, f in zip(replies, frames):
        iq = native.unpack_iq_c64(native.pack_iq_c64(f))[None]
        d = chain(iq, rt)
        want = packing.pack_cfar_words(d.threshold[0], d.peaks[0], 10)
        np.testing.assert_array_equal(r.words, want.cpu().numpy().view(
            np.uint32))
        p = plain(iq, rt)
        _assert_wire_bar(torch.from_numpy(r.words.view(np.int32)).to(
            want.device), packing.pack_cfar_words(p.threshold[0],
                                                  p.peaks[0], 10), 10)


def test_a_mid_stream_poke_lands_whole_at_one_cpi_boundary(dev):
    from rsp_chains_tpu_torch.io import StreamingPipeline
    from rsp_chains_tpu_torch.io.control import ControlServer, poke

    chain = rsp.fft_mag_cfar_chain(_cfg(1024))
    rt = rsp.RuntimeConfig.make(fft_size=1024, div_sum=5)
    go = rt.merge_regs(cfar_mode=1)
    cpis = _stream_cpis(16, shape=(2, 64, 1024))
    got = {}
    pipe = StreamingPipeline(chain, rt, on_result=lambda s, o, m: got.__setitem__(
        s, o.threshold.clone()))
    with pipe, ControlServer(lambda: pipe.runtime, pipe.reconfigure,
                             cfar_cfg=chain.cfg.cfar,
                             update_rt=pipe.update_runtime) as srv:
        for s in range(8):
            pipe.submit(s, cpis[s])
        poke("127.0.0.1", srv.port, {"cfar_mode": 1})
        for s in range(8, 16):
            pipe.submit(s, cpis[s])
        _wait_for(lambda: len(got) == 16, "every CPI")
    plain = rsp.fft_mag_cfar_chain(_plain(_cfg(1024)))
    side = []
    for s, c in enumerate(cpis):
        old, new = chain(c, rt), chain(c, go)
        _assert_close(old, plain(c, rt))
        _assert_close(new, plain(c, go))
        assert (torch.equal(got[s], old.threshold)
                != torch.equal(got[s], new.threshold)), s
        side.append(torch.equal(got[s], new.threshold))
    switch = side.index(True)
    assert side == [False] * switch + [True] * (16 - switch) and switch <= 8
    assert _build.BUILDS == 1


# ---- two windows a warp: C, G's mid-size route and G's split tail ----

# the windows the paired selection takes (w <= 32) and the ranks at its
# edges: the lag rank k and the lead rank w - 1 - k
PAIR_WINDOWS = [1, 2, 8, 16, 32]
PAIR_RANKS = ["0", "w - 1"]


def _pair_rt(n, w, rank, **regs):
    """GOS registers at window w (guard max(1, w // 8); w = 1 with guard 0
    written raw past make()'s rules), the lag rank 0 or w - 1 and the lead
    rank its mirror."""
    k = 0 if rank == "0" else w - 1
    make_w = max(w, 2)
    rt = rsp.RuntimeConfig.make(**{
        "fft_size": n, **GOS, "ref_window_size": make_w,
        "guard_window_size": max(1, make_w // 8),
        "index_lagg": min(k, make_w - 1),
        "index_lead": min(w - 1 - k, make_w - 1), **regs})
    if w == 1:
        rt = dataclasses.replace(rt, ref_window_size=1, guard_window_size=0,
                                 index_lagg=0, index_lead=0)
    return rt


def _run_cut(n, w, g, kernel):
    """An active range ending at a run boundary of the paired schedule: the
    active cell count whose first inactive cell is the first cell of the
    fourth run of window starts (frame pairs: csrc/gos_cfar.cuh
    rsp_gos_row_pairs; run pairs: rsp_gos_stats) of the first row at 2048
    - 8192, the second half-frame at 16384, the second tile of the split
    tail."""
    if kernel == "split":           # tiles of 4096, 8 warps, run pairs
        span, base, runs = 4096, 4096, 16
    elif n >= 8192:                  # one row of 8192 a block, 32 warps
        span, base, runs = 8192, 8192 if n == 16384 else 0, 64
    else:                            # 4 or 2 rows, frame pairs
        span, base, runs = n, 0, 32 // (8192 // n // 2)
    length = span + 2 * g + w + 1
    per = -(-length // runs)
    if kernel == "split" or n >= 8192:
        per |= 1
    return base + 3 * per - g - w


@pytest.mark.parametrize("n, frames", [(256, 1), (512, 3), (1024, 4),
                                       (1280, 5)])
@pytest.mark.parametrize("w", PAIR_WINDOWS)
@pytest.mark.parametrize("rank", PAIR_RANKS)
@pytest.mark.parametrize("cut", ["frame", "inside a tile, given"])
def test_mag_gos_cfar_frame_pairs_are_exact_at_their_edges(dev, n, frames, w,
                                                           rank, cut):
    """Kernel C, a range tile of two frames a block: an odd frame count
    leaves the last block a dead half; integer spectra under SQR make every
    statistic exact and every window full of ties."""
    cfg = _gos_cfg(1024)
    spec = _int_spec((frames, n), dev, seed=31 * w + n + frames)
    rt = dataclasses.replace(_pair_rt(1024, w, rank, mag_mode=1),
                             cfar_fft_size=n)
    x, kw = spec, {}
    if cut != "frame":               # the range ends inside the last tile
        x = logmag(spec, rt.mag_mode)
        kw = dict(active_lo=37, active_hi=n - 101, mag_given=True)
    before = dict(_build.LAUNCHES)
    got = kcfar.mag_gos_cfar(x, rt, cfg.cfar, **kw)
    assert _took(before) == {"mag_gos_cfar": 1}
    _assert_equal(got, kcfar.mag_gos_cfar_reference(x, rt, cfg.cfar, **kw))


@pytest.mark.parametrize("n, frames", [(2048, 3), (4096, 3), (8192, 2),
                                       (16384, 1), (32768, 1)])
@pytest.mark.parametrize("w", PAIR_WINDOWS)
@pytest.mark.parametrize("rank", PAIR_RANKS)
@pytest.mark.parametrize("case", ["cut at a run boundary", "SQR saturated"])
def test_chain_int_gos_pairs_are_exact_at_their_edges(dev, n, frames, w, rank,
                                                      case):
    """Kernel G beyond N = 1024: frame pairs at 2048 and 4096 (3 frames
    leave a dead half), run pairs at 8192 and 16384 and in the split
    route's tail; the active range ends at a run boundary, or full-scale
    frames through seven expanding stages saturate the square sums to
    INT32_MAX, the padding's value."""
    cfg = _gos_cfg(n)
    kernel = "split" if n > 16384 else "mid"
    sat = case == "SQR saturated"
    g = 0 if w == 1 else max(1, max(w, 2) // 8)
    regs = (dict(mag_mode=1) if sat
            else dict(cfar_fft_size=_run_cut(n, w, g, kernel)))
    rt = _pair_rt(n, w, rank, **regs)
    fft_cfg = _fft(n, expand=tuple(range(7)) if sat else None)
    x = _int_iq((frames, n), dev, seed=n + w, amp=32767 if sat else 20000)
    name = "chain_int_gos_split" if kernel == "split" else "chain_int_gos_mid"
    before = dict(_build.LAUNCHES)
    got = kint.chain_int_gos(x, rt, fft_cfg, cfg.cfar)
    assert _took(before) == {name: 1}
    want = kint.chain_int_gos_reference(x, rt, fft_cfg, cfg.cfar)
    _assert_exact(got, want)
    if sat:                          # the square sums saturate
        mag = TB.mag_int_op(TB.fft_int_op(x, None, fft_cfg), rt.mag_mode)
        assert bool((mag == 2**31 - 1).any())
