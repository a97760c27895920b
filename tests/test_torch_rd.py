"""The port's range-Doppler family against the JAX package on the CPU: the
matched filter and Doppler ops, Kernel H's plain version against the JAX
``fused_rd_chain`` (Pallas in interpret mode, as the JAX package's own tests
run it), the ``range_doppler_chain`` routes, the wire top, the beamformed and
integrated presets, and the error paths. The CUDA kernel itself is checked
on the card by tests/test_torch_cuda.py.

Same seeded numpy inputs through both packages at P = 16, N = 256 (the JAX
package's own RD test size). Bar: threshold max|dthr| / max|thr| < 1e-4, and
peaks equal except at cells with |mag - thr| / max|thr| < 1e-4, where the
two FFT formulations (torch.fft against the Pallas split-matmul FFT, ~1e-6
relative) may fall on either side of the threshold. Maps: max|dmap| /
max|map| < 1e-4."""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.kernels.rd_pallas import fused_rd_chain as fused_rd_jax
from rsp_chains_tpu.ops.doppler import doppler_fft as doppler_jax
from rsp_chains_tpu.ops.matched_filter import (
    matched_filter as mf_jax, matched_filter_os as mf_os_jax,
    overlap_save_fir as os_fir_jax,
)

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.convert import (
    chain_config_from_reference, runtime_from_reference,
)
from rsp_chains_tpu_torch.kernels import _build
from rsp_chains_tpu_torch.kernels import rd as krd
from rsp_chains_tpu_torch.ops.doppler import doppler_fft
from rsp_chains_tpu_torch.ops.logmag import logmag
from rsp_chains_tpu_torch.ops.matched_filter import (
    h_natural, matched_filter, matched_filter_os, overlap_save_fir,
)

REL = 1e-4
P, N = 16, 256
TAPS = R.golden.lfm_chirp(32, 0.0, 0.25)


def _cfgs(variant=R.CfarVariant.CA, include_cash=False, window="hann",
          method="freq", mf=True, **dop):
    cfg_j = R.ChainConfig(
        fft=R.FftConfig(max_size=N),
        matched_filter=(R.MatchedFilterConfig(num_taps=len(TAPS), fft_size=N,
                                              method=method) if mf else None),
        doppler=R.DopplerConfig(num_pulses=P, window=window, **dop),
        cfar=R.CfarConfig(max_ref_window=16, max_guard_window=4,
                          max_fft_size=N, variant=variant,
                          include_cash=include_cash))
    return cfg_j, chain_config_from_reference(cfg_j)


def _rts(**kw):
    regs = dict(fft_size=N, ref_window_size=8, guard_window_size=2,
                threshold_scaler=3.0, div_sum=4)
    regs.update(kw)
    rt_j = R.RuntimeConfig.make(**regs)
    return rt_j, runtime_from_reference(rt_j.peek())


def _cpi(shape=(2, P, N), seed=0):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) + 1j * rng.randn(*shape)) * 0.5
    if shape[-1] >= 128:   # a moving target at range 40, a tone at 100
        x[..., 40:72] += 4 * TAPS * np.exp(0.7j * np.arange(shape[-2]))[:, None]
        x[..., 100] += 2.0 - 1.0j
    return x.astype(np.complex64)


def _np(c):
    if isinstance(c, T.C):
        return c.re.numpy() + 1j * c.im.numpy()
    return np.asarray(c.re) + 1j * np.asarray(c.im)


def _assert_map_close(got, want):
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    assert np.abs(g - w).max() / np.abs(w).max() < REL


def _assert_cfar_close(got, want, mag):
    thr_w = np.asarray(want.threshold)
    scale = np.abs(thr_w).max()
    assert got.threshold.shape == thr_w.shape
    assert np.abs(got.threshold.numpy() - thr_w).max() / scale < REL
    assert got.peaks.dtype == torch.bool
    diff = got.peaks.numpy() != np.asarray(want.peaks)
    near = np.abs(np.asarray(mag) - thr_w) / scale < REL
    assert not (diff & ~near).any(), int((diff & ~near).sum())


@functools.lru_cache(maxsize=None)
def _jax_rd(cfg_j, emit):
    """The JAX kernel, jitted once per elaboration (registers are traced)."""
    return jax.jit(lambda x, rt: fused_rd_jax(x, rt, TAPS, cfg_j,
                                              interpret=True, emit=emit))


@functools.lru_cache(maxsize=None)
def _jax_rd_chain(cfg_j, with_taps):
    """The JAX ``range_doppler_chain`` and its jitted call, built once per
    elaboration (registers are traced)."""
    chain = R.range_doppler_chain(cfg_j, taps=TAPS if with_taps else None)
    return chain, chain.jit()


def _mag(x, rt, cfg_t):
    return logmag(krd.rd_front_reference(T.as_pair(x), TAPS, cfg_t),
                  rt.mag_mode).numpy()


# ---- ops ----

@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("m", [1, 32, 256])
def test_matched_filter_matches_jax(normalize, m):
    x = _cpi((3, N))
    taps = R.golden.lfm_chirp(m, 0.05, 0.3)
    cfg_j = R.MatchedFilterConfig(num_taps=m, fft_size=N, normalize=normalize)
    cfg_t = T.MatchedFilterConfig(num_taps=m, fft_size=N, normalize=normalize)
    want = mf_jax(R.as_pair(x), taps, cfg_j)
    _assert_map_close(matched_filter(T.as_pair(x), taps, cfg_t), want)
    got = matched_filter(torch.from_numpy(x), taps, cfg_t)   # complex in/out
    assert got.dtype == torch.complex64
    assert np.abs(got.numpy() - _np(want)).max() / np.abs(_np(want)).max() < REL


def test_matched_filter_matches_golden_and_h_natural_matches_jax():
    from rsp_chains_tpu.golden import matched_filter_golden
    from rsp_chains_tpu.kernels.rd_pallas import _h_natural

    x = _cpi((2, N))
    want = matched_filter_golden(x.astype(np.complex128), TAPS)
    got = _np(matched_filter(T.as_pair(x), TAPS,
                             T.MatchedFilterConfig(normalize=False)))
    assert np.abs(got - want).max() / np.abs(want).max() < REL
    for normalize in (True, False):
        np.testing.assert_allclose(h_natural(TAPS, N, normalize),
                                   _h_natural(TAPS, N, normalize), rtol=1e-12)


@pytest.mark.parametrize("m, fft_size, t", [(32, 256, 1000), (7, 64, 300),
                                            (1, 16, 50)])
def test_matched_filter_os_matches_jax(m, fft_size, t):
    x = _cpi((2, t))
    taps = R.golden.lfm_chirp(m, 0.0, 0.2)
    cfg_j = R.MatchedFilterConfig(num_taps=m, fft_size=fft_size,
                                  method="overlap_save")
    cfg_t = chain_config_from_reference(
        R.ChainConfig(matched_filter=cfg_j)).matched_filter
    _assert_map_close(matched_filter_os(T.as_pair(x), taps, cfg_t),
                      mf_os_jax(R.as_pair(x), taps, cfg_j))
    _assert_map_close(overlap_save_fir(T.as_pair(x), taps, 64),
                      os_fir_jax(R.as_pair(x), taps, 64))


@pytest.mark.parametrize("window, fft_shift, scaling", [
    ("hann", True, R.FftScaling.DIV_N),
    (None, False, R.FftScaling.NONE),
    ("hamming", True, R.FftScaling.SQRT_N),
    ("taylor", False, R.FftScaling.DIV_N),
])
def test_doppler_fft_matches_jax(window, fft_shift, scaling):
    x = _cpi()
    cfg_j = R.DopplerConfig(num_pulses=P, window=window, fft_shift=fft_shift,
                            scaling=scaling)
    cfg_t = chain_config_from_reference(R.ChainConfig(doppler=cfg_j)).doppler
    _assert_map_close(doppler_fft(T.as_pair(x), cfg_t),
                      doppler_jax(R.as_pair(x), cfg_j))


# ---- Kernel H's plain version against the JAX kernel ----

RD_REGS = [
    dict(),
    dict(cfar_mode=1, peak_grouping=1),
    dict(cfar_mode=2, mag_mode=0),
    dict(mag_mode=1, threshold_scaler=6.0),
    dict(mag_mode=3, log_or_linear=0, threshold_scaler=2.0),
    dict(ref_window_size=16, guard_window_size=4, div_sum=5),
    dict(ref_window_size=2, guard_window_size=1, div_sum=1),
    dict(cfar_fft_size=200),
]


@pytest.mark.parametrize("regs", RD_REGS)
def test_fused_rd_chain_reference_matches_pallas(regs):
    cfg_j, cfg_t = _cfgs()
    rt_j, rt_t = _rts(**regs)
    x = _cpi()
    before = dict(_build.LAUNCHES)
    got = krd.fused_rd_chain(T.as_pair(x), rt_t, TAPS, cfg_t)
    assert dict(_build.LAUNCHES) == before     # a CPU tensor: the plain path
    _assert_cfar_close(got, _jax_rd(cfg_j, "cfar")(R.as_pair(x), rt_j),
                       _mag(x, rt_t, cfg_t))


@pytest.mark.parametrize("window, fft_shift, scaling", [
    ("hann", True, R.FftScaling.DIV_N),
    (None, False, R.FftScaling.SQRT_N),
])
def test_fused_rd_chain_map_matches_pallas(window, fft_shift, scaling):
    cfg_j, cfg_t = _cfgs(window=window, fft_shift=fft_shift, scaling=scaling)
    rt_j, rt_t = _rts()
    x = _cpi()
    got = krd.fused_rd_chain(T.as_pair(x), rt_t, TAPS, cfg_t, emit="map")
    _assert_map_close(got, _jax_rd(cfg_j, "map")(R.as_pair(x), rt_j))


def test_rd_fusable_matches_jax():
    from rsp_chains_tpu.kernels.rd_pallas import rd_fusable as fusable_jax

    cases = [_cfgs(), _cfgs(method="overlap_save"), _cfgs(mf=False)]
    cfg_j, _ = _cfgs()
    for p in (4, 8, 512, 1024, 12):
        cj = dataclasses.replace(cfg_j, doppler=R.DopplerConfig(num_pulses=p))
        cases.append((cj, chain_config_from_reference(cj)))
    for n in (128, 512, 2048):
        cj = dataclasses.replace(cfg_j, fft=R.FftConfig(max_size=n))
        cases.append((cj, chain_config_from_reference(cj)))
    for cj, ct in cases:
        for taps in (TAPS, R.golden.lfm_chirp(300)):
            assert krd.rd_fusable(ct, taps) == fusable_jax(cj, taps)


# ---- range_doppler_chain and rx_rd_tx_chain ----

@pytest.mark.parametrize("route, cfgs, stages", [
    ("CA", dict(), ("rd_fused",)),
    ("GOSCA map", dict(variant=R.CfarVariant.GOSCA, include_cash=True),
     ("rd_map_fused", "mag_gos_cfar_fused")),
    ("no matched filter", dict(mf=False), ("doppler_fft", "mag_cfar_fused")),
    ("overlap-save", dict(method="overlap_save"),
     ("matched_filter_os", "doppler_fft", "mag_cfar_fused")),
    ("CASH on a CA variant", dict(include_cash=True),
     ("matched_filter", "doppler_fft", "logmag", "cfar")),
])
@pytest.mark.parametrize("regs", [dict(), dict(cfar_algorithm=1, index_lagg=3,
                                               index_lead=5, cfar_mode=1)])
def test_range_doppler_chain_matches_jax(route, cfgs, stages, regs):
    cfg_j, cfg_t = _cfgs(**cfgs)
    taps = TAPS if cfg_j.matched_filter is not None else None
    chain_j, jit_j = _jax_rd_chain(cfg_j, taps is not None)
    chain_t = T.range_doppler_chain(cfg_t, taps=taps, device="cpu")
    assert chain_t.stage_names == chain_j.stage_names == stages
    rt_j, rt_t = _rts(**regs)
    x = _cpi()
    want = jit_j(R.as_pair(x), rt_j)
    got = chain_t(x, rt_t)                # numpy in: to the chain's device
    y = T.as_pair(x)
    for st in chain_t.stages[:-1]:
        y = st.fn(y, rt_t)
    if cfg_t.matched_filter is None or route == "overlap-save":
        mag = logmag(y, rt_t.mag_mode)
    else:
        mag = _mag(x, rt_t, cfg_t)
    _assert_cfar_close(got, want, mag)


def test_range_doppler_chain_detects_the_target_cell():
    p, n, delay, fd = 64, 256, 100, 0.125
    cfg = T.ChainConfig(
        fft=T.FftConfig(max_size=n),
        matched_filter=T.MatchedFilterConfig(num_taps=32, fft_size=n),
        doppler=T.DopplerConfig(num_pulses=p),
        cfar=T.CfarConfig(max_ref_window=16, max_guard_window=4,
                          max_fft_size=n, variant=T.CfarVariant.CA,
                          include_cash=False))
    taps = T.golden.lfm_chirp(32, 0.0, 0.25)
    cpi = T.golden.chirp_with_targets(p, n, taps, [(delay, 1.0, fd)])
    chain = T.range_doppler_chain(cfg, taps=taps, device="cpu")
    rt = T.RuntimeConfig.make(fft_size=n, ref_window_size=8,
                              guard_window_size=2, threshold_scaler=8.0,
                              div_sum=4, peak_grouping=1)
    out = chain(cpi.astype(np.complex64), rt)
    cell = (p // 2 + int(fd * p), delay)
    rd_map = krd.fused_rd_chain(T.as_pair(cpi.astype(np.complex64)), rt, taps,
                                cfg, emit="map")
    mag = np.abs(_np(rd_map))
    assert np.unravel_index(mag.argmax(), mag.shape) == cell
    assert out.peaks[cell]


def test_rx_rd_tx_chain_words_match_jax():
    cfg_j, cfg_t = _cfgs()
    rt_j, rt_t = _rts()
    x = _cpi()
    xq = np.round(np.clip(x.real * 250, -32767, 32767)) + 1j * np.round(
        np.clip(x.imag * 250, -32767, 32767))
    words = T.packing.pack_iq(T.as_pair(xq.astype(np.complex64))).numpy()
    chain_j = R.rx_rd_tx_chain(cfg_j, taps=TAPS)
    chain_t = T.rx_rd_tx_chain(cfg_t, taps=TAPS, device="cpu")
    assert chain_t.stage_names == chain_j.stage_names == (
        "rx_unpack", "rd_fused", "tx_pack")
    want = np.asarray(chain_j.jit()(words.view(np.uint32), rt_j))
    got = chain_t(words.view(np.uint32), rt_t)
    assert got.dtype == torch.int32 and got.shape == want.shape
    bw = N.bit_length() - 1
    tg, bg, pg = (v.numpy() for v in T.packing.unpack_cfar_words(got, bw))
    tw, bwant, pw = (v.numpy() for v in T.packing.unpack_cfar_words(
        torch.from_numpy(want.view(np.int32).copy()), bw))
    np.testing.assert_array_equal(bg, bwant)
    assert np.abs(tg.astype(np.int64) - tw).max() <= 2
    plain = krd.fused_rd_chain(T.packing.unpack_iq_pair(torch.from_numpy(
        words)), rt_t, TAPS, cfg_t)
    mag = _mag(_np(T.packing.unpack_iq_pair(torch.from_numpy(words))), rt_t,
               cfg_t)
    thr = plain.threshold.numpy()
    near = np.abs(mag - thr) / np.abs(thr).max() < REL
    assert not ((pg != pw) & ~near).any()


# ---- beamformed and integrated presets ----

@pytest.mark.parametrize("fft_beams", [False, True])
def test_beamformed_rd_chain_matches_jax(fft_beams):
    cfg_j, cfg_t = _cfgs()
    rt_j, rt_t = _rts()
    x = _cpi((4, P, N), seed=3)
    angles = np.deg2rad([-30.0, 0.0, 20.0])
    chain_j = R.beamformed_rd_chain(cfg_j, taps=TAPS, angles_rad=angles,
                                    num_channels=4, fft_beams=fft_beams)
    chain_t = T.beamformed_rd_chain(cfg_t, taps=TAPS, angles_rad=angles,
                                    num_channels=4, fft_beams=fft_beams,
                                    device="cpu")
    assert chain_t.stage_names == chain_j.stage_names
    want = chain_j.jit()(R.as_pair(x), rt_j)
    got = chain_t(T.as_pair(x), rt_t)
    beams = chain_t.stages[0].fn(T.as_pair(x), rt_t)
    _assert_map_close(beams, chain_j.stages[0].fn(R.as_pair(x), rt_j))
    _assert_cfar_close(got, want, _mag(_np(beams), rt_t, cfg_t))
    with pytest.raises(ValueError):
        chain_t(T.as_pair(x[:3]), rt_t)


@pytest.mark.parametrize("mode, m_of_n", [("noncoherent", 0), ("coherent", 0),
                                          ("binary", 3)])
def test_integrated_search_chain_matches_jax(mode, m_of_n):
    cfg_j = R.ChainConfig(
        fft=R.FftConfig(max_size=N),
        matched_filter=R.MatchedFilterConfig(num_taps=len(TAPS), fft_size=N),
        cfar=R.CfarConfig(max_ref_window=16, max_guard_window=4,
                          max_fft_size=N, variant=R.CfarVariant.CA,
                          include_cash=False))
    cfg_t = chain_config_from_reference(cfg_j)
    rt_j, rt_t = _rts()
    x = _cpi()
    chain_j = R.integrated_search_chain(cfg_j, taps=TAPS, mode=mode,
                                        m_of_n=m_of_n)
    chain_t = T.integrated_search_chain(cfg_t, taps=TAPS, mode=mode,
                                        m_of_n=m_of_n, device="cpu")
    assert chain_t.stage_names == chain_j.stage_names
    want = chain_j.jit()(R.as_pair(x), rt_j)
    got = chain_t(T.as_pair(x), rt_t)
    y = T.as_pair(x)
    for st in chain_t.stages[:-1]:
        y = st.fn(y, rt_t)
    thr_w = np.asarray(want.threshold)
    assert got.threshold.shape == thr_w.shape == (2, N)
    assert np.abs(got.threshold.numpy() - thr_w).max() / np.abs(thr_w).max() < REL
    if mode == "binary":
        np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))
    else:
        _assert_cfar_close(got, want, y.numpy())


# ---- error paths ----

def test_fused_rd_chain_refuses_what_the_kernel_does_not_compute():
    cfg_j, cfg_t = _cfgs()
    _, rt_t = _rts()
    x = T.as_pair(_cpi())
    with pytest.raises(ValueError, match="num_pulses"):
        krd.fused_rd_chain(T.C(x.re[:, :8], x.im[:, :8]), rt_t, TAPS, cfg_t)
    with pytest.raises(ValueError, match="max_size"):
        krd.fused_rd_chain(T.C(x.re[..., :128], x.im[..., :128]), rt_t, TAPS,
                           cfg_t)
    _, os_cfg = _cfgs(method="overlap_save")
    with pytest.raises(ValueError, match="overlap_save"):
        krd.fused_rd_chain(x, rt_t, TAPS, os_cfg)
    with pytest.raises(ValueError, match="replica"):
        krd.fused_rd_chain(x, rt_t, R.golden.lfm_chirp(300), cfg_t)
    _, gos_cfg = _cfgs(variant=R.CfarVariant.GOSCA)
    with pytest.raises(ValueError, match="CA family"):
        krd.fused_rd_chain(x, rt_t, TAPS, gos_cfg)
    with pytest.raises(ValueError, match="emit"):
        krd.fused_rd_chain(x, rt_t, TAPS, cfg_t, emit="mag")
    # the GOSCA elaboration's map is fine
    krd.fused_rd_chain(x, rt_t, TAPS, gos_cfg, emit="map")


def test_range_doppler_chain_refuses_lsb_keep_and_orphan_taps():
    cfg_j, cfg_t = _cfgs()
    lsb_j = dataclasses.replace(cfg_j, fft=R.FftConfig(
        max_size=N, keep_msb_or_lsb=(True,) * 7 + (False,)))
    lsb_t = chain_config_from_reference(lsb_j)
    with pytest.raises(ValueError, match="keepMSBorLSB"):
        R.range_doppler_chain(lsb_j, taps=TAPS)
    with pytest.raises(ValueError, match="keepMSBorLSB"):
        T.range_doppler_chain(lsb_t, taps=TAPS)
    _, no_mf = _cfgs(mf=False)
    with pytest.raises(ValueError, match="taps given"):
        T.range_doppler_chain(no_mf, taps=TAPS)
    with pytest.raises(ValueError, match="m_of_n"):
        T.integrated_search_chain(cfg_t, taps=TAPS, mode="binary")
    with pytest.raises(ValueError, match="mode"):
        T.integrated_search_chain(cfg_t, taps=TAPS, mode="sum")


def test_numpy_cpi_goes_to_the_device_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    _, cfg_t = _cfgs()
    _, rt_t = _rts()
    with pytest.raises(RuntimeError, match="CUDA"):
        T.range_doppler_chain(cfg_t, taps=TAPS)(_cpi(), rt_t)
