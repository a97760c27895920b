"""The halo kernels' plain versions (``rsp_chains_tpu_torch.kernels.halo``)
against the JAX package's RDMA kernels (``kernels/pallas_halo.py``, in
interpret mode on the 8-shard CPU ring, as tests/test_pallas_halo.py runs
them); Kernels B and C's plain versions with an active range and a given
magnitude against the JAX ``fused_mag_cfar`` / ``fused_mag_gos_cfar`` with
the same arguments; the rule that a user's ``mag_mode`` above 3 gives LOG2
on every chain of the port; and the wrappers' host-side contract. The CUDA
kernels themselves are checked on the card by tests/test_torch_cuda.py.

Bars: the halo exchange exact; the extended magnitude within 1e-6 relative
(the JAX kernel and ``logmag`` round the same formulas); the CFAR threshold
max|dthr| / max|thr| < 1e-4 with equal peaks (the same magnitude goes into
both, so only the window sums' order differs)."""

import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import rsp_chains_tpu as R
from rsp_chains_tpu.kernels.cfar_pallas import (
    MAG_PASSTHROUGH, fused_mag_cfar, fused_mag_gos_cfar,
)
from rsp_chains_tpu.kernels.pallas_halo import halo_exchange_rdma, mag_extend_rdma
from rsp_chains_tpu.parallel.mesh import RANGE_AXIS

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch import parallel as SP
from rsp_chains_tpu_torch.convert import (
    chain_config_from_reference, runtime_from_reference,
)
from rsp_chains_tpu_torch.kernels import _build
from rsp_chains_tpu_torch.kernels import cfar as kcfar
from rsp_chains_tpu_torch.kernels import halo as khalo
from rsp_chains_tpu_torch.ops.logmag import logmag

CPU = torch.device("cpu")
SHARDS = 8


@pytest.fixture(scope="module")
def ring8():
    return JaxMesh(np.array(jax.devices()[:SHARDS]), (RANGE_AXIS,))


def _rows(x):
    """The port's blocks of one range row for a global [..., N] array."""
    mesh = SP.make_mesh(1, SHARDS, [CPU] * SHARDS)
    return SP.scatter(x, mesh, channels=False, ranges=True)[0]


def _jax_ring(mesh, fn, n_in, n_out):
    spec = P(None, RANGE_AXIS)
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec,) * n_in,
                                 out_specs=(spec,) * n_out, check_vma=False))


@pytest.mark.parametrize("halo", [1, 32, 128])
def test_halo_exchange_reference_matches_the_rdma_kernel(ring8, halo):
    x = np.random.RandomState(halo).randn(2, 1024).astype(np.float32)
    left_j, right_j = _jax_ring(
        ring8, lambda xl: halo_exchange_rdma(xl, halo, RANGE_AXIS,
                                             interpret=True), 1, 2)(
        jnp.asarray(x))
    got = khalo.halo_exchange_reference(_rows(torch.from_numpy(x)), halo)
    np.testing.assert_array_equal(torch.cat([lt for lt, _ in got], -1).numpy(),
                                  np.asarray(left_j))
    np.testing.assert_array_equal(torch.cat([rt for _, rt in got], -1).numpy(),
                                  np.asarray(right_j))


@pytest.mark.parametrize("mag_mode", [0, 1, 2, 3])
@pytest.mark.parametrize("halo", [64, 128])
def test_mag_extend_reference_matches_the_rdma_kernel(ring8, mag_mode, halo):
    rng = np.random.RandomState(mag_mode)
    re_, im_ = (rng.randn(2, 1024).astype(np.float32) * 3 for _ in range(2))
    (want,) = _jax_ring(
        ring8, lambda a, b: (mag_extend_rdma(a, b, halo,
                                             jnp.asarray(mag_mode, jnp.int32),
                                             RANGE_AXIS, interpret=True),),
        2, 1)(jnp.asarray(re_), jnp.asarray(im_))
    blocks = _rows(T.C(torch.from_numpy(re_), torch.from_numpy(im_)))
    got = khalo.mag_extend_reference(blocks, halo, mag_mode)
    assert all(g.shape == (2, 128 + 2 * halo) for g in got)
    np.testing.assert_allclose(torch.cat(got, -1).numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)


def test_mag_extend_clips_the_mode_like_logmag():
    """The port's magnitude mux clips the register to 0..3; the TPU kernel's
    passthrough for codes above 3 is not carried over."""
    rng = np.random.RandomState(4)
    blocks = _rows(T.C(*(torch.from_numpy(rng.randn(2, 1024).astype(
        np.float32)) for _ in range(2))))
    for raw, clipped in ((4, 3), (9, 3), (-2, 0)):
        got = khalo.mag_extend(blocks, 16, raw)
        want = khalo.mag_extend(blocks, 16, clipped)
        assert all(torch.equal(g, w) for g, w in zip(got, want))


# ---- Kernels B and C with an active range and a given magnitude ----

def _cfgs(variant, cash, max_ref, n):
    cfg_j = R.ChainConfig(
        fft=R.FftConfig(max_size=n),
        cfar=R.CfarConfig(max_ref_window=max_ref, max_guard_window=4,
                          max_fft_size=n, variant=variant,
                          include_cash=cash))
    return cfg_j, chain_config_from_reference(cfg_j)


def _rts(**kw):
    regs = dict(fft_size=256, ref_window_size=8, guard_window_size=2,
                threshold_scaler=3.0, div_sum=3)
    regs.update(kw)
    rt_j = R.RuntimeConfig.make(**regs)
    return rt_j, runtime_from_reference(rt_j.peek())


def _spectrum(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) + 1j * rng.randn(*shape)) * 4
    x[..., 60] += 80
    x[..., 200] += 50j
    x[..., -40] += 60
    return x.astype(np.complex64)


def _assert_matches(got, want):
    thr_w = np.asarray(want.threshold)
    rel = np.abs(got.threshold.numpy() - thr_w).max() / np.abs(thr_w).max()
    assert rel < 1e-4, rel
    assert got.peaks.dtype == torch.bool
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))


# (active_lo, active_hi) in the extended row of 512 cells, as the sharded
# tail gives them: the first shard's, an interior shard's, the last shard's
# with a shrunken frame, and a range that ends inside the left halo
ACTIVE = [(128, 384), (0, 512), (0, 250), (100, 110)]


@pytest.mark.parametrize("lo, hi", ACTIVE)
@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("regs", [
    dict(), dict(cfar_mode=1, peak_grouping=1),
    dict(mag_mode=3, log_or_linear=0, threshold_scaler=1.5)])
def test_mag_cfar_reference_with_an_active_range_matches_pallas(lo, hi, given,
                                                                regs):
    cfg_j, cfg_t = _cfgs(R.CfarVariant.CA, False, 16, 512)
    rt_j, rt_t = _rts(**regs)
    spec = _spectrum((3, 512), seed=lo + hi)
    if given:
        mag = logmag(T.as_pair(spec), rt_t.mag_mode)
        want = fused_mag_cfar(
            R.as_pair(mag.numpy().astype(np.complex64)),
            dataclasses.replace(rt_j, mag_mode=jnp.asarray(MAG_PASSTHROUGH,
                                                           jnp.int32)),
            cfg_j.cfar, interpret=True, active_lo=lo, active_hi=hi)
        got = kcfar.mag_cfar(mag, rt_t, cfg_t.cfar, active_lo=lo,
                             active_hi=hi, mag_given=True)
    else:
        want = fused_mag_cfar(jnp.asarray(spec), rt_j, cfg_j.cfar,
                              interpret=True, active_lo=lo, active_hi=hi)
        got = kcfar.mag_cfar(T.as_pair(spec), rt_t, cfg_t.cfar, active_lo=lo,
                             active_hi=hi)
    _assert_matches(got, want)
    assert not got.peaks[..., :lo].any() and not got.peaks[..., hi:].any()


@pytest.mark.parametrize("lo, hi", ACTIVE[:3])
@pytest.mark.parametrize("given", [False, True])
@pytest.mark.parametrize("regs", [
    dict(cfar_algorithm=1, index_lagg=3, index_lead=5),
    dict(cfar_mode=3, sub_window_size=4, peak_grouping=1)])
def test_mag_gos_cfar_reference_with_an_active_range_matches_pallas(
        lo, hi, given, regs):
    cfg_j, cfg_t = _cfgs(R.CfarVariant.GOSCA, True, 8, 512)
    rt_j, rt_t = _rts(**regs)
    spec = _spectrum((2, 512), seed=lo + 7)
    if given:
        mag = logmag(T.as_pair(spec), rt_t.mag_mode)
        want = fused_mag_gos_cfar(
            R.as_pair(mag.numpy().astype(np.complex64)),
            dataclasses.replace(rt_j, mag_mode=jnp.asarray(MAG_PASSTHROUGH,
                                                           jnp.int32)),
            cfg_j.cfar, interpret=True, active_lo=lo, active_hi=hi)
        got = kcfar.fused_mag_gos_dispatch(mag, rt_t, cfg_t.cfar,
                                           active_lo=lo, active_hi=hi,
                                           mag_given=True)
    else:
        want = fused_mag_gos_cfar(jnp.asarray(spec), rt_j, cfg_j.cfar,
                                  interpret=True, active_lo=lo, active_hi=hi)
        got = kcfar.mag_gos_cfar(T.as_pair(spec), rt_t, cfg_t.cfar,
                                 active_lo=lo, active_hi=hi)
    _assert_matches(got, want)


def test_active_range_registers_are_clamped_on_the_host():
    _, cfg = _cfgs(R.CfarVariant.GOSCA, True, 16, 512)
    _, rt = _rts(cfar_fft_size=200)
    ca = kcfar.ca_registers(rt, cfg.cfar, 512)
    assert (ca.active_lo, ca.active_hi) == (0, 200)
    ca = kcfar.ca_registers(rt, cfg.cfar, 512, 128, 900)
    assert (ca.active_lo, ca.active_hi) == (128, 512)
    gos = kcfar.gos_registers(rt, cfg.cfar, 512, -5, 384)
    assert (gos.active_lo, gos.active_hi) == (0, 384)


def test_a_given_magnitude_is_a_real_tensor():
    _, cfg = _cfgs(R.CfarVariant.CA, False, 16, 256)
    _, rt = _rts()
    spec = T.as_pair(_spectrum((2, 256), 1))
    with pytest.raises(ValueError, match="real tensor"):
        kcfar.mag_cfar(spec, rt, cfg.cfar, mag_given=True)
    with pytest.raises(ValueError, match="real tensor"):
        kcfar.mag_gos_cfar(torch.complex(spec.re, spec.im), rt, cfg.cfar,
                           mag_given=True)


# ---- a user's mag_mode above 3 is LOG2 on every chain ----

TAPS = R.golden.lfm_chirp(32, 0.0, 0.25)


def _chains():
    """(name, run(rt)) for every chain of the port, on the CPU."""
    ca = T.ChainConfig(fft=T.FftConfig(max_size=256),
                       cfar=T.CfarConfig(max_ref_window=16,
                                         variant=T.CfarVariant.CA,
                                         include_cash=False,
                                         max_fft_size=256))
    gos = dataclasses.replace(ca, cfar=T.CfarConfig(max_ref_window=16,
                                                     max_fft_size=256))
    rdma = {k: dataclasses.replace(c, cfar=dataclasses.replace(
        c.cfar, use_rdma_halo=True)) for k, c in (("ca", ca), ("gos", gos))}
    rd = T.ChainConfig(fft=T.FftConfig(max_size=256),
                       matched_filter=T.MatchedFilterConfig(num_taps=32,
                                                            fft_size=256),
                       doppler=T.DopplerConfig(num_pulses=16),
                       cfar=ca.cfar)
    rd_gos = dataclasses.replace(rd, cfar=rdma["gos"].cfar)
    bit_true = dataclasses.replace(ca, fixed_point=T.FixedPointConfig(
        enabled=True, width=16, bin_point=0, bit_true=True))
    rng = np.random.RandomState(12)
    frames = T.as_pair((rng.randn(4, 256) + 1j * rng.randn(4, 256)).astype(
        np.complex64) * 30)
    ints = T.C(torch.round(frames.re), torch.round(frames.im))
    cpi = T.as_pair((rng.randn(2, 16, 256) + 1j * rng.randn(2, 16, 256))
                    .astype(np.complex64))
    words = T.packing.pack_iq(ints)
    mesh = SP.make_mesh(2, 2, [CPU] * 4)
    rt2 = T.Cfar2dRuntime.make(ref_range=4, guard_range=1, ref_doppler=2,
                               guard_doppler=1, threshold_scaler=1.5)
    return [
        ("fft_mag_cfar_chain CA", lambda rt: T.fft_mag_cfar_chain(
            ca, device="cpu")(frames, rt)),
        ("fft_mag_cfar_chain GOSCA", lambda rt: T.fft_mag_cfar_chain(
            gos, device="cpu")(frames, rt)),
        ("fft_mag_cfar_chain bit-true", lambda rt: T.fft_mag_cfar_chain(
            bit_true, device="cpu")(ints, rt)),
        ("rx_fft_mag_cfar_tx_chain", lambda rt: T.rx_fft_mag_cfar_tx_chain(
            ca, device="cpu")(words, rt)),
        ("pulse_compression_chain", lambda rt: T.pulse_compression_chain(
            ca, taps=TAPS, device="cpu")(frames, rt)),
        ("range_doppler_chain", lambda rt: T.range_doppler_chain(
            rd, taps=TAPS, device="cpu")(cpi, rt)),
        ("range_doppler_chain GOSCA", lambda rt: T.range_doppler_chain(
            rd_gos, taps=TAPS, device="cpu")(cpi, rt)),
        ("rx_rd_tx_chain", lambda rt: T.rx_rd_tx_chain(
            rd, taps=TAPS, device="cpu")(
                T.packing.pack_iq(T.C(torch.round(cpi.re * 30),
                                      torch.round(cpi.im * 30))), rt)),
        ("rd_2d_cfar_chain", lambda rt: T.rd_2d_cfar_chain(
            rd, taps=TAPS, device="cpu")(cpi, rt, rt2)),
        ("beamformed_rd_chain", lambda rt: T.beamformed_rd_chain(
            rd, taps=TAPS, num_channels=2, fft_beams=True, device="cpu")(
                T.C(cpi.re[None], cpi.im[None]), rt)),
        ("integrated_search_chain", lambda rt: T.integrated_search_chain(
            ca, taps=TAPS, device="cpu")(cpi, rt)),
        ("make_sharded_pipeline", lambda rt: SP.make_sharded_pipeline(
            rdma["gos"], mesh)(frames, rt)),
        ("range_sharded_mag_cfar", lambda rt: SP.range_sharded_mag_cfar(
            rdma["ca"], mesh)(frames, rt)),
        ("make_sharded_rd_pipeline", lambda rt: SP.make_sharded_rd_pipeline(
            rd_gos, mesh, TAPS)(cpi, rt)),
    ]


@pytest.mark.parametrize("name, run", _chains(), ids=lambda v: v if
                         isinstance(v, str) else "")
def test_a_user_mag_mode_above_three_gives_log2_on_every_chain(name, run):
    """The "magnitude given" input of the sharded tail is an argument of the
    kernel wrappers, never a register code: a user who writes 4 (the TPU
    kernels' MAG_PASSTHROUGH) into the register gets LOG2, as the JAX
    package's ``ops.logmag`` gives it."""
    regs = dict(fft_size=256, ref_window_size=8, guard_window_size=2,
                log_or_linear=0, threshold_scaler=1.5, div_sum=3)
    log2 = T.RuntimeConfig.make(mag_mode=3, **regs)
    got = run(dataclasses.replace(log2, mag_mode=4))
    want = run(log2)
    if isinstance(want, torch.Tensor):   # packed words
        assert torch.equal(got, want)
        return
    assert torch.equal(got.threshold, want.threshold), name
    assert torch.equal(got.peaks, want.peaks), name
    other = run(dataclasses.replace(log2, mag_mode=2))
    assert not torch.equal(other.threshold, want.threshold), name


# ---- the wrappers' host-side contract ----

def test_cpu_blocks_take_the_plain_versions_without_launching():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 1024).astype(np.float32))
    blocks = _rows(T.C(x, -x))
    before = dict(_build.LAUNCHES)
    exch = khalo.halo_exchange([b.re for b in blocks], 16)
    ext = khalo.mag_extend(blocks, 16, 2)
    assert dict(_build.LAUNCHES) == before
    assert len(exch) == len(ext) == SHARDS
    assert torch.equal(exch[0][0], torch.zeros(2, 16))
    assert torch.equal(exch[3][1], x[:, 512:528])
    assert torch.equal(ext[3][:, 16:144], logmag(blocks[3], 2))


def test_blocks_of_one_axis_share_a_device_type_and_shape():
    a = torch.zeros(2, 64)
    with pytest.raises(ValueError, match="all on the CPU or all on CUDA"):
        khalo.halo_exchange([a, a.to("meta")], 8)
    with pytest.raises(ValueError, match="share a shape"):
        khalo.halo_exchange([a, torch.zeros(2, 32)], 8)


def _c_params(source, symbol):
    text = (_build.CSRC / source).read_text()
    m = re.search(r'extern "C" int %s\((.*?)\)\s*\{' % symbol, text, re.S)
    return [p.strip() for p in m.group(1).split(",")]


def test_the_c_entries_take_what_the_wrappers_pass():
    """The wrappers bind the C entries with ``ctypes``; their parameter
    lists must agree, since a mismatch shows only on the card."""
    assert "halo.cu" in _build.SOURCES
    ex = _c_params("halo.cu", "rsp_halo_exchange")
    assert [p.endswith("*") or "* " in p for p in ex] == [True] * 4 + [False] * 4
    assert ex[4:] == ["int frames", "cudaStream_t stream", "int n_loc",
                      "int halo"]
    me = _c_params("halo.cu", "rsp_mag_extend")
    assert ["*" in p for p in me] == [True] * 7 + [False] * 5
    assert me[7:] == ["int frames", "cudaStream_t stream", "int n_loc",
                      "int halo", "int mag_mode"]
    for source, symbol, regs in (("mag_cfar.cu", "rsp_mag_cfar", "RspCaRegs"),
                                 ("mag_gos_cfar.cu", "rsp_mag_gos_cfar",
                                  "RspGosRegs")):
        assert _c_params(source, symbol)[-3:] == ["int n", f"{regs} regs",
                                                  "int mag_given"]
    assert _c_params("halo.cu", "rsp_enable_peer_access") == ["int dev",
                                                              "int peer"]
