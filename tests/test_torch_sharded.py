"""The port's sharded chains (``rsp_chains_tpu_torch.parallel``) against the
JAX package's on the 8-device CPU mesh: the meshes, the halo exchange, the
range-sharded tail (CA and GOSCA registers, with and without the kernel
halo of ``use_rdma_halo``; the JAX Pallas kernels in interpret mode, as its
own tests run them), the full pipelines, the FIR, channel sharding, the
range-Doppler pipeline, the 2-D detector and the dry run. The port's mesh
lists the CPU eight times; its kernel wrappers take their plain versions on
CPU tensors. The CUDA kernels are checked on the card by
tests/test_torch_cuda.py.

Same seeded numpy inputs through both packages at the JAX tests' sizes.
Bar: threshold max|dthr| / max|thr| < 1e-4, and peaks equal except at cells
with |mag - thr| / max|thr| < 1e-4, where the two FFT formulations
(torch.fft against XLA's or the Pallas split-matmul FFT, ~1e-6 relative)
may fall on either side of the threshold. The halo exchange is exact."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import rsp_chains_tpu as R
from rsp_chains_tpu.parallel import chain_spec as chain_spec_jax
from rsp_chains_tpu.parallel import make_mesh as make_mesh_jax
from rsp_chains_tpu.parallel import sharded as SJ
from rsp_chains_tpu.parallel.halo import (
    exchange_halo as exchange_halo_jax, extend_with_halo as extend_jax,
)
from rsp_chains_tpu.parallel.mesh import CHANNEL_AXIS, RANGE_AXIS

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch import parallel as SP
from rsp_chains_tpu_torch.convert import (
    cfar2d_config_from_reference, cfar2d_runtime_from_reference,
    chain_config_from_reference, runtime_from_reference,
)
from rsp_chains_tpu_torch.kernels import _build
from rsp_chains_tpu_torch.ops.fft import fft_op
from rsp_chains_tpu_torch.ops.logmag import logmag
from rsp_chains_tpu_torch.parallel import sharded as ST
from rsp_chains_tpu_torch.parallel.dryrun import dryrun_multichip

REL = 1e-4
CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh_jax(channels=2, range_shards=4)


def _ring(n):
    """A single-axis range mesh of n JAX devices: interpret-mode remote DMA
    takes one named axis (tests/test_pallas_halo.py:23-30)."""
    return JaxMesh(np.array(jax.devices()[:n]), (RANGE_AXIS,))


def _spec(shape, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(*shape) + 1j * rng.randn(*shape)) * 2
    x[..., 300] += 40
    x[..., 511] += 25 - 10j    # beside a shard edge
    x[..., 770] += 30j
    return x.astype(np.complex64)


def _assert_cfar_close(got, want, mag):
    thr_w = np.asarray(want.threshold)
    scale = np.abs(thr_w).max()
    assert tuple(got.threshold.shape) == thr_w.shape
    assert np.abs(got.threshold.numpy() - thr_w).max() / scale < REL
    assert got.peaks.dtype == torch.bool
    diff = got.peaks.numpy() != np.asarray(want.peaks)
    near = np.abs(np.asarray(mag) - thr_w) / scale < REL
    assert not (diff & ~near).any(), int((diff & ~near).sum())


def _mag(x, rt):
    return logmag(T.as_pair(x), rt.mag_mode).numpy()


def _cfgs(variant=R.CfarVariant.GOSCA, cash=True, max_ref=64, guard=8,
          n=1024, **cfar):
    cfg_j = R.ChainConfig(
        fft=R.FftConfig(max_size=n),
        cfar=R.CfarConfig(max_ref_window=max_ref, max_guard_window=guard,
                          max_fft_size=n, variant=variant,
                          include_cash=cash, **cfar))
    return cfg_j, chain_config_from_reference(cfg_j)


def _rts(**kw):
    regs = dict(fft_size=1024, ref_window_size=32, guard_window_size=4,
                threshold_scaler=3.5, div_sum=5)
    regs.update(kw)
    rt_j = R.RuntimeConfig.make(**regs)
    return rt_j, runtime_from_reference(rt_j.peek())


# ---- meshes ----

def test_make_mesh_lays_the_devices_out_like_jax():
    mesh = SP.make_mesh(2, 4, CPU8)
    assert mesh.shape == {CHANNEL_AXIS: 2, RANGE_AXIS: 4}
    assert mesh.axis_names == (CHANNEL_AXIS, RANGE_AXIS)
    names = [[f"cuda:{i}" for i in range(4)], [f"cuda:{i}" for i in range(4, 8)]]
    cuda = SP.make_mesh(2, 4, [d for row in names for d in row])
    assert [[str(d) for d in row] for row in cuda.devices] == names
    assert SP.make_mesh(3, 1, ["cuda:0"] * 3).devices == (
        (torch.device("cuda", 0),),) * 3
    jm = make_mesh_jax(2, 4)
    assert dict(jm.shape) == mesh.shape
    assert SP.chain_spec(2) == tuple(chain_spec_jax(2))


def test_make_mesh_raises_for_too_few_devices():
    with pytest.raises(ValueError, match="needs 9 devices, have 8"):
        SP.make_mesh(3, 3, CPU8)
    with pytest.raises(ValueError, match="needs 9 devices"):
        make_mesh_jax(3, 3)
    with pytest.raises(ValueError, match="at least one shard"):
        SP.make_mesh(0, 2, CPU8)
    if not torch.cuda.is_available():
        # the default devices are the visible CUDA cards
        with pytest.raises(ValueError, match="have 0"):
            SP.make_mesh(1, 1)
        with pytest.raises(ValueError, match="needs 2 devices, have 0"):
            SP.auto_mesh(2)


# ---- the halo exchange ----

def _jax_exchange(mesh, x, halo):
    spec = P(None, RANGE_AXIS)
    return jax.jit(jax.shard_map(
        lambda xl: exchange_halo_jax(xl, halo, RANGE_AXIS), mesh=mesh,
        in_specs=(spec,), out_specs=(spec, spec), check_vma=False))(
        jnp.asarray(x))


@pytest.mark.parametrize("halo", [0, 1, 37, 128, 256])
def test_exchange_halo_matches_ppermute(mesh8, halo):
    x = np.random.RandomState(halo).randn(3, 1024).astype(np.float32)
    left_j, right_j = _jax_exchange(mesh8, x, halo)
    row = SP.scatter(torch.from_numpy(x), SP.make_mesh(2, 4, CPU8),
                     channels=False, ranges=True)[0]
    got = SP.exchange_halo(row, halo)
    np.testing.assert_array_equal(torch.cat([lt for lt, _ in got], -1).numpy(),
                                  np.asarray(left_j))
    np.testing.assert_array_equal(torch.cat([rt for _, rt in got], -1).numpy(),
                                  np.asarray(right_j))
    ext = SP.extend_with_halo(row, halo)
    want = jax.jit(jax.shard_map(
        lambda xl: extend_jax(xl, halo, RANGE_AXIS), mesh=mesh8,
        in_specs=(P(None, RANGE_AXIS),), out_specs=P(None, RANGE_AXIS),
        check_vma=False))(jnp.asarray(x))
    np.testing.assert_array_equal(torch.cat(ext, -1).numpy(), np.asarray(want))


def test_exchange_halo_on_one_shard_gives_zeros():
    x = torch.arange(12.0).reshape(2, 6)
    ((left, right),) = SP.exchange_halo([x], 3)
    assert torch.equal(left, torch.zeros(2, 3))
    assert torch.equal(right, torch.zeros(2, 3))
    # complex blocks exchange as they are (the FIR's)
    z = torch.complex(x, -x)
    (lz, rz), (lz1, _) = SP.exchange_halo([z, z + 1], 2)
    assert torch.equal(rz, (z + 1)[..., :2]) and torch.equal(lz1, z[..., -2:])


def test_halo_wider_than_shard_raises(mesh8):
    """As in the JAX package (tests/test_sharded.py:251): a halo wider than
    the local shard needs the neighbour's neighbour, so it is a loud error,
    in the plain exchange, the kernel wrappers and the plain tail."""
    from rsp_chains_tpu_torch.kernels import halo as khalo

    with pytest.raises(ValueError, match="halo"):
        jax.shard_map(
            lambda xl: extend_jax(xl, halo=128, axis_name=RANGE_AXIS),
            mesh=mesh8, in_specs=P(None, RANGE_AXIS),
            out_specs=P(None, RANGE_AXIS), check_vma=False,
        )(jnp.ones((2, 256)))
    row = [torch.ones(2, 64)] * 4
    for call in (lambda: SP.extend_with_halo(row, 128),
                 lambda: SP.exchange_halo(row, 65),
                 lambda: khalo.halo_exchange(row, 65),
                 lambda: khalo.mag_extend([T.C(b, b) for b in row], 65, 2)):
        with pytest.raises(ValueError, match="halo 65|halo 128"):
            call()
    _, cfg = _cfgs(variant=R.CfarVariant.CA, cash=False, use_pallas=False)
    _, rt = _rts()
    with pytest.raises(ValueError, match="halo 72 exceeds"):
        SP.cfar_halo_shard(row, rt, cfg.cfar)


# ---- the range-sharded tail ----

@pytest.mark.parametrize("variant, cash, max_ref, guard", [
    (R.CfarVariant.CA, False, 64, 8), (R.CfarVariant.GOSCA, True, 64, 8),
    (R.CfarVariant.GOS, False, 16, 4), (R.CfarVariant.CA, True, 16, 4)])
@pytest.mark.parametrize("n_loc", [64, 128, 256, 384, 1024])
@pytest.mark.parametrize("cfar", [dict(), dict(use_pallas=False),
                                  dict(emit_noise=True),
                                  dict(use_rdma_halo=True)])
def test_fused_tail_gate_matches_jax(variant, cash, max_ref, guard, n_loc,
                                     cfar):
    cfg_j, cfg_t = _cfgs(variant, cash, max_ref, guard, **cfar)
    assert (ST._fused_tail_local(cfg_t, n_loc) is None) == (
        SJ._fused_tail_local(cfg_j, n_loc) is None)


# (elaboration, registers over _rts, with the kernel halo); the GOSCA
# elaboration keeps max_ref_window 16 so the interpret-mode sort stays fast
TAIL_POINTS = [
    ("ca", dict(), False),
    ("ca", dict(cfar_mode=1, peak_grouping=1), False),
    ("ca", dict(fft_size=512), False),
    ("ca", dict(), True),
    ("ca", dict(mag_mode=3, log_or_linear=0, threshold_scaler=2.0), True),
    ("ca", dict(cfar_fft_size=700), True),
    ("gosca", dict(cfar_algorithm=1, index_lagg=5, index_lead=3), False),
    ("gosca", dict(cfar_algorithm=1, index_lagg=5, index_lead=3), True),
    ("gosca", dict(cfar_mode=3, sub_window_size=4), True),
    ("gosca", dict(), True),
]


@pytest.mark.parametrize("kind, regs, rdma", TAIL_POINTS)
def test_range_sharded_mag_cfar_matches_jax(mesh8, kind, regs, rdma):
    if kind == "ca":
        cfg_j, cfg_t = _cfgs(R.CfarVariant.CA, False, use_rdma_halo=rdma)
        rt_j, rt_t = _rts(**regs)
    else:
        cfg_j, cfg_t = _cfgs(max_ref=16, guard=4, use_rdma_halo=rdma)
        rt_j, rt_t = _rts(ref_window_size=8, guard_window_size=2, div_sum=3,
                          threshold_scaler=3.0, **regs)
    assert ST._fused_tail_local(cfg_t, 256) is not None
    spec = _spec((2, 1024), seed=3)
    mesh_j = _ring(4) if rdma else mesh8
    want = SJ.range_sharded_mag_cfar(cfg_j, mesh_j)(R.as_pair(spec), rt_j)
    mesh_t = SP.make_mesh(1 if rdma else 2, 4, CPU8)
    before = dict(_build.LAUNCHES)
    got = SP.range_sharded_mag_cfar(cfg_t, mesh_t)(spec, rt_t)
    assert dict(_build.LAUNCHES) == before    # CPU blocks: plain versions
    _assert_cfar_close(got, want, _mag(spec, rt_t))


def test_plain_tail_emits_noise_and_cell_like_jax(mesh8):
    cfg_j, cfg_t = _cfgs(R.CfarVariant.CA, False, emit_noise=True,
                         send_cut=True)
    rt_j, rt_t = _rts(cfar_mode=2)
    assert ST._fused_tail_local(cfg_t, 256) is None
    spec = _spec((2, 1024), seed=4)
    want = SJ.range_sharded_mag_cfar(cfg_j, mesh8)(jnp.asarray(spec), rt_j)
    got = SP.range_sharded_mag_cfar(cfg_t, SP.make_mesh(2, 4, CPU8))(spec,
                                                                      rt_t)
    _assert_cfar_close(got, want, _mag(spec, rt_t))
    for field in ("noise", "cut"):
        w = np.asarray(getattr(want, field))
        g = getattr(got, field).numpy()
        assert np.abs(g - w).max() / np.abs(w).max() < REL


# ---- the full pipelines ----

def _frames(c, n, seed=0):
    return np.stack([R.golden.three_tone_signal(n, shift_range_factor=12,
                                                seed=seed + s)
                     for s in range(c)]).astype(np.complex64)


@pytest.mark.parametrize("variant, cash, use_pallas, rdma", [
    (R.CfarVariant.CA, False, True, True),
    (R.CfarVariant.CA, False, True, False),
    (R.CfarVariant.GOSCA, True, False, False),
])
def test_make_sharded_pipeline_on_a_2x4_mesh_matches_jax(mesh8, variant, cash,
                                                         use_pallas, rdma):
    cfg_j, cfg_t = _cfgs(variant, cash, use_pallas=use_pallas,
                         use_rdma_halo=rdma)
    rt_j, rt_t = _rts()
    iq = _frames(2, 1024, seed=1)
    # the JAX kernel halo needs a one-axis mesh in interpret mode; its XLA
    # halo computes the same cells on the 2 x 4 mesh
    want = SJ.make_sharded_pipeline(
        dataclasses.replace(cfg_j, cfar=dataclasses.replace(
            cfg_j.cfar, use_rdma_halo=False)), mesh8)(R.as_pair(iq), rt_j)
    got = SP.make_sharded_pipeline(cfg_t, SP.make_mesh(2, 4, CPU8))(iq, rt_t)
    spec = fft_op(T.as_pair(iq), None, cfg_t.fft)
    _assert_cfar_close(got, want, _mag(spec, rt_t))
    unsharded = T.fft_mag_cfar_chain(cfg_t, device="cpu")(T.as_pair(iq), rt_t)
    assert torch.equal(got.peaks, unsharded.peaks)


@pytest.mark.parametrize("variant, cash, regs", [
    (R.CfarVariant.CA, False, dict()),
    (R.CfarVariant.GOSCA, True, dict(cfar_algorithm=1, index_lagg=4,
                                     index_lead=6)),
])
def test_make_sharded_pipeline_on_a_channel_only_mesh_matches_jax(
        variant, cash, regs):
    """A channel-only mesh with a chain-fusable elaboration runs the
    whole-chain op per shard (tests/test_sharded.py:223)."""
    cfg_j, cfg_t = _cfgs(variant, cash, max_ref=16, guard=4, n=256)
    rt_j, rt_t = _rts(fft_size=256, ref_window_size=8, guard_window_size=2,
                      div_sum=4, **regs)
    iq = _frames(8, 256, seed=3)
    want = SJ.make_sharded_pipeline(cfg_j, make_mesh_jax(8, 1))(
        jnp.asarray(iq), rt_j)
    got = SP.make_sharded_pipeline(cfg_t, SP.make_mesh(8, 1, CPU8))(iq, rt_t)
    spec = fft_op(T.as_pair(iq), None, cfg_t.fft)
    _assert_cfar_close(got, want, _mag(spec, rt_t))


def test_range_sharded_fir_matches_jax(mesh8):
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 2048) + 1j * rng.randn(2, 2048)).astype(np.complex64)
    taps = (rng.randn(33) + 1j * rng.randn(33)).astype(np.complex64)
    want = np.asarray(SJ.range_sharded_fir(taps, mesh8)(jnp.asarray(x)))
    got = SP.range_sharded_fir(taps, SP.make_mesh(2, 4, CPU8))(
        torch.from_numpy(x))
    assert got.is_complex()
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-5
    for i in range(2):
        full = np.convolve(x[i], taps, mode="full")[:2048]
        assert np.abs(got[i].numpy() - full).max() / np.abs(full).max() < 1e-5
    pair = SP.range_sharded_fir(taps, SP.make_mesh(1, 8, CPU8))(T.as_pair(x))
    assert isinstance(pair, T.C)
    assert np.abs(pair.re.numpy() + 1j * pair.im.numpy() - want).max() \
        / np.abs(want).max() < 1e-5


def test_channel_sharded_chain_matches_jax(mesh8):
    cfg_j, cfg_t = _cfgs(use_pallas=False)
    rt_j, rt_t = _rts()
    iq = _frames(2, 1024, seed=0)
    chain_j = R.fft_mag_cfar_chain(cfg_j)
    want = SJ.channel_sharded(chain_j.__call__, mesh8)(jnp.asarray(iq), rt_j)
    chain_t = T.fft_mag_cfar_chain(cfg_t, device="cpu")
    got = SP.channel_sharded(chain_t, SP.make_mesh(2, 4, CPU8))(iq, rt_t)
    spec = fft_op(T.as_pair(iq), None, cfg_t.fft)
    _assert_cfar_close(got, want, _mag(spec, rt_t))
    with pytest.raises(ValueError, match="axes"):
        SP.channel_sharded(chain_t, SP.make_mesh(2, 4, CPU8), batch_ndim=2)(
            iq, rt_t)


RD_P, RD_N = 16, 1024
RD_TAPS = R.golden.lfm_chirp(64, 0.0, 0.25)


def _rd_cfgs(variant, cash, method="freq", **cfar):
    cfg_j = R.ChainConfig(
        fft=R.FftConfig(max_size=RD_N),
        matched_filter=R.MatchedFilterConfig(num_taps=64, fft_size=RD_N,
                                             method=method),
        doppler=R.DopplerConfig(num_pulses=RD_P),
        cfar=R.CfarConfig(max_ref_window=64, max_guard_window=8,
                          variant=variant, include_cash=cash, **cfar))
    return cfg_j, chain_config_from_reference(cfg_j)


@pytest.mark.parametrize("variant, cash, method, rdma, regs", [
    (R.CfarVariant.GOSCA, True, "freq", True, dict()),
    (R.CfarVariant.GOSCA, True, "freq", True,
     dict(cfar_algorithm=1, index_lagg=16, index_lead=16)),
    (R.CfarVariant.CA, False, "freq", True, dict(cfar_mode=1)),
    (R.CfarVariant.CA, False, "freq", False, dict()),
    (R.CfarVariant.GOSCA, True, "overlap_save", False, dict()),
])
def test_make_sharded_rd_pipeline_matches_jax(mesh8, variant, cash, method,
                                              rdma, regs):
    """The port's kernel routes (on the CPU, their plain versions) against
    the JAX package's XLA datapaths (tests/test_sharded.py:108), which
    compute the same cells."""
    cfg_j, _ = _rd_cfgs(variant, cash, method, use_pallas=False)
    _, cfg_t = _rd_cfgs(variant, cash, method, use_rdma_halo=rdma)
    rt_j, rt_t = _rts(threshold_scaler=8.0, **regs)
    rng = np.random.RandomState(7)
    x = (rng.randn(2, RD_P, RD_N)
         + 1j * rng.randn(2, RD_P, RD_N)).astype(np.complex64)
    x[:, :, 200:264] += 3 * RD_TAPS
    want = SJ.make_sharded_rd_pipeline(cfg_j, mesh8, RD_TAPS)(jnp.asarray(x),
                                                              rt_j)
    got = SP.make_sharded_rd_pipeline(cfg_t, SP.make_mesh(2, 4, CPU8),
                                      RD_TAPS)(x, rt_t)
    _, plain_cfg = _rd_cfgs(variant, cash, method, use_pallas=False)
    plain = T.range_doppler_chain(plain_cfg, taps=RD_TAPS, device="cpu")
    mag = T.as_pair(x)
    for stage in plain.stages[:-1]:     # the filter, Doppler and magnitude
        mag = stage.fn(mag, rt_t)
    _assert_cfar_close(got, want, mag.numpy())
    unsharded = T.range_doppler_chain(cfg_t, taps=RD_TAPS, device="cpu")
    assert torch.equal(got.peaks, unsharded(T.as_pair(x), rt_t).peaks)


def test_cfar_2d_halo_shard_matches_jax(mesh8):
    from rsp_chains_tpu.ops.cfar_2d import Cfar2dConfig, Cfar2dRuntime
    from rsp_chains_tpu.ops.cfar import CfarOutput as CfarOutputJ

    cfg2_j = Cfar2dConfig(max_ref_range=16, max_guard_range=4,
                          max_ref_doppler=8, max_guard_doppler=2)
    rt2_j = Cfar2dRuntime.make(ref_range=8, guard_range=2, ref_doppler=4,
                               guard_doppler=1, threshold_scaler=3.0,
                               active_range=900, peak_grouping=1,
                               validate_against=cfg2_j)
    mag = np.abs(np.random.RandomState(9).randn(2, 16, 1024)).astype(
        np.float32) + 0.1
    mag[:, 5, 255] += 30.0     # beside a shard edge
    spec = P(CHANNEL_AXIS, None, RANGE_AXIS)
    want = jax.jit(jax.shard_map(
        lambda m, r2: SJ.cfar_2d_halo_shard(m, r2, cfg2_j), mesh=mesh8,
        in_specs=(spec, P()), out_specs=CfarOutputJ(spec, spec, None, None),
        check_vma=False))(jnp.asarray(mag), rt2_j)
    cfg2_t = cfar2d_config_from_reference(cfg2_j)
    rt2_t = cfar2d_runtime_from_reference(rt2_j)
    grid = SP.scatter(torch.from_numpy(mag), SP.make_mesh(2, 4, CPU8),
                      channels=True, ranges=True)
    got = SP.gather([SP.cfar_2d_halo_shard(row, rt2_t, cfg2_t)
                     for row in grid])
    _assert_cfar_close(got, want, mag)
    assert bool(got.peaks[:, 5, 255].all())


def test_the_2d_halo_shard_clips_the_active_range_to_the_frame(mesh8):
    """Reference fault, not followed: with ``active_range`` past the frame
    end (the default 2^30), JAX's ``cfar_2d_halo_shard`` counts the last
    shard's zero halo as active cells and differs from its own unsharded
    ``cfar_2d_op`` at the right edge. The port clips the range to the frame,
    as the unsharded op does, and equals the unsharded op; it equals JAX's
    sharded op wherever the register lies inside the frame (above)."""
    from rsp_chains_tpu.ops.cfar import CfarOutput as CfarOutputJ
    from rsp_chains_tpu.ops.cfar_2d import (
        Cfar2dConfig, Cfar2dRuntime, cfar_2d_op as cfar_2d_op_jax,
    )

    cfg2_j = Cfar2dConfig(max_ref_range=16, max_guard_range=4,
                          max_ref_doppler=8, max_guard_doppler=2)
    rt2_j = Cfar2dRuntime.make(ref_range=8, guard_range=2, ref_doppler=4,
                               guard_doppler=1, threshold_scaler=3.0)
    assert int(rt2_j.active_range) == 1 << 30
    mag = np.abs(np.random.RandomState(9).randn(2, 16, 1024)).astype(
        np.float32) + 0.1
    spec = P(CHANNEL_AXIS, None, RANGE_AXIS)
    sharded_j = jax.jit(jax.shard_map(
        lambda m, r2: SJ.cfar_2d_halo_shard(m, r2, cfg2_j), mesh=mesh8,
        in_specs=(spec, P()), out_specs=CfarOutputJ(spec, spec, None, None),
        check_vma=False))(jnp.asarray(mag), rt2_j)
    want = cfar_2d_op_jax(jnp.asarray(mag), rt2_j, cfg2_j)
    edge = np.abs(np.asarray(sharded_j.threshold)
                  - np.asarray(want.threshold))[..., -16:]
    assert edge.max() / np.abs(np.asarray(want.threshold)).max() > 0.1
    grid = SP.scatter(torch.from_numpy(mag), SP.make_mesh(2, 4, CPU8),
                      channels=True, ranges=True)
    got = SP.gather([SP.cfar_2d_halo_shard(
        row, cfar2d_runtime_from_reference(rt2_j),
        cfar2d_config_from_reference(cfg2_j)) for row in grid])
    _assert_cfar_close(got, want, mag)


def test_a_step_takes_placed_blocks():
    """A grid of blocks already on the mesh skips the scatter."""
    _, cfg = _cfgs(R.CfarVariant.CA, False, use_rdma_halo=True)
    _, rt = _rts()
    mesh = SP.make_mesh(2, 4, CPU8)
    spec = T.as_pair(_spec((2, 1024), seed=8))
    step = SP.range_sharded_mag_cfar(cfg, mesh)
    placed = SP.scatter(spec, mesh, channels=False, ranges=True)
    assert len(placed) == 1 and len(placed[0]) == 4
    assert placed[0][2].re.shape == (2, 256) and placed[0][2].re.is_contiguous()
    a, b = step(spec, rt), step(placed, rt)
    assert torch.equal(a.threshold, b.threshold)
    assert torch.equal(a.peaks, b.peaks)
    with pytest.raises(ValueError, match="does not split"):
        SP.scatter(T.as_pair(_spec((2, 1022), 0)), mesh, channels=False,
                   ranges=True)


@pytest.mark.parametrize("n_devices", [8, 4])
def test_dryrun_multichip_on_the_cpu_mesh(n_devices):
    """The five legs of the JAX package's dry run (``__graft_entry__.py:84``)
    at 16 pulses, cross-checked as it checks them."""
    report = dryrun_multichip(CPU8[:n_devices], num_pulses=16)
    assert set(report) == {"fused", "rdma-halo", "sharded-1d", "sharded-2d"}
    assert all(rel < 1e-4 and flips == 0 for rel, flips in report.values())
