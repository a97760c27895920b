"""The plain versions of the port's kernels against the JAX package's Pallas
kernels (run in interpret mode, as the JAX package's own tests run them on the
CPU), and the wrappers' host-side contract: register structs, routing, shape
checks. The CUDA kernels themselves are checked on the card by
tests/test_torch_cuda.py.

Bar: max|dthr| / max|thr| < 1e-4, the bench's (the port's torch.fft against
the Pallas kernel's split-matmul FFT measures ~1e-6); peaks equal."""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.kernels.cfar_pallas import fused_mag_cfar, fused_mag_gos_cfar
from rsp_chains_tpu.kernels.chain_pallas import (
    fused_chain_ca, fused_chain_ca_op, fused_chain_gos,
)
from rsp_chains_tpu.ops.fft import fft_op as fft_jax

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
    gcfg = _gos_cfgs(512)[1]
    x = T.as_pair(_frames((2, 3, 512)))
    rt = T.RuntimeConfig.make(fft_size=512, peak_grouping=1)
    small = rt.merge_regs(fft_size=256, cfar_fft_size=256)
    gos = rt.merge_regs(cfar_algorithm=1)
    launches = dict(_build.LAUNCHES)
    pairs = [
        (kchain.fused_chain_ca_op(x, rt, cfg.fft, cfg.cfar),
         kchain.chain_ca_reference(x, rt, cfg.fft, cfg.cfar)),
        (kchain.fused_chain_ca_op(x, small, cfg.fft, cfg.cfar),
         kcfar.mag_cfar_reference(fft_op(x, small.log2_fft_size, cfg.fft),
                                  small, cfg.cfar)),
        (kchain.fused_chain_gos_op(x, gos, gcfg.fft, gcfg.cfar),
         kchain.chain_gos_reference(x, gos, gcfg.fft, gcfg.cfar)),
        (kcfar.fused_mag_gos_dispatch(x, gos, gcfg.cfar),
         kcfar.mag_gos_cfar_reference(x, gos, gcfg.cfar)),
    ]
    for got, want in pairs:
        assert got.threshold.shape == (2, 3, 512)
        assert got.peaks.dtype == torch.bool
        assert torch.equal(got.threshold, want.threshold)
        assert torch.equal(got.peaks, want.peaks)
    assert dict(_build.LAUNCHES) == launches


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


def _assert_struct_mirrors(header, struct, regs_cls):
    text = (_build.CSRC / header).read_text()
    body = re.search(r"struct %s \{(.*?)\};" % struct, text, re.S).group(1)
    fields = re.findall(r"^\s*(int|float)\s+(\w+);", body, re.M)
    ctypes_names = {"int": "c_int", "float": "c_float"}
    assert [(name, ctypes_names[t]) for t, name in fields] == [
        (name, ctype.__name__) for name, ctype in regs_cls._fields_]


def test_register_struct_mirrors_the_cuda_header():
    """``CaRegs`` is passed by value to the C entry points: its fields must be
    ``RspCaRegs``'s, in order, with the same types."""
    _assert_struct_mirrors("ca_cfar.cuh", "RspCaRegs", kcfar.CaRegs)


def test_gos_register_struct_mirrors_the_cuda_header():
    """The same for ``GosRegs`` and ``RspGosRegs``: the 13 registers of
    ``fused_mag_gos_cfar``'s scalars, in their order, then the scaler."""
    _assert_struct_mirrors("gos_cfar.cuh", "RspGosRegs", kcfar.GosRegs)
    assert len(kcfar.GosRegs._fields_) == 14


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


# a stand-in for nvcc: a compile writes its arguments into its object and
# reports them, a link concatenates its objects; -DFAIL fails
_FAKE_NVCC = """#!/bin/sh
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
case " $* " in
  *" -DFAIL "*) echo "error: $*" >&2; exit 1 ;;
  *" -shared "*) shift 3; cat "$@" > "$out" ;;
  *) echo "$*" > "$out"; echo "compiled $*" ;;
esac
"""


def test_variant_builds_take_their_flags_and_stay_apart(monkeypatch, tmp_path):
    """``variants`` builds a library of the sources given for each set of -D
    flags, every source with its build's flags, each library from its own
    objects and with its own compiler report, named apart from the others
    and from the full library; a built variant is not built again, a failed
    compile raises with the compiler's message, and ``BUILDS`` counts none."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.ctypes, "CDLL", str)
    builds = _build.BUILDS
    sources = ("chain_ca.cu", "chain_int.cu")
    flags = [("-DRSP_ROWS_BLOCKS=1",), ("-DRSP_ROWS_BLOCKS=3",)]
    libs = _build.variants(sources, flags)
    assert libs == [str(_build.library_path(sources, f)) for f in flags]
    assert len({*libs, str(_build.library_path())}) == 3
    for (flag,), lib in zip(flags, libs):
        objs = open(lib).read().splitlines()
        assert len(objs) == 2 and all(flag in o for o in objs)
        assert [o.split()[-1].rsplit("/", 1)[-1] for o in objs] == list(sources)
        log = _build.build_log(sources, (flag,))
        assert log.count("compiled") == 2 and log.count(flag) == 2
    assert _build.build_log() == ""
    monkeypatch.setattr(_build, "_nvcc", lambda: pytest.fail("rebuilt"))
    assert _build.variants(sources, flags[:1]) == libs[:1]
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*error: .*-DFAIL"):
        _build.variants(sources, [("-DFAIL",)])
    assert _build.BUILDS == builds


# ---- the GOSCA kernels (C: mag_gos_cfar, D: chain_gos) ----

def _gos_cfgs(n, variant=R.CfarVariant.GOSCA, cash=True, wmax=16):
    cfg_j = R.ChainConfig(
        fft=R.FftConfig(max_size=n),
        cfar=R.CfarConfig(max_ref_window=wmax, max_guard_window=4,
                          variant=variant, include_cash=cash, max_fft_size=n))
    return cfg_j, chain_config_from_reference(cfg_j)


def _rt(raw=None, **regs):
    """JAX registers from ``make()``, then ``raw`` written past its rules."""
    rt_j = R.RuntimeConfig.make(**{"fft_size": 256, "ref_window_size": 8,
                                   "guard_window_size": 2,
                                   "threshold_scaler": 3.0, **regs})
    return dataclasses.replace(rt_j, **{k: jnp.asarray(v, jnp.int32)
                                        for k, v in (raw or {}).items()})


# interpret-mode GOS is slow; each point stays a few seconds
MAG_GOS_REGS = [
    (dict(cfar_algorithm=1, index_lagg=3, index_lead=5), None),
    (dict(cfar_algorithm=1, cfar_mode=1, index_lagg=0, index_lead=7,
          peak_grouping=1), None),
    (dict(cfar_algorithm=1, cfar_mode=2, ref_window_size=16,
          mag_mode=3, log_or_linear=0, threshold_scaler=2.0), None),
    (dict(cfar_algorithm=1, cfar_fft_size=200, peak_grouping=1), None),
    (dict(cfar_mode=3, ref_window_size=16, sub_window_size=4), None),
    (dict(cfar_mode=3, cfar_algorithm=1, sub_window_size=3), None),
    # sub_w > w: no sub-window fits, the noise is 0 and the threshold the
    # (log-domain) scaler
    (dict(cfar_mode=3, sub_window_size=4, mag_mode=3, log_or_linear=0,
          threshold_scaler=2.0), dict(sub_window_size=16)),
]


@pytest.mark.parametrize("regs, raw", MAG_GOS_REGS)
def test_mag_gos_cfar_reference_matches_pallas(regs, raw):
    cfg_j, cfg_t = _gos_cfgs(256)
    spec = _frames((3, 256), seed=7)
    rt_j = _rt(raw, **regs)
    want = fused_mag_gos_cfar(jnp.asarray(spec), rt_j, cfg_j.cfar,
                              interpret=True)
    got = kcfar.mag_gos_cfar_reference(T.as_pair(spec),
                                       runtime_from_reference(rt_j.peek()),
                                       cfg_t.cfar)
    _assert_matches(got, want)


@pytest.mark.parametrize("regs", [
    dict(cfar_algorithm=1, index_lagg=6, index_lead=2),
    dict(cfar_algorithm=1, cfar_mode=1, ref_window_size=16,
         guard_window_size=4, mag_mode=1),
    dict(cfar_mode=3, sub_window_size=4, peak_grouping=1),
])
def test_chain_gos_reference_matches_pallas(regs):
    cfg_j, cfg_t = _gos_cfgs(256)
    x = _frames((3, 256), seed=8)
    rt_j = _rt(**regs)
    want = fused_chain_gos(R.as_pair(x), rt_j, cfg_j.fft, cfg_j.cfar,
                           interpret=True)
    got = kchain.chain_gos_reference(T.as_pair(x),
                                     runtime_from_reference(rt_j.peek()),
                                     cfg_t.fft, cfg_t.cfar)
    _assert_matches(got, want)


def _int_spectra(shape, seed, amp=3):
    """Integer-valued spectra: small integer re / im, so that the SQR
    magnitude (at most 2 amp^2 in the noise) has many ties in every window
    and every statistic, mean and product of the scaler is exact in
    float32; a strong cell at 40 in every frame."""
    rng = np.random.RandomState(seed)
    x = (rng.randint(-amp, amp + 1, shape)
         + 1j * rng.randint(-amp, amp + 1, shape))
    x[..., 40] += 25
    return x.astype(np.complex64)


# integer-valued, tie-heavy points: SQR magnitude, linear scaler 3.5
INT_GOS_REGS = [
    (dict(cfar_algorithm=1, index_lagg=3, index_lead=5), None),
    (dict(cfar_algorithm=1, cfar_mode=1, index_lagg=0, index_lead=7), None),
    (dict(cfar_algorithm=1, cfar_mode=2, ref_window_size=16,
          guard_window_size=1, index_lagg=15, index_lead=8), None),
    (dict(cfar_algorithm=1, ref_window_size=2, guard_window_size=1,
          cfar_fft_size=200), dict(index_lagg=9, index_lead=15)),
    (dict(cfar_algorithm=1, peak_grouping=1, cfar_fft_size=131), None),
]


@pytest.mark.parametrize("regs, raw", INT_GOS_REGS)
def test_mag_gos_cfar_reference_matches_pallas_on_integer_spectra(regs, raw):
    """Tie-heavy windows: the plain selection takes the k-th of the sorted
    multiset, the Pallas kernel its odd-even merge ladder; both are exact
    here, so the thresholds are equal."""
    cfg_j, cfg_t = _gos_cfgs(256)
    spec = _int_spectra((3, 256), seed=11)
    rt_j = _rt(raw, mag_mode=1, threshold_scaler=3.5, **regs)
    want = fused_mag_gos_cfar(jnp.asarray(spec), rt_j, cfg_j.cfar,
                              interpret=True)
    got = kcfar.mag_gos_cfar_reference(T.as_pair(spec),
                                       runtime_from_reference(rt_j.peek()),
                                       cfg_t.cfar)
    _assert_matches(got, want)
    np.testing.assert_array_equal(got.threshold.numpy(),
                                  np.asarray(want.threshold))


def _impulse_frames(shape, seed):
    """Integer-valued IQ frames of four impulses at multiples of N/4: their
    spectrum takes four magnitudes in turn, so every window is full of ties;
    and a tone at bin 40 on top."""
    rng = np.random.RandomState(seed)
    n = shape[-1]
    x = np.zeros(shape, np.complex128)
    for k in range(4):
        x[..., k * n // 4] = (rng.randint(1, 9, shape[:-1])
                              + 1j * rng.randint(-8, 9, shape[:-1]))
    x += 2.0 * np.exp(2j * np.pi * 40 * np.arange(n) / n)
    return x.astype(np.complex64)


@pytest.mark.parametrize("regs", [
    dict(cfar_algorithm=1, index_lagg=2, index_lead=5),
    dict(cfar_algorithm=1, cfar_mode=2, index_lagg=0, index_lead=7,
         mag_mode=1),
])
def test_chain_gos_reference_matches_pallas_on_tied_spectra(regs):
    cfg_j, cfg_t = _gos_cfgs(256)
    x = _impulse_frames((3, 256), seed=12)
    rt_j = _rt(**regs)
    want = fused_chain_gos(R.as_pair(x), rt_j, cfg_j.fft, cfg_j.cfar,
                           interpret=True)
    got = kchain.chain_gos_reference(T.as_pair(x),
                                     runtime_from_reference(rt_j.peek()),
                                     cfg_t.fft, cfg_t.cfar)
    _assert_matches(got, want)


def test_fused_chain_gos_op_shrunken_size_matches_pallas():
    """A shrunken FFT-size register leaves Kernel D: the FFT op, then the
    GOSCA tail's path, in both packages."""
    cfg_j, cfg_t = _gos_cfgs(256)
    x = _frames((3, 256), seed=9)
    rt_j = _rt(fft_size=128, cfar_algorithm=1, index_lagg=4, index_lead=4)
    want = fused_mag_gos_cfar(fft_jax(R.as_pair(x), rt_j.log2_fft_size,
                                      cfg_j.fft), rt_j, cfg_j.cfar,
                              interpret=True)
    got = kchain.fused_chain_gos_op(T.as_pair(x),
                                    runtime_from_reference(rt_j.peek()),
                                    cfg_t.fft, cfg_t.cfar)
    _assert_matches(got, want)


@pytest.mark.parametrize("variant, cash, regs, kernel", [
    (T.CfarVariant.GOSCA, True, dict(), "ca"),
    (T.CfarVariant.GOSCA, True, dict(cfar_mode=1), "ca"),
    (T.CfarVariant.GOSCA, True, dict(cfar_algorithm=1), "gos"),
    (T.CfarVariant.GOSCA, True, dict(cfar_mode=3), "gos"),
    (T.CfarVariant.GOSCA, False, dict(cfar_mode=3), "gos"),
    (T.CfarVariant.GOS, False, dict(), "gos"),
    (T.CfarVariant.GOS, True, dict(cfar_mode=2), "gos"),
])
@pytest.mark.parametrize("fft_size", [256, 128])
def test_gos_stages_dispatch_on_the_registers(monkeypatch, variant, cash,
                                              regs, kernel, fft_size):
    """``fused_chain_gos_op`` and ``fused_mag_gos_dispatch`` choose among the
    four kernels by host ``if``s: CA algorithm outside CASH mode takes the CA
    kernels; GOS, CASH mode and a pure-GOS elaboration the GOSCA ones; a
    shrunken FFT size the spectrum kernels."""
    calls = []
    for mod, name in [(kchain, "chain_ca"), (kchain, "chain_gos"),
                      (kcfar, "mag_cfar"), (kcfar, "mag_gos_cfar")]:
        monkeypatch.setattr(mod, name, lambda *a, _n=name: calls.append(_n))
    cfg = T.ChainConfig(fft=T.FftConfig(max_size=256),
                        cfar=T.CfarConfig(max_ref_window=16, max_guard_window=4,
                                          variant=variant, include_cash=cash))
    rt = T.RuntimeConfig.make(**{"fft_size": fft_size, "ref_window_size": 8,
                                 "guard_window_size": 2, **regs})
    x = T.as_pair(_frames((2, 256)))
    kchain.fused_chain_gos_op(x, rt, cfg.fft, cfg.cfar)
    kcfar.fused_mag_gos_dispatch(x, rt, cfg.cfar)
    tail = "mag_cfar" if kernel == "ca" else "mag_gos_cfar"
    first = f"chain_{kernel}" if fft_size == 256 else tail
    assert calls == [first, tail]


def test_gos_registers_resolve_the_elaboration_on_the_host():
    """``gos_registers`` clamps as ``fused_mag_gos_cfar`` clamps its scalars
    and resolves mode and algorithm as ``cfar_op`` does."""
    cfg = T.CfarConfig(max_ref_window=32, max_guard_window=4)
    rt = T.RuntimeConfig.make(ref_window_size=64, guard_window_size=9,
                              mag_mode=7, cfar_fft_size=5000, cfar_mode=3,
                              cfar_algorithm=1, threshold_scaler=0.1)
    rt = dataclasses.replace(rt, index_lagg=-3, index_lead=99,
                             sub_window_size=1)
    regs = kcfar.gos_registers(rt, cfg, 1024)
    assert (regs.log2w, regs.guard, regs.mag_mode) == (5, 4, 3)
    assert (regs.active_lo, regs.active_hi) == (0, 1024)
    assert (regs.rank_lagg, regs.rank_lead, regs.sub_w) == (0, 31, 2)
    assert (regs.cfar_mode, regs.algorithm) == (3, 1)
    assert regs.scaler == float(np.float32(0.1))
    no_cash = dataclasses.replace(cfg, include_cash=False)
    assert kcfar.gos_registers(rt, no_cash, 1024).cfar_mode == 0
    pure = dataclasses.replace(cfg, variant=T.CfarVariant.GOS)
    ca_reg = dataclasses.replace(rt, cfar_algorithm=0, cfar_mode=1)
    assert kcfar.gos_registers(ca_reg, pure, 1024).algorithm == 1
    assert kcfar.gos_registers(ca_reg, cfg, 1024).algorithm == 0
    assert kcfar.gos_registers(dataclasses.replace(rt, cfar_fft_size=700),
                               cfg, 1024).active_hi == 700


def test_gos_wrappers_check_shapes_and_window_bounds():
    _, cfg = _gos_cfgs(1024)
    rt = T.RuntimeConfig.make(cfar_algorithm=1)
    with pytest.raises(ValueError):       # N % 256
        kcfar.mag_gos_cfar(T.as_pair(_frames((2, 384))), rt, cfg.cfar)
    # the halo-extended length of the sharded tail is a multiple of 256
    out = kcfar.mag_gos_cfar(T.as_pair(_frames((1, 1280))), rt, cfg.cfar)
    assert out.threshold.shape == (1, 1280)
    with pytest.raises(ValueError):       # N is not the elaborated max_size
        kchain.chain_gos(T.as_pair(_frames((2, 512))), rt, cfg.fft, cfg.cfar)
    with pytest.raises(ValueError):       # a window is not in the kernel
        kchain.chain_gos(T.as_pair(_frames((2, 1024))), rt,
                         T.FftConfig(max_size=1024, window="hann"), cfg.cfar)
    reach = T.CfarConfig(max_ref_window=64, max_guard_window=64)
    with pytest.raises(ValueError):       # max_ref + max_guard + 1 > 128
        kcfar.mag_gos_cfar(T.as_pair(_frames((2, 1024))), rt, reach)
    meta = T.C(torch.empty(2, 1024, device="meta"),
               torch.empty(2, 1024, device="meta"))
    with pytest.raises(ValueError):       # neither CPU nor CUDA
        kchain.chain_gos(meta, rt, cfg.fft, cfg.cfar)
    with pytest.raises(ValueError):
        kcfar.mag_gos_cfar(meta, rt, cfg.cfar)
