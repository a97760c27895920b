"""The port's signal sources against the JAX package's, on the CPU: the PLFG
programs, the NCO's dither stream (bit for bit against
``jax.random.uniform``), the NCO over its options, ``rfft_op``, the
register file's profile and the fixtures. Inputs are made from numpy seeds.
The source presets are held in ``test_torch_source_presets.py`` and
``test_torch_source_rx.py``.

Bars: the PLFG profiles, the dither and the fixtures exactly; the NCO
exactly on its quantized paths with integer words and within 1e-5 of the
amplitude elsewhere (XLA's and torch's cos and sin differ in the last
bit), but for samples whose accumulated phase lies within the summation's
rounding of a rounding edge (``_near_a_rounding_edge``); ``rfft_op`` within
1e-5 of the largest bin."""

import importlib

import jax
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.golden import fixtures as RF
from rsp_chains_tpu.golden import nco_golden
from rsp_chains_tpu.ops import plfg as RP
from rsp_chains_tpu.ops.fft import rfft_op as rfft_j

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.golden import fixtures as TF
from rsp_chains_tpu_torch.ops import nco as TN
from rsp_chains_tpu_torch.ops import plfg as TP
from rsp_chains_tpu_torch.ops.fft import rfft_op as rfft_t

RN = importlib.import_module("rsp_chains_tpu.ops.nco")  # the package
# ``rsp_chains_tpu.ops`` exports a function of the same name

N = 1024
CPU = torch.device("cpu")


# ---- PLFG ----

# each program as (chirps of (num_samples, increment, reset_to_start)
# segments, repeat_counts, chirp_ordinals, num_frames); the first is
# tests/test_rsp_chain.py's, the next two the reprogramming test's
PROGRAMS = {
    "two chirps, repeats, two frames": (
        (((4, 0.0, False), (4, 1.0, False)), ((8, -0.5, False),)),
        (2, 1), (0, 1), 2),
    "constant tone repeated": ((((256, 0.0, False),),), (4,), (0,), 1),
    "held offset": ((((1, 8.0, False), (255, 0.0, False)),), (4,), (0,), 1),
    "reset to start": (
        (((5, 1.5, False), (3, -2.0, True), (6, 0.25, False)),), (1,), (0,),
        1),
    "ordinals reorder and repeat": (
        (((3, 1.0, False),), ((2, -1.0, False),), ((4, 0.5, True),)),
        (1, 3, 2), (2, 0, 1, 2), 3),
    "an ordinal without a repeat count": (
        (((3, 1.0, False),), ((2, 0.0, False),)), (2,), (0, 1), 1),
    "empty segments": ((((0, 1.0, False),),), (1,), (0,), 1),
    "too many segments": ((((1, 0.0, False),) * 5,), (1,), (0,), 1),
    "too many chirps": ((((1, 0.0, False),),) * 9, (1,), (0,), 1),
    "too many frames": ((((8, 1.0, False),),), (1,), (0,), 5),
    "segment too long": ((((257, 0.0, False),),), (1,), (0,), 1),
    "repeat count too large": ((((8, 0.0, False),),), (9,), (0,), 1),
    "ordinal out of range": ((((8, 0.0, False),),), (1,), (1,), 1),
}


def _program(pkg, spec):
    chirps, reps, ordinals, frames = spec
    return pkg.PlfgProgram(
        chirps=tuple(tuple(pkg.Segment(n, inc, reset) for n, inc, reset in c)
                     for c in chirps),
        repeat_counts=reps, chirp_ordinals=ordinals, num_frames=frames)


def _lfm(pkg, name):
    return {"lfm 1024 / 64 words": lambda: pkg.lfm_program(1024, 64.0),
            "lfm 300 / -17.5 words, 3 frames": lambda: pkg.lfm_program(
                300, -17.5, num_frames=3, max_segment=100)}[name]()


def _both(name):
    if name in PROGRAMS:
        return _program(RP, PROGRAMS[name]), _program(TP, PROGRAMS[name])
    return _lfm(RP, name), _lfm(TP, name)


def _refusal(program, cfg):
    try:
        program.validate(cfg)
    except ValueError as e:
        return str(e)
    return None


@pytest.mark.parametrize("name", list(PROGRAMS) + [
    "lfm 1024 / 64 words", "lfm 300 / -17.5 words, 3 frames"])
def test_plfg_programs_compile_to_the_jax_profiles(name):
    prog_j, prog_t = _both(name)
    cfg_j, cfg_t = R.PlfgConfig(), T.PlfgConfig()
    refusal = _refusal(prog_j, cfg_j)
    assert _refusal(prog_t, cfg_t) == refusal
    if refusal is not None:
        with pytest.raises(ValueError, match=refusal):
            TP.compile_program(prog_t, cfg_t, N)
        return
    for cfg in (None, "elaborated"):
        got = TP.chirp_profile(prog_t, cfg and cfg_t)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, RP.chirp_profile(prog_j,
                                                            cfg and cfg_j))
    for frame_len in (N, 100):
        np.testing.assert_array_equal(
            TP.compile_program(prog_t, cfg_t, frame_len),
            RP.compile_program(prog_j, cfg_j, frame_len))


def test_a_single_segment_or_a_flat_tuple_is_one_chirp():
    for chirps in (lambda p: p.Segment(8, 1.0),
                   lambda p: (p.Segment(4, 1.0), p.Segment(4, -1.0, True))):
        prog_j, prog_t = (p.PlfgProgram(chirps=chirps(p)) for p in (RP, TP))
        assert len(prog_t.chirps) == len(prog_j.chirps) == 1
        np.testing.assert_array_equal(TP.chirp_profile(prog_t),
                                      RP.chirp_profile(prog_j))


def test_the_package_exports_the_plfg_names():
    assert T.PlfgProgram is TP.PlfgProgram and T.Segment is TP.Segment
    assert T.lfm_program is TP.lfm_program
    x = T.C(torch.ones(3), torch.full((3,), 2.0))
    assert torch.equal(T.join(x), torch.complex(x.re, x.im))


# ---- the dither stream ----

DITHER_SHAPES = [(1024,), (3, 1024), (2, 5, 7), (3, 256), (1,), (64, 33)]


@pytest.mark.parametrize("shape", DITHER_SHAPES)
@pytest.mark.parametrize("seed", [0x5EED, 0, 1, 123456789])
def test_the_dither_stream_is_jax_uniform_bit_for_bit(seed, shape):
    want = np.asarray(jax.random.uniform(jax.random.key(seed), shape,
                                         minval=-0.5, maxval=0.5))
    oracle = TN.dither_stream_np(seed, shape)
    assert oracle.dtype == np.float32
    np.testing.assert_array_equal(oracle, want)
    got = TN.dither_stream(seed, shape, CPU)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), oracle)


# ---- the NCO ----

def _words(kind):
    rng = np.random.RandomState(11110)
    if kind == "integer":
        w = rng.randint(-40, 41, size=(3, 256)).astype(np.float32)
        w[0] = 16.0  # a constant tone
        return w
    # fractional: LFM ramps, and seeded fractions
    w = rng.uniform(-30.0, 30.0, size=(3, 256)).astype(np.float32)
    w[0] = 16.0 + 64.0 * np.arange(256, dtype=np.float32) / 256.0
    w[1] = 7.37
    return w


NCO_GRID = [(acc, raster, dither, lut)
            for acc in (True, False) for raster in (False, True)
            for dither in (False, True)
            for lut in ("float", "table", "interpolated")]


def _near_a_rounding_edge(words, offset, cfg, dither):
    """Samples where a phase within the summation's rounding of JAX's
    could round to another integer: JAX's cumulative sum runs in another
    order than torch's (an XLA reduce-window), and two float32 sums of i + 1
    terms each lie within i * 2^-24 * sum|w| of the exact one. The
    decisions are ``rasterized_mode``'s round of the phase and the table's
    round of its index (``round`` halves to even)."""
    import jax.numpy as jnp

    phase = np.asarray(jnp.cumsum(jnp.asarray(words), axis=-1)) + np.float32(
        offset)
    i = np.arange(1, words.shape[-1] + 1)
    delta = 2 * i * 2.0 ** -24 * np.cumsum(np.abs(words), axis=-1)
    edge = np.zeros(words.shape, bool)
    if cfg.rasterized_mode:
        edge |= np.abs(phase - np.floor(phase) - 0.5) <= delta
        phase = np.mod(np.round(phase), 2 ** cfg.phase_width).astype(
            np.float32)
        delta = np.zeros_like(delta)
    if dither:
        phase = phase + TN.dither_stream_np(0x5EED, words.shape)
    if cfg.quantized_lut and not cfg.n_interpolation_terms:
        v = phase * np.float32(4 * cfg.table_size / 2 ** cfg.phase_width)
        edge |= np.abs(v - np.floor(v) - 0.5) <= delta
    return edge


@pytest.mark.parametrize("kind", ["integer", "fractional"])
@pytest.mark.parametrize("acc, raster, dither, lut", NCO_GRID)
def test_nco_matches_jax(acc, raster, dither, lut, kind):
    """Exact on the quantized paths with integer words (dither included);
    elsewhere within 1e-5 of the amplitude, except, with accumulated
    fractional words, samples whose phase lies within the two sums'
    rounding of a rounding edge (``_near_a_rounding_edge``)."""
    kw = dict(table_size=128, phase_width=9, phase_acc_enable=acc,
              rasterized_mode=raster, dither_enable=dither,
              quantized_lut=lut != "float",
              n_interpolation_terms=int(lut == "interpolated"))
    cfg_j, cfg_t = R.NcoConfig(**kw), T.NcoConfig(**kw)
    words = _words(kind)
    offset = 5.0 if kind == "integer" else 2.75
    want = RN.nco(words, cfg_j, phase_offset=offset, pair=True)
    got = TN.nco(torch.from_numpy(words), cfg_t, phase_offset=offset,
                 pair=True)
    assert isinstance(got, T.C) and got.re.dtype == torch.float32
    exact = lut != "float" and kind == "integer"
    edge = (_near_a_rounding_edge(words, offset, cfg_t, dither)
            if acc and kind == "fractional" else np.zeros(words.shape, bool))
    for g, w in ((got.re, want.re), (got.im, want.im)):
        d = np.abs(g.numpy() - np.asarray(w))
        if exact:
            assert not d.any()
            continue
        apart = d > 1e-5 * cfg_t.amplitude
        assert not apart[~edge].any(), d[~edge].max()
        assert apart.mean() < 0.05, apart.mean()
    as_complex = TN.nco(words, cfg_t, phase_offset=offset)
    assert as_complex.dtype == torch.complex64
    assert torch.equal(as_complex, torch.complex(got.re, got.im))


def test_nco_amplitude_and_wide_accumulator_match_jax():
    """phase_width above log2(4 * table_size): the top accumulator bits
    index the table; the amplitude property is JAX's."""
    for kw in (dict(phase_width=12, quantized_lut=True),
               dict(phase_width=12), dict(table_width=12, quantized_lut=True)):
        cfg_j, cfg_t = R.NcoConfig(**kw), T.NcoConfig(**kw)
        assert cfg_t.amplitude == cfg_j.amplitude
        words = np.full((2, 1024), 128.0, np.float32)
        want = np.asarray(RN.nco(words, cfg_j))
        got = TN.nco(torch.from_numpy(words), cfg_t).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * cfg_t.amplitude)
        assert np.argmax(np.abs(np.fft.fft(got[0]))) == (
            128 * 1024 >> cfg_t.phase_width)


@pytest.mark.parametrize("start", [8, 16, 64])
def test_nco_peak_bin_contract_against_the_golden(start):
    """A constant word s puts the tone at bin s * N / (4 * table_size):
    the quantized table against ``golden.nco_golden`` (within 2 LSB, the
    JAX test's bar), the float path by its spectrum's maximum."""
    cfg = T.NcoConfig(table_size=128, phase_width=9, quantized_lut=True)
    peak = start * N // (4 * cfg.table_size)
    got = TN.nco(torch.full((N,), float(start)), cfg).numpy()
    want = nco_golden(N, peak, N)
    np.testing.assert_allclose(got.real, want.real, atol=2)
    np.testing.assert_allclose(got.imag, want.imag, atol=2)
    flt = TN.nco(torch.full((N,), float(start)), T.NcoConfig()).numpy()
    assert np.argmax(np.abs(np.fft.fft(flt))) == peak


# ---- rfft ----

@pytest.mark.parametrize("shape", [(3, 256), (2, 4, 1024), (1, 8)])
def test_rfft_op_matches_jax(shape):
    x = (np.random.RandomState(len(shape)).randn(*shape) * 1000).astype(
        np.float32)
    want = rfft_j(x, pair=True)
    got = rfft_t(torch.from_numpy(x), pair=True)
    assert got.re.shape == shape[:-1] + (shape[-1] // 2 + 1,)
    scale = max(np.abs(np.asarray(want.re)).max(),
                np.abs(np.asarray(want.im)).max())
    for g, w in ((got.re, want.re), (got.im, want.im)):
        assert np.abs(g.numpy() - np.asarray(w)).max() / scale < 1e-5
    as_complex = rfft_t(x)
    assert as_complex.dtype == torch.complex64
    assert torch.equal(as_complex, torch.complex(got.re, got.im))
    with pytest.raises(ValueError, match="power of two"):
        rfft_t(torch.zeros(3, 100))


def test_source_presets_raise_when_built_for_cuda_without_a_card():
    """No fallback: built for CUDA (the default) on a host with no card,
    the source presets raise; ``device="cpu"`` builds them."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    for make in (T.rsp_chain_vanilla, T.chain_with_mem, T.real_rx_chain):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(device="cuda")
        assert make(device="cpu").device == CPU


def test_runtime_config_keeps_a_tensor_profile_where_it_lies():
    prof = torch.arange(64, dtype=torch.float64)
    rt = T.RuntimeConfig.make(fft_size=64, ref_window_size=8,
                              guard_window_size=2, plfg_profile=prof)
    assert isinstance(rt.plfg_profile, torch.Tensor)
    assert rt.plfg_profile.dtype == torch.float32
    assert torch.equal(rt.plfg_profile, prof.float())
    rt2 = rt.merge_regs(threshold_scaler=9.0, nco_freq_word=3)
    assert rt2.plfg_profile is rt.plfg_profile and rt2.threshold_scaler == 9.0
    assert "plfg_profile" not in rt.peek()
    f32 = torch.zeros(64)
    assert T.RuntimeConfig.make(plfg_profile=f32).plfg_profile is f32
    as_np = T.RuntimeConfig.make(plfg_profile=[1, 2]).plfg_profile
    assert isinstance(as_np, np.ndarray) and as_np.dtype == np.float32


# ---- fixtures ----

def test_the_new_fixtures_equal_the_jax_packages():
    for f in (0.125, 0.3):
        np.testing.assert_array_equal(TF.real_tone(N, f),
                                      RF.real_tone(N, f))
        np.testing.assert_array_equal(TF.real_tone(N, f, scale=4),
                                      RF.real_tone(N, f, scale=4))
    assert TF.BARKER_CODES == RF.BARKER_CODES
    for length in RF.BARKER_CODES:
        for chips in (1, 3):
            np.testing.assert_array_equal(TF.barker_code(length, chips),
                                          RF.barker_code(length, chips))
    with pytest.raises(ValueError, match="no Barker code of length 6"):
        TF.barker_code(6)
    for m in (2, 4, 7):
        np.testing.assert_array_equal(TF.frank_code(m), RF.frank_code(m))
    assert T.golden.frank_code is TF.frank_code
