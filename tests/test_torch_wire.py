"""The PyTorch port's wire top (``rx_fft_mag_cfar_tx_chain``, Kernel E's
plain version) and ``packing`` against the JAX package's, the rule that
numpy input goes to the chain's device, and float-fidelity quantization.

Bars: packing, the bit-true wire top and quantization exact; the float wire
top at the JAX bench's wire bar (``bench.py:655-679``): bins equal, the
threshold field within 2 LSB and 0.05 LSB on average, peak flips <= 1e-5 of
the cells."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu import numerics as JN
from rsp_chains_tpu import packing as JP
from rsp_chains_tpu.kernels.chain_pallas import fused_chain_ca_packed

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch import numerics as TN
from rsp_chains_tpu_torch import packing as TP
from rsp_chains_tpu_torch.convert import (
    chain_config_from_reference, runtime_from_reference,
)
from rsp_chains_tpu_torch.kernels import chain as kchain

N = 256
BW = 8
CA = R.CfarConfig(max_ref_window=32, max_guard_window=8,
                  variant=R.CfarVariant.CA, include_cash=False)


def _u32(words: torch.Tensor) -> np.ndarray:
    return words.numpy().view(np.uint32)


def _iq16(seed, frames=8, n=N):
    """Integer IQ: noise and a tone, as the bench quantizes its frames."""
    rng = np.random.RandomState(seed)
    x = (rng.randn(frames, n) + 1j * rng.randn(frames, n)) * 40
    x += 900 * np.exp(2j * np.pi * 0.21 * np.arange(n))
    return (np.clip(np.round(x.real), -32767, 32767)
            + 1j * np.clip(np.round(x.imag), -32767, 32767)).astype(np.complex64)


# ---- packing ----

def test_pack_iq_matches_jax_and_round_trips():
    rng = np.random.RandomState(0)
    re = np.concatenate([[32767, -32767, -32768, 0, -1, 1],
                         rng.randint(-32768, 32768, 250)])
    im = np.concatenate([[-32768, 32767, -1, -32767, 0, 32767],
                         rng.randint(-32768, 32768, 250)])
    iq = (re + 1j * im).astype(np.complex64)
    want = np.asarray(JP.pack_iq(jnp.asarray(iq)))
    got = TP.pack_iq(iq)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(_u32(TP.pack_iq(T.as_pair(iq))), want)
    back = TP.unpack_iq_pair(want)            # uint32 numpy in
    want_back = JP.unpack_iq_pair(jnp.asarray(want))
    np.testing.assert_array_equal(back.re.numpy(), np.asarray(want_back.re))
    np.testing.assert_array_equal(back.im.numpy(), np.asarray(want_back.im))
    np.testing.assert_array_equal(TP.unpack_iq(got).numpy(), iq)
    assert back.re[2] == -32768 and back.im[0] == -32768
    assert back.re[1] == -32767 and back.im[1] == 32767


@pytest.mark.parametrize("bw", [8, 10])
@pytest.mark.parametrize("kind", ["float", "int", "cut"])
def test_pack_cfar_words_matches_jax(bw, kind):
    n = 1 << bw
    rng = np.random.RandomState(bw)
    top = float((1 << (31 - bw)) - 1)
    thr = np.concatenate([[-5.0, 0.0, 0.99, top, top + 1, 1e12, 2.5],
                          rng.uniform(-10, 1.2 * top, n - 7)])
    if kind == "int":
        thr = np.clip(thr, -2**31, 2**31 - 1).astype(np.int32)
    else:
        thr = thr.astype(np.float32)
    pk = rng.randint(0, 2, n).astype(bool)
    cut = None
    if kind == "cut":
        cut = np.concatenate([[-3.5, 0.5, 2**33, n + 3.7],
                              rng.uniform(-50, 5000, n - 4)]).astype(np.float32)
    want = np.asarray(JP.pack_cfar_words(
        jnp.asarray(thr), jnp.asarray(pk), bw,
        cut=None if cut is None else jnp.asarray(cut)))
    got = TP.pack_cfar_words(torch.from_numpy(thr), torch.from_numpy(pk), bw,
                             cut=None if cut is None else torch.from_numpy(cut))
    np.testing.assert_array_equal(_u32(got), want)
    for a, b in zip(TP.unpack_cfar_words(got, bw),
                    JP.unpack_cfar_words(want, bw)):
        np.testing.assert_array_equal(a.numpy(), b)


# ---- the wire top ----

def _cfg(cfar=CA, **fp):
    return R.ChainConfig(fft=R.FftConfig(max_size=N), cfar=cfar,
                         **({"fixed_point": R.FixedPointConfig(**fp)}
                            if fp else {}))


@functools.lru_cache(maxsize=None)
def _wire_j(cfg_j):
    return R.rx_fft_mag_cfar_tx_chain(cfg_j).jit()


def _plain(cfg_j):
    return dataclasses.replace(cfg_j, cfar=dataclasses.replace(
        cfg_j.cfar, use_pallas=False))


def _assert_wire_bar(got: np.ndarray, want: np.ndarray, bw: int):
    tg, bg, pg = JP.unpack_cfar_words(got, bw)
    tw, bwant, pw = JP.unpack_cfar_words(want, bw)
    np.testing.assert_array_equal(bg, bwant)
    err = np.abs(tg.astype(np.int64) - tw.astype(np.int64))
    assert err.max() <= 2 and err.mean() <= 0.05, (err.max(), err.mean())
    assert np.sum(pg != pw) <= 1e-5 * pg.size, np.sum(pg != pw)


@pytest.mark.parametrize("regs", [
    dict(),
    dict(fft_size=128),
    dict(cfar_mode=1, peak_grouping=1, mag_mode=0),
    dict(mag_mode=3, log_or_linear=0, threshold_scaler=2.0),
    dict(cfar_fft_size=200, ref_window_size=8, guard_window_size=2),
])
def test_float_wire_chain_matches_jax_at_the_wire_bar(regs):
    cfg_j = _cfg()
    chain = T.rx_fft_mag_cfar_tx_chain(chain_config_from_reference(cfg_j),
                                       device="cpu")
    assert chain.stage_names == ("rx_fft_mag_cfar_tx_fused",)
    assert chain.stage_names == R.rx_fft_mag_cfar_tx_chain(cfg_j).stage_names
    words = np.asarray(JP.pack_iq(jnp.asarray(_iq16(1))))
    rt_j = R.RuntimeConfig.make(**{"fft_size": N, **regs})
    got = chain(words, runtime_from_reference(rt_j.peek()))
    want = np.asarray(_wire_j(_plain(cfg_j))(jnp.asarray(words), rt_j))
    _assert_wire_bar(_u32(got), want, BW)


def test_wire_ca_reference_matches_the_jax_packed_kernel():
    """Against ``fused_chain_ca_packed`` in interpret mode (3 frames)."""
    cfg_t = chain_config_from_reference(_cfg())
    words = np.asarray(JP.pack_iq(jnp.asarray(_iq16(2, frames=3))))
    rt_j = R.RuntimeConfig.make(fft_size=N, ref_window_size=16,
                                guard_window_size=3, div_sum=4)
    want = np.asarray(fused_chain_ca_packed(jnp.asarray(words), rt_j,
                                            R.FftConfig(max_size=N), CA,
                                            interpret=True))
    got = kchain.wire_ca(words, runtime_from_reference(rt_j.peek()),
                         cfg_t.fft, cfg_t.cfar)
    _assert_wire_bar(_u32(got), want, BW)


@pytest.mark.parametrize("cfar, stages", [
    (R.CfarConfig(max_ref_window=32, max_fft_size=N),
     ("rx_unpack", "fft_mag_gos_cfar_fused", "tx_pack")),
    (dataclasses.replace(CA, send_cut=True),
     ("rx_unpack", "fft", "logmag", "cfar", "tx_pack")),
    (dataclasses.replace(CA, include_cash=True),
     ("rx_unpack", "fft", "logmag", "cfar", "tx_pack")),
])
def test_unfused_float_wire_chains_match_jax(cfar, stages):
    cfg_j = _cfg(cfar)
    chain = T.rx_fft_mag_cfar_tx_chain(chain_config_from_reference(cfg_j),
                                       device="cpu")
    assert chain.stage_names == stages
    assert chain.stage_names == R.rx_fft_mag_cfar_tx_chain(cfg_j).stage_names
    words = np.asarray(JP.pack_iq(jnp.asarray(_iq16(3))))
    rt_j = R.RuntimeConfig.make(fft_size=N, ref_window_size=16,
                                guard_window_size=2, cfar_algorithm=1,
                                index_lagg=5, index_lead=9)
    got = _u32(chain(words, runtime_from_reference(rt_j.peek())))
    want = np.asarray(_wire_j(_plain(cfg_j))(jnp.asarray(words), rt_j))
    if not cfar.send_cut:
        _assert_wire_bar(got, want, BW)
        return
    # the bin field holds the truncated cell under test: a float magnitude
    # that rounds across an integer may differ there by one
    tg, cg, pg = JP.unpack_cfar_words(got, BW)
    tw, cw, pw = JP.unpack_cfar_words(want, BW)
    assert np.abs(tg.astype(np.int64) - tw).max() <= 2
    assert np.sum(cg != cw) <= 2 and np.sum(pg != pw) == 0


@pytest.mark.parametrize("cfar, regs", [
    (CA, dict(mag_mode=1, peak_grouping=1)),
    (R.CfarConfig(max_ref_window=32, max_fft_size=N),
     dict(cfar_algorithm=1, index_lagg=3, index_lead=12)),
    (R.CfarConfig(max_ref_window=32, max_fft_size=N),
     dict(cfar_mode=3, sub_window_size=4)),
])
def test_bit_true_wire_chain_matches_jax_exactly(cfar, regs):
    cfg_j = _cfg(cfar, enabled=True, width=16, bin_point=0, bit_true=True)
    chain = T.rx_fft_mag_cfar_tx_chain(chain_config_from_reference(cfg_j),
                                       device="cpu")
    assert chain.stage_names == ("rx_unpack", "fft_mag_cfar_int_fused",
                                 "tx_pack")
    assert chain.stage_names == R.rx_fft_mag_cfar_tx_chain(cfg_j).stage_names
    words = np.asarray(JP.pack_iq(jnp.asarray(_iq16(4))))
    rt_j = R.RuntimeConfig.make(**{"fft_size": N, "ref_window_size": 16,
                                   "guard_window_size": 2, **regs})
    got = chain(words, runtime_from_reference(rt_j.peek()))
    want = np.asarray(_wire_j(_plain(cfg_j))(jnp.asarray(words), rt_j))
    np.testing.assert_array_equal(_u32(got), want)


# ---- numpy input goes to the chain's device ----

def test_numpy_input_goes_to_the_device_and_raises_without_a_card():
    """numpy input with no ``device`` goes to CUDA, so without a card the
    call raises instead of running on the CPU; ``device="cpu"`` runs, and
    CPU tensors stay the explicit way to the plain versions."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    cfg = chain_config_from_reference(_cfg())
    rt = T.RuntimeConfig.make(fft_size=N)
    iq = _iq16(5, frames=2)
    words = _u32(TP.pack_iq(iq))
    for make, x in ((T.fft_mag_cfar_chain, iq),
                    (T.rx_fft_mag_cfar_tx_chain, words)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(cfg)(x, rt)
        on_cpu = make(cfg, device="cpu")(x, rt)
        from_tensors = make(cfg)(TP.as_words(words) if x is words
                                 else T.as_pair(x), rt)
        got = on_cpu if x is words else on_cpu.threshold
        want = from_tensors if x is words else from_tensors.threshold
        assert got.device.type == "cpu" and torch.equal(got, want)
    assert T.fft_mag_cfar_chain(cfg).device == torch.device("cuda")


# ---- float-fidelity quantization ----

@pytest.mark.parametrize("rounding", list(R.Rounding))
@pytest.mark.parametrize("width, bin_point", [(16, 0), (12, 4), (8, 2)])
def test_quantize_matches_jax(rounding, width, bin_point):
    rng = np.random.RandomState(width)
    x = np.concatenate([rng.randn(200) * 300,
                        np.arange(-8, 8) + 0.5, [1e9, -1e9]]).astype(np.float32)
    fp_j = R.FixedPointConfig(enabled=True, width=width, bin_point=bin_point,
                              rounding=rounding)
    fp_t = chain_config_from_reference(R.ChainConfig(fixed_point=fp_j)).fixed_point
    np.testing.assert_array_equal(
        TN.quantize(torch.from_numpy(x), fp_t).numpy(),
        np.asarray(JN.quantize(jnp.asarray(x), fp_j)))
    z = (x + 1j * x[::-1]).astype(np.complex64)
    np.testing.assert_array_equal(
        TN.quantize(torch.from_numpy(z), fp_t).numpy(),
        np.asarray(JN.quantize(jnp.asarray(z), fp_j)))
    pair = TN.quantize(T.as_pair(z), fp_t)
    np.testing.assert_array_equal(T.to_numpy(pair),
                                  np.asarray(JN.quantize(jnp.asarray(z), fp_j)))
    off = dataclasses.replace(fp_t, enabled=False)
    assert TN.quantize(torch.from_numpy(x), off) is not None
    assert torch.equal(TN.quantize(torch.from_numpy(x), off),
                       torch.from_numpy(x))


def test_saturate_and_snr_match_jax():
    v = np.arange(-40000, 40000, 777, dtype=np.int32)
    np.testing.assert_array_equal(
        TN.saturate_int(torch.from_numpy(v), 16).numpy(),
        np.asarray(JN.saturate_int(jnp.asarray(v), 16)))
    a = _iq16(6, frames=1)
    b = a + 0.25
    assert TN.snr_db(torch.from_numpy(a), b) == pytest.approx(JN.snr_db(a, b))
    assert TN.snr_db(a, a) == float("inf")
