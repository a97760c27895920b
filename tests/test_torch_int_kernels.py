"""The plain versions of the PyTorch port's bit-true integer kernels, Kernel
F (``chain_int_reference``) and Kernel G (``chain_int_gos_reference``),
against the JAX package's integer Pallas kernels in interpret mode, as
``tests/test_int_chain.py`` runs them, and the wrappers' refusals.

Bar: every integer equal, every peak equal. Inputs are seeded numpy arrays
of 16-bit integers, N = 256, 3 frames."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.cplx import C as JC
from rsp_chains_tpu.kernels import int_chain_pallas as JK

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.convert import (
    chain_config_from_reference, runtime_from_reference,
)
from rsp_chains_tpu_torch.kernels import int_chain as TK
from rsp_chains_tpu_torch.ops.bit_true import INT_MAX, fft_int_op, mag_int_op

N = 256
CA = R.CfarConfig(max_ref_window=32, max_guard_window=8,
                  variant=R.CfarVariant.CA, include_cash=False)
GOSCA = R.CfarConfig(max_ref_window=16, max_guard_window=4,
                     variant=R.CfarVariant.GOSCA, include_cash=True,
                     max_fft_size=N)


def _iq(seed, frames=3, n=N, amp=30000):
    rng = np.random.RandomState(seed)
    return (rng.randint(-amp, amp, (frames, n)).astype(np.int32),
            rng.randint(-amp, amp, (frames, n)).astype(np.int32))


def _pair_j(re, im):
    return JC(jnp.asarray(re), jnp.asarray(im))


def _pair_t(re, im):
    return T.C(torch.from_numpy(re), torch.from_numpy(im))


def _regs(**kw):
    rt_j = R.RuntimeConfig.make(**{"fft_size": N, **kw})
    return rt_j, runtime_from_reference(rt_j.peek())


def _assert_equal(got, want):
    np.testing.assert_array_equal(got.threshold.numpy(),
                                  np.asarray(want.threshold))
    np.testing.assert_array_equal(got.peaks.numpy(), np.asarray(want.peaks))


@pytest.mark.parametrize("regs, fft", [
    (dict(mag_mode=0, cfar_mode=1, ref_window_size=16, guard_window_size=3,
          div_sum=4), {}),
    (dict(mag_mode=1, log_or_linear=0, peak_grouping=1, threshold_scaler=2.5),
     {}),
    (dict(mag_mode=2, cfar_mode=2, cfar_fft_size=200),
     dict(expand_logic=(0, 1, 0, 0, 0, 0, 0, 0),
          keep_msb_or_lsb=(1, 0, 1, 1, 1, 1, 1, 1))),
])
def test_chain_int_reference_matches_the_jax_kernel(regs, fft):
    re, im = _iq(4, frames=3, amp=32768)
    fft_j = R.FftConfig(max_size=N, **fft)
    rt_j, rt_t = _regs(**regs)
    want = JK.fused_chain_int(_pair_j(re, im), rt_j, fft_j, CA,
                              interpret=True)
    cfg_t = chain_config_from_reference(R.ChainConfig(fft=fft_j, cfar=CA))
    _assert_equal(TK.chain_int(_pair_t(re, im), rt_t, cfg_t.fft, cfg_t.cfar),
                  want)


@pytest.mark.parametrize("regs", [
    dict(cfar_algorithm=1, ref_window_size=8, guard_window_size=2,
         index_lagg=4, index_lead=5, peak_grouping=1),
    dict(cfar_algorithm=1, cfar_mode=2, mag_mode=1, ref_window_size=4,
         guard_window_size=1, index_lagg=1, index_lead=3),
    dict(cfar_algorithm=0, cfar_mode=1, mag_mode=0, ref_window_size=16,
         guard_window_size=4),
])
def test_chain_int_gos_reference_matches_the_jax_kernel(regs):
    re, im = _iq(5, frames=3)
    fft_j = R.FftConfig(max_size=N)
    rt_j, rt_t = _regs(threshold_scaler=3.5, sub_window_size=2, **regs)
    want = JK.fused_chain_int_gos(_pair_j(re, im), rt_j, fft_j, GOSCA,
                                  interpret=True)
    cfg_t = chain_config_from_reference(R.ChainConfig(fft=fft_j, cfar=GOSCA))
    _assert_equal(
        TK.chain_int_gos(_pair_t(re, im), rt_t, cfg_t.fft, cfg_t.cfar), want)


GOSCA64 = R.CfarConfig(max_ref_window=64, max_guard_window=8,
                       variant=R.CfarVariant.GOSCA, include_cash=True,
                       max_fft_size=N)


def _impulses(frames=3):
    """Frames whose integer spectrum is flat: every magnitude equal."""
    re = np.zeros((frames, N), np.int32)
    re[:, 0] = 1000 * np.arange(1, frames + 1)
    return re, np.zeros_like(re)


# the rank selection's edge cases, the points Kernel G is held to on the
# card (tests/test_torch_cuda.py): square sums saturated to INT32_MAX, the
# padding's value (5 expanding stages on full-scale frames saturate about a
# third of the cells), all-equal windows, ranks 0 and >= nv - 1, windows cut
# by the active range, and w 2 and 64
SELECTION_EDGES = {
    "SQR saturated, high ranks": (
        GOSCA, dict(mag_mode=1, ref_window_size=16, guard_window_size=2,
                    index_lagg=15, index_lead=12), "full", 5),
    "SQR saturated, ranks 0 / 8, cut": (
        GOSCA, dict(mag_mode=1, ref_window_size=16, guard_window_size=4,
                    index_lagg=0, index_lead=8, cfar_fft_size=180),
        "full", 7),
    "all equal": (GOSCA, dict(ref_window_size=8, guard_window_size=2,
                              index_lagg=3, index_lead=7), "impulses", 0),
    "ranks 0 / w - 1, cut": (
        GOSCA, dict(ref_window_size=16, guard_window_size=3, index_lagg=0,
                    index_lead=15, cfar_fft_size=200), "random", 0),
    "w 2": (GOSCA, dict(ref_window_size=2, guard_window_size=1,
                        sub_window_size=1, index_lagg=1, index_lead=0,
                        peak_grouping=1),
            "random", 0),
    "w 64, cut": (GOSCA64, dict(ref_window_size=64, guard_window_size=8,
                                index_lagg=63, index_lead=40,
                                cfar_fft_size=230), "random", 0),
    "w 64, SQR saturated": (
        GOSCA64, dict(mag_mode=1, ref_window_size=64, guard_window_size=5,
                      index_lagg=50, index_lead=10), "full", 5),
}


@pytest.mark.parametrize("case", list(SELECTION_EDGES))
def test_chain_int_gos_reference_matches_the_jax_kernel_at_selection_edges(
        case):
    cfar, regs, frames, expanding = SELECTION_EDGES[case]
    if frames == "impulses":
        re, im = _impulses()
    else:
        re, im = _iq(11, frames=3, amp=32767 if frames == "full" else 30000)
    fft_j = R.FftConfig(max_size=N, expand_logic=tuple(
        int(s < expanding) for s in range(8)))
    rt_j, rt_t = _regs(**{"cfar_algorithm": 1, "threshold_scaler": 3.5,
                          "sub_window_size": 2, **regs})
    want = JK.fused_chain_int_gos(_pair_j(re, im), rt_j, fft_j, cfar,
                                  interpret=True)
    cfg_t = chain_config_from_reference(R.ChainConfig(fft=fft_j, cfar=cfar))
    got = TK.chain_int_gos(_pair_t(re, im), rt_t, cfg_t.fft, cfg_t.cfar)
    _assert_equal(got, want)
    if frames == "full":   # the point is ties with the padding's value
        mag = mag_int_op(fft_int_op(_pair_t(re, im), None, cfg_t.fft), 1)
        assert 0.2 < float((mag == INT_MAX).float().mean()) < 0.8


def test_integer_kernels_refuse_what_they_do_not_compute():
    cfg = chain_config_from_reference(R.ChainConfig(fft=R.FftConfig(
        max_size=N), cfar=GOSCA))
    x = _pair_t(*_iq(6, frames=1))
    rt = T.RuntimeConfig.make(fft_size=N, ref_window_size=8,
                              guard_window_size=2)
    with pytest.raises(ValueError, match="magnitude modes 0-2"):
        TK.chain_int(x, rt.merge_regs(mag_mode=3), cfg.fft, cfg.cfar)
    with pytest.raises(ValueError, match="no CASH"):
        TK.chain_int_gos(x, rt.merge_regs(cfar_mode=3), cfg.fft, cfg.cfar)
    with pytest.raises(ValueError, match="power of two"):
        TK.chain_int(_pair_t(*_iq(6, frames=1, n=128)), rt,
                     T.FftConfig(max_size=128), cfg.cfar)
