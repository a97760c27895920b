"""The host constants of Kernel H's range-row launch (``csrc/rd_front.cuh``)
on the CPU: the digit-reversal order ``row_order`` and the pass twiddles
``row_twiddles`` of ``kernels/chain.py`` (the row plan, ``csrc/row_fft.cuh``)
and the permuted H ``h_rows`` of ``kernels/rd.py``, through
a numpy emulation of the kernel's pass plan (each radix-16 / radix-2 / radix-4
pass on the cells it reads, the twiddle table applied after it; the inverse
as each pass's adjoint in reverse order).

Same seeded numpy inputs through the emulation, ``np.fft`` and the port's
plain matched filter, which the JAX package's own matched filter matches
(tests/test_torch_rd.py). Bars: the forward plan against ``np.fft.fft`` in
``row_order`` within 1e-5 of the spectrum's largest value (the tables are
float32-rounded, ~1e-7); the whole row against ``matched_filter`` and the JAX
``matched_filter`` within 1e-5 of the row's largest value."""

import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.ops.matched_filter import matched_filter as mf_jax

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.kernels import chain as kchain
from rsp_chains_tpu_torch.kernels import rd as krd
from rsp_chains_tpu_torch.ops.matched_filter import matched_filter

SIZES = [256, 512, 1024]


def _tables(n):
    tw = kchain.row_twiddles(n).astype(np.float64)
    w = tw[:, 0] + 1j * tw[:, 1]
    t, m2 = n // 16, n // 256
    return w[:n].reshape(16, t), w[n:].reshape(16, m2)


def _forward(x, n):
    """The row launch's forward passes over rows ``x`` [..., n], natural
    order in, ``row_order`` out."""
    t, m2 = n // 16, n // 256
    w1, w2 = _tables(n)
    y = x.reshape(*x.shape[:-1], 16, t)            # [r, m]: cell m + t r
    y = np.fft.fft(y, axis=-2) * w1                # [k, m] -> cell m + t k
    y = y.reshape(*x.shape[:-1], 16, 16, m2)       # [k1, r, j]: t k1 + m2 r + j
    y = np.fft.fft(y, axis=-2) * w2
    y = y.reshape(*x.shape[:-1], n // m2, m2)      # contiguous groups of m2
    return np.fft.fft(y, axis=-1).reshape(x.shape)


def _inverse(z, n):
    """The adjoints of ``_forward``'s passes in reverse order (conjugate
    DFTs and twiddles): ``row_order`` in, natural order out, times n."""
    t, m2 = n // 16, n // 256
    w1, w2 = _tables(n)
    y = z.reshape(*z.shape[:-1], n // m2, m2)
    y = np.conj(np.fft.fft(np.conj(y), axis=-1))
    y = y.reshape(*z.shape[:-1], 16, 16, m2) * np.conj(w2)
    y = np.conj(np.fft.fft(np.conj(y), axis=-2))
    y = y.reshape(*z.shape[:-1], 16, t) * np.conj(w1)
    y = np.conj(np.fft.fft(np.conj(y), axis=-2))
    return y.reshape(z.shape)


def _rows(n, seed=0, frames=3):
    rng = np.random.RandomState(seed)
    return rng.randn(frames, n) + 1j * rng.randn(frames, n)


@pytest.mark.parametrize("n", SIZES)
def test_row_order_is_a_permutation_of_the_bins(n):
    order = kchain.row_order(n)
    assert order.shape == (n,)
    np.testing.assert_array_equal(np.sort(order), np.arange(n))
    # cell p = d1 (n / R1) + d2 (n / R1 R2) + ... holds bin d1 + R1 d2 + ...
    want = np.zeros(n, np.int64)
    p, size, weight = np.arange(n), n, 1
    for r in kchain.ROW_RADICES[n]:
        size //= r
        want += weight * (p // size)
        p, weight = p % size, weight * r
    np.testing.assert_array_equal(order, want)


@pytest.mark.parametrize("n", SIZES)
def test_row_twiddles_are_the_passes_roots(n):
    tw = kchain.row_twiddles(n)
    t, m2 = n // 16, n // 256
    assert tw.dtype == np.float32 and tw.shape == (n + 16 * m2, 2)
    k, m = np.meshgrid(np.arange(16), np.arange(t), indexing="ij")
    want = np.exp(-2j * np.pi * k * m / n).ravel()
    np.testing.assert_allclose(tw[:n, 0], want.real, atol=6e-8)
    np.testing.assert_allclose(tw[:n, 1], want.imag, atol=6e-8)
    np.testing.assert_allclose(np.hypot(tw[:, 0], tw[:, 1]), 1.0, atol=2e-7)


@pytest.mark.parametrize("n", SIZES)
def test_the_pass_plan_is_the_fft_in_row_order(n):
    x = _rows(n, seed=n)
    got = _forward(x, n)
    want = np.fft.fft(x, axis=-1)[:, kchain.row_order(n)]
    assert np.abs(got - want).max() / np.abs(want).max() < 1e-5
    back = _inverse(got, n) / n
    assert np.abs(back - x).max() / np.abs(x).max() < 1e-5


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("normalize", [True, False])
def test_the_permuted_h_gives_the_matched_filter(n, normalize):
    taps = R.golden.lfm_chirp(128, 0.0, 0.25)
    x = _rows(n, seed=n + 1).astype(np.complex64)
    h = krd.h_rows(taps, n, normalize, torch.device("cpu")).numpy()
    got = _inverse(_forward(x, n) * (h[0] + 1j * h[1]), n) / n
    cfg_t = T.MatchedFilterConfig(num_taps=128, fft_size=n,
                                  normalize=normalize)
    want = matched_filter(T.as_pair(x), taps, cfg_t)
    want = want.re.numpy() + 1j * want.im.numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < 1e-5
    want_j = mf_jax(R.as_pair(x), taps, R.MatchedFilterConfig(
        num_taps=128, fft_size=n, normalize=normalize))
    want_j = np.asarray(want_j.re) + 1j * np.asarray(want_j.im)
    assert np.abs(got - want_j).max() / scale < 1e-5


def test_h_rows_is_cached_per_replica_size_and_device():
    taps = R.golden.lfm_chirp(64, 0.0, 0.25)
    cpu = torch.device("cpu")
    a = krd.h_rows(taps, 512, True, cpu)
    assert krd.h_rows(taps, 512, True, cpu) is a
    assert krd.h_rows(taps, 512, False, cpu) is not a
    assert a.shape == (2, 512) and a.is_contiguous()
