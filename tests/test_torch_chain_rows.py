"""The row plans of Kernels A (``chain_ca``), E (``wire_ca``), I (``pc_ca``)
and F (``chain_int``) on the CPU, through numpy emulations of the kernels' index
plans
(``csrc/row_fft.cuh``, ``csrc/int_rows.cuh``): which cells each thread holds
in each pass, the butterflies or DFTs it runs on them, the twiddle it reads,
where each bin's magnitude lands in the padded row, and the run-sum tail.

* F: an int64 emulation of the integer pass plan, every sum, difference and
  product wrapped to int32 as the kernel's ``uint32_t`` arithmetic wraps, is
  bit-equal to the port's ``ops.bit_true.fft_int_op`` and to the JAX
  ``fft_int_op`` (no expanding stage, the first stages expanding, keepLSB
  stages, both, and full-scale inputs through seven expanding stages, whose
  square sums saturate); the run sums equal the direct wrapping sums for
  every window, guard and active length; the emulated chain equals
  ``chain_int_reference`` and the JAX integer ops.
* A: the kernel's bin of each cell (``rsp_row_bin``) is ``row_order``, and
  the natural-order scatter inverts it; the emulated forward plan, scattered,
  with the magnitude and the run-sum tail, is within 1e-5 relative Δthr of
  ``chain_ca_reference`` and of the JAX ``fused_chain_ca_op`` (Pallas in
  interpret mode), peaks equal.
* I: the same plan at N = 256 ... 4096 (pass 3 of radix 8 at 2048 and 16 at
  4096), the spectrum times H in ``row_order`` (``kernels/chain.py
  _permuted``), within 1e-5 relative Δthr of ``pc_ca_reference`` and of the
  JAX ``fused_chain_ca(h_block=...)`` (interpret mode), peaks equal.
* E: the same plan with words in and words out: pass 1 unpacks each word
  (real part in bits [31:16], imaginary in [15:0], sign-extended), the tail
  packs each run's thresholds, natural bins and peaks (``RspWireStore``);
  at N = 256, 512 and 1024 the emulation is within the JAX bench's wire bar
  of ``wire_ca_reference`` and of the JAX ``fused_chain_ca_packed``
  (interpret mode), bins and peaks equal.
* The shared-memory plan: the exchanges between passes are free of bank
  conflicts, and the magnitude scatter of A, I and F at most 2-way (none at
  N = 256).

Inputs are seeded numpy arrays."""

import numpy as np
import pytest
import torch

import functools

import jax

import rsp_chains_tpu as R
import jax.numpy as jnp

from rsp_chains_tpu import packing as JP
from rsp_chains_tpu.kernels.chain_pallas import (
    fused_chain_ca, fused_chain_ca_op, fused_chain_ca_packed,
)
from rsp_chains_tpu.kernels.rd_pallas import _h_block
from rsp_chains_tpu.ops import bit_true as JB

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.convert import runtime_from_reference
from rsp_chains_tpu_torch.kernels import cfar as kcfar
from rsp_chains_tpu_torch.kernels import chain as kchain
from rsp_chains_tpu_torch.kernels import int_chain as kint
from rsp_chains_tpu_torch.ops import bit_true as TB
from rsp_chains_tpu_torch.ops.fft import fft_scale
from rsp_chains_tpu_torch.ops.matched_filter import h_planes
from test_torch_wire import _assert_wire_bar

SIZES = list(kchain.PC_SIZES)            # the row plan: A, H and I; I all
INT_SIZES = list(kint.ROW_SIZES)         # F's row plan
PAD = kcfar.PAD
CPU = torch.device("cpu")


def _plan(n):
    """(threads a row T, the stride of pass 2 M2)."""
    return n // 16, n // 256


def _brev(v, bits):
    return int(format(int(v), f"0{bits}b")[::-1], 2)


# ---- the integer plan (Kernel F) ----

def _w32(v):
    """int64 -> the int32 it wraps to."""
    return ((v + 2**31) & 0xFFFFFFFF) - 2**31


def _wrap16(v):
    lo = v & 0xFFFF
    return np.where(lo >= 32768, lo - 65536, lo)


def _rhu15_dot(a, b, wa, wb, wide):
    """``rsp_rhu15_dot``: rhu(a wa + b wb, 15), in the 8-bit split form once
    the data has grown."""
    if not wide:
        return _w32(_w32(_w32(a * wa) + _w32(b * wb)) + (1 << 14)) >> 15
    al, bl = a & 255, b & 255
    ah, bh = _w32(a - al) >> 8, _w32(b - bl) >> 8
    h = _w32(_w32(ah * wa) + _w32(bh * wb))
    t = _w32(_w32(_w32(al * wa) + _w32(bl * wb)) + (1 << 14))
    return _w32(h + (t >> 8)) >> 7


def _butterfly(ar, ai, br, bi, wr, wi, expanding, lsb, grown):
    """``rsp_int_butterfly``."""
    s = [_w32(ar + br), _w32(ai + bi), _w32(ar - br), _w32(ai - bi)]
    if lsb:
        s = [_wrap16(v) for v in s]
    elif not expanding:
        s = [_w32(v + 1) >> 1 for v in s]
    sr, si, dr, di = s
    y = [_rhu15_dot(sr, si, 32768, 0, grown),
         _rhu15_dot(sr, si, 0, 32768, grown),
         _rhu15_dot(dr, di, wr, _w32(-wi), grown),
         _rhu15_dot(dr, di, wi, wr, grown)]
    return [_wrap16(v) for v in y] if lsb else y


def _int_rows_fft(re, im, n, expand_mask, lsb_mask):
    """The integer pass plan over frames [F, n] (int64 holding int32):
    natural-order bins out."""
    t, m2 = _plan(n)
    tw = kint._int_twiddles(n, CPU).numpy().astype(np.int64)
    x = [re.astype(np.int64).copy(), im.astype(np.int64).copy()]
    grown = False
    m = np.arange(t)

    def run(base, stride, s0, stages):
        nonlocal grown
        cells = base[:, None] + stride * np.arange(16)       # [T, 16]
        assert np.array_equal(np.sort(cells.ravel()), np.arange(n))
        xr, xi = x[0][:, cells], x[1][:, cells]               # [F, T, 16]
        for l in range(stages):
            hs = (1 << (stages - 1)) >> l
            half, s = hs * stride, s0 + l
            expanding = bool(expand_mask >> s & 1)
            lsb = not expanding and bool(lsb_mask >> s & 1)
            grown = grown or expanding
            for k in range(16):
                if k & hs:
                    continue
                w = tw[half + ((base + stride * k) & (half - 1))]  # [T, 2]
                xr[..., k], xi[..., k], xr[..., k + hs], xi[..., k + hs] = (
                    _butterfly(xr[..., k], xi[..., k], xr[..., k + hs],
                               xi[..., k + hs], w[:, 0], w[:, 1], expanding,
                               lsb, grown))
        x[0][:, cells], x[1][:, cells] = xr, xi

    run(m, t, 0, 4)
    run(t * (m // m2) + m % m2, m2, 4, 4)
    if m2 > 1:
        run(16 * m, 1, 8, m2.bit_length() - 1)
    # the cells end bit-reversed: bin b at cell brev(b)
    rev = np.array([_brev(b, n.bit_length() - 1) for b in range(n)])
    return x[0][:, rev], x[1][:, rev]


def _masks(n, expand=(), lsb=()):
    p = n.bit_length() - 1
    el = tuple(int(s in expand) for s in range(p))
    km = tuple(int(s not in lsb) for s in range(p))
    return el, km


INT_FFTS = {
    "none": (dict(), 30000),
    "first stages expanding": (dict(expand=(0, 1, 2, 3)), 30000),
    "keepLSB stages": (dict(lsb=(1, 4, 8)), 30000),
    "expanding and keepLSB": (dict(expand=(1, 5, 8), lsb=(0, 2, 9)), 30000),
    "full scale, seven expanding": (dict(expand=tuple(range(7))), 32767),
}


def _int_frames(n, seed, amp, frames=3):
    rng = np.random.RandomState(seed)
    return (rng.randint(-amp, amp + 1, (frames, n)).astype(np.int32),
            rng.randint(-amp, amp + 1, (frames, n)).astype(np.int32))


@pytest.mark.parametrize("n", INT_SIZES)
@pytest.mark.parametrize("case", list(INT_FFTS))
def test_the_integer_pass_plan_is_bit_equal_to_fft_int_op(n, case):
    masks, amp = INT_FFTS[case]
    el, km = _masks(n, **masks)
    re, im = _int_frames(n, n + len(case), amp)
    fft_t = T.FftConfig(max_size=n, expand_logic=el, keep_msb_or_lsb=km)
    expand, lsb = kint.fft_masks(fft_t, n)
    got_re, got_im = _int_rows_fft(re, im, n, expand, lsb)
    want = TB.fft_int_op(T.C(torch.from_numpy(re), torch.from_numpy(im)),
                         None, fft_t)
    np.testing.assert_array_equal(got_re, want.re.numpy())
    np.testing.assert_array_equal(got_im, want.im.numpy())
    want_j = JB.fft_int_op(R.as_pair(re + 1j * im), None, R.FftConfig(
        max_size=n, expand_logic=el, keep_msb_or_lsb=km))
    np.testing.assert_array_equal(got_re, np.asarray(want_j.re))
    np.testing.assert_array_equal(got_im, np.asarray(want_j.im))
    if case == "full scale, seven expanding":
        sq = _w32(got_re * got_re + got_im * got_im)
        assert (sq < 0).mean() > 0.2   # the square sums saturate


# ---- the run-sum tail (Kernels A and F) ----

def _run_sums(rw, a, w, c):
    """``rsp_run_sums``' one side: the sums of rw[a + k .. a + k + w - 1] for
    k < c, rw the padded row (index PAD + cell), a [..., runs] window starts
    of each run; adds in the kernel's order, in rw's dtype (uint32 wraps)."""
    def at(i):
        return np.take_along_axis(rw, PAD + i, axis=-1)

    zero = np.zeros(a.shape, rw.dtype)
    mid = zero.copy()
    for t in range(c - 1, w):
        mid = mid + at(a + t)
    out = [None] * c
    out[c - 1] = mid
    edge = zero.copy()
    for k in range(c - 2, -1, -1):
        edge = edge + at(a + k)
        out[k] = edge + mid
    edge = zero.copy()
    for k in range(1, c):
        edge = edge + at(a + w + k - 1)
        out[k] = out[k] + edge
    return np.stack(out, axis=-1)        # [..., runs, c]


def _side_sums(mag, n_cells, w, g):
    """(lag, lead) of every cell by runs of 16 cells, c = min(w, 16) windows
    at a time, as ``rsp_ca_runs`` / ``rsp_int_ca_runs`` take them; mag the
    padded row [..., PAD + n + PAD]."""
    c = min(w, 16)
    i0 = np.arange(0, n_cells, 16)
    lag, lead = [], []
    for c0 in range(0, 16, c):
        a = np.broadcast_to(i0 + c0 - g - w, mag.shape[:-1] + i0.shape)
        b = np.broadcast_to(i0 + c0 + g + 1, mag.shape[:-1] + i0.shape)
        lag.append(_run_sums(mag, a, w, c))
        lead.append(_run_sums(mag, b, w, c))
    shape = mag.shape[:-1] + (n_cells,)
    return (np.concatenate(lag, -1).reshape(shape),
            np.concatenate(lead, -1).reshape(shape))


@pytest.mark.parametrize("w", [1, 2, 4, 8, 16, 32, 64])
@pytest.mark.parametrize("g", range(9))
def test_the_integer_run_sums_equal_the_direct_wrapping_sums(w, g):
    n = 256
    rng = np.random.RandomState(w * 16 + g)
    mag = rng.randint(0, 2**31 - 1, (4, n), dtype=np.int64)
    mag[:, ::7] = 2**31 - 1                # saturated square sums
    for n_active in (n, 200, 37, 9):       # 200 and 37 end inside a run
        row = np.zeros((4, PAD + n + PAD), np.int64)
        row[:, PAD:PAD + n_active] = mag[:, :n_active]
        lag, lead = _side_sums(row.astype(np.uint32), n, w, g)
        i = np.arange(n)
        for got, lo in ((lag, i - g - w), (lead, i + g + 1)):
            direct = sum(row[:, PAD + lo + k] for k in range(w))
            np.testing.assert_array_equal(
                got.astype(np.int64), direct & 0xFFFFFFFF)


def _int_tail(mag, r):
    """``rsp_int_ca_runs`` over frames [F, n] of magnitudes (int64 holding
    int32) with the register struct ``r``: (threshold int32, peaks)."""
    n = mag.shape[-1]
    hi, w = r.n_active, 1 << r.log2w
    row = np.zeros(mag.shape[:-1] + (PAD + n + PAD,), np.int64)
    row[:, PAD:PAD + n] = np.where(np.arange(n) < hi, mag, 0)
    lag, lead = _side_sums(row.astype(np.uint32), n, w, r.guard)
    s_lag = lag.astype(np.int32).astype(np.int64) >> r.div_sum
    s_lead = lead.astype(np.int32).astype(np.int64) >> r.div_sum
    return _int_thr_peaks(row, s_lag, s_lead, r)


def _int_thr_peaks(row, s_lag, s_lead, r):
    """``rsp_int_thr_peak`` over frames of the padded magnitude rows ``row``
    [F, PAD + n + PAD] (int64 holding int32) from the side statistics
    ``s_lag``, ``s_lead`` [F, n]: the mode, the wrapping threshold, peak
    grouping, zeros at and beyond n_active."""
    n = s_lag.shape[-1]
    hi = r.n_active
    noise = (np.maximum(s_lag, s_lead) if r.cfar_mode == 1
             else np.minimum(s_lag, s_lead) if r.cfar_mode == 2
             else _w32(s_lag + s_lead) >> 1)
    thr = (_w32(_w32(noise * r.scaler_q) + 32) >> 6 if r.log_or_linear == 1
           else _w32(noise + r.scaler_add))
    m = row[:, PAD:PAD + n]
    pk = m > thr
    if r.peak_grouping == 1:
        i = np.arange(n)
        left = np.where(i >= 1, row[:, PAD - 1:PAD + n - 1], TB.PEAK_EDGE)
        right = np.where(i + 1 < hi, row[:, PAD + 1:PAD + n + 1], TB.PEAK_EDGE)
        pk &= (m >= left) & (m >= right)
    active = np.arange(n) < hi
    return np.where(active, thr, 0).astype(np.int32), pk & active


INT_CHAIN_REGS = [
    dict(),
    dict(mag_mode=0, cfar_mode=1, peak_grouping=1, ref_window_size=64,
         guard_window_size=8, div_sum=6, cfar_fft_size=200),
    dict(mag_mode=1, cfar_mode=2, div_sum=0, threshold_scaler=64.0,
         log_or_linear=0),
]


@pytest.mark.parametrize("n", INT_SIZES)
@pytest.mark.parametrize("regs", INT_CHAIN_REGS)
def test_the_emulated_integer_chain_equals_chain_int_reference(n, regs):
    el, km = _masks(n, expand=(0, 1))
    re, im = _int_frames(n, n + 7, 32767)
    fft_t = T.FftConfig(max_size=n, expand_logic=el, keep_msb_or_lsb=km)
    cfar_j = R.CfarConfig(max_ref_window=64, variant=R.CfarVariant.CA,
                          include_cash=False, max_fft_size=n)
    rt_j = R.RuntimeConfig.make(**{"fft_size": n, **regs})
    rt = runtime_from_reference(rt_j.peek())
    cfar_t = T.CfarConfig(max_ref_window=64, variant=T.CfarVariant.CA,
                          include_cash=False, max_fft_size=n)
    r = kint.int_registers(rt, cfar_t, n)
    sr, si = _int_rows_fft(re, im, n, *kint.fft_masks(fft_t, n))
    mag = TB.mag_int_op(T.C(torch.from_numpy(sr.astype(np.int32)),
                            torch.from_numpy(si.astype(np.int32))),
                        rt.mag_mode).numpy().astype(np.int64)
    thr, pk = _int_tail(mag, r)
    x = T.C(torch.from_numpy(re), torch.from_numpy(im))
    want = kint.chain_int_reference(x, rt, fft_t, cfar_t)
    np.testing.assert_array_equal(thr, want.threshold.numpy())
    np.testing.assert_array_equal(pk, want.peaks.numpy())
    fft_j = R.FftConfig(max_size=n, expand_logic=el, keep_msb_or_lsb=km)
    spec_j = JB.fft_int_op(R.as_pair(re + 1j * im), None, fft_j)
    want_j = JB.ca_cfar_int(JB.mag_int_op(spec_j, rt_j.mag_mode), rt_j, cfar_j)
    np.testing.assert_array_equal(thr, np.asarray(want_j.threshold))
    np.testing.assert_array_equal(pk, np.asarray(want_j.peaks))


# ---- the float plan (Kernel A) ----

def _row_bin(n):
    """``rsp_row_bin``: cell d1 T + d2 M2 + d3 holds bin d1 + 16 d2 + 256 d3."""
    t, m2 = _plan(n)
    p = np.arange(n)
    return p // t + 16 * (p % t // m2) + 256 * (p % m2)


@pytest.mark.parametrize("n", SIZES)
def test_the_kernels_bin_of_each_cell_is_row_order_and_the_scatter_inverts_it(
        n):
    order = kchain.row_order(n)
    np.testing.assert_array_equal(_row_bin(n), order)
    scatter = np.empty(n, np.int64)
    scatter[order] = np.arange(n)            # natural bin -> its cell
    np.testing.assert_array_equal(order[scatter], np.arange(n))
    np.testing.assert_array_equal(scatter[order], np.arange(n))
    spec = np.random.RandomState(n).randn(n)
    nat = np.empty(n)
    nat[order] = spec[np.arange(n)]          # the kernel's store, cell p
    np.testing.assert_array_equal(nat[order], spec)


def _forward(x, n):
    """The forward passes of ``rsp_row_forward`` over rows [..., n] with the
    float32 pass tables: natural order in, cell p = bin row_order[p] out."""
    t, m2 = _plan(n)
    tw = kchain.row_twiddles(n).astype(np.float64)
    w = tw[:, 0] + 1j * tw[:, 1]
    y = x.reshape(*x.shape[:-1], 16, t)                     # cell m + t r
    y = np.fft.fft(y, axis=-2) * w[:n].reshape(16, t)
    y = y.reshape(*x.shape[:-1], 16, 16, m2)                # t k1 + m2 r + j
    y = np.fft.fft(y, axis=-2) * w[n:].reshape(16, m2)
    y = np.fft.fft(y.reshape(*x.shape[:-1], n // m2, m2), axis=-1)
    return y.reshape(x.shape).astype(np.complex64)


def _magnitude(re, im, mode):
    """``rsp_magnitude`` in float32."""
    if mode == 0:
        return np.sqrt(re * re + im * im)
    if mode == 1:
        return re * re + im * im
    ar, ai = np.abs(re), np.abs(im)
    u, v = np.maximum(ar, ai), np.minimum(ar, ai)
    jpl = np.maximum(u + v * np.float32(0.125),
                     u * np.float32(0.875) + v * np.float32(0.5))
    return jpl if mode == 2 else np.log2(np.maximum(jpl, np.float32(1e-30)))


def _chain_ca(x, n, r, scale, h_cells=None):
    """Kernel A's plan: the forward passes, the magnitude of each cell,
    scattered to its natural bin (``rsp_row_bin``), and the run-sum tail;
    Kernel I's with ``h_cells``, H's [2, n] planes in the cells' order, which
    multiply each scaled cell before its magnitude."""
    row = _mag_row(x, n, r, scale, h_cells)
    lag, lead = _side_sums(row, n, 1 << r.log2w, r.guard)
    inv = np.float32(2.0 ** -r.div_sum)
    return _thr_peaks(row, _combine(r.cfar_mode, lag * inv, lead * inv), r)


def _mag_row(x, n, r, scale, h_cells=None):
    """The front of Kernels A, D and I: the forward passes, the magnitude of
    each cell (after H's product with ``h_cells``), scattered to its natural
    bin (``rsp_row_bin``) of the padded rows [F, PAD + n + PAD], zero
    outside the active range."""
    spec = _forward(x, n) * np.float32(scale)
    sr, si = spec.real, spec.imag
    if h_cells is not None:
        hr, hi = h_cells
        sr, si = sr * hr - si * hi, sr * hi + si * hr
    mag_cells = _magnitude(sr, si, r.mag_mode).astype(np.float32)
    k = _row_bin(n)
    active = (k >= r.active_lo) & (k < r.active_hi)
    row = np.zeros(x.shape[:-1] + (PAD + n + PAD,), np.float32)
    row[:, PAD + k] = np.where(active, mag_cells, np.float32(0))
    return row


def _combine(mode, s_lag, s_lead):
    """``rsp_combine``: GO, SO, or the mean."""
    return (np.maximum(s_lag, s_lead) if mode == 1
            else np.minimum(s_lag, s_lead) if mode == 2
            else np.float32(0.5) * (s_lag + s_lead))


def _thr_peaks(row, noise, r):
    """The float tails' thresholds and peaks over frames of the padded
    magnitude rows ``row`` [F, PAD + n + PAD] from each cell's ``noise``
    [F, n]: the scaler, peak grouping, zeros outside the active range."""
    n = noise.shape[-1]
    scaler = np.float32(r.scaler)
    thr = noise * scaler if r.log_or_linear == 1 else noise + scaler
    i = np.arange(n)
    m = row[:, PAD:PAD + n]
    pk = m > thr
    if r.peak_grouping == 1:
        left = np.where(i - 1 >= r.active_lo, row[:, PAD - 1:PAD + n - 1],
                        -np.inf)
        right = np.where(i + 1 < r.active_hi, row[:, PAD + 1:PAD + n + 1],
                         -np.inf)
        pk &= (m >= left) & (m >= right)
    on = (i >= r.active_lo) & (i < r.active_hi)
    return np.where(on, thr, np.float32(0)), pk & on


CA_REGS = [
    dict(),
    dict(cfar_mode=1, peak_grouping=1, ref_window_size=16,
         guard_window_size=2, div_sum=4, mag_mode=0),
    dict(cfar_mode=2, mag_mode=3, log_or_linear=0, threshold_scaler=2.0,
         cfar_fft_size=200, ref_window_size=2, guard_window_size=1,
         div_sum=1),
]


@pytest.mark.parametrize("n", kchain.FUSABLE_SIZES)
@pytest.mark.parametrize("regs", CA_REGS)
def test_the_emulated_float_chain_matches_chain_ca_and_jax(n, regs):
    rng = np.random.RandomState(n + len(regs))
    x = ((rng.randn(3, n) + 1j * rng.randn(3, n)) * 50).astype(np.complex64)
    x[:, 40] += 4000 + 100j
    rt_j = R.RuntimeConfig.make(**{"fft_size": n, **regs})
    rt = runtime_from_reference(rt_j.peek())
    cfg_t = T.ChainConfig(fft=T.FftConfig(max_size=n), cfar=T.CfarConfig(
        max_ref_window=64, variant=T.CfarVariant.CA, include_cash=False,
        max_fft_size=n))
    r = kcfar.ca_registers(rt, cfg_t.cfar, n)
    thr, pk = _chain_ca(x, n, r, fft_scale(n, cfg_t.fft))
    want = kchain.chain_ca_reference(T.as_pair(x), rt, cfg_t.fft, cfg_t.cfar)
    scale = np.abs(want.threshold.numpy()).max()
    assert np.abs(thr - want.threshold.numpy()).max() / scale < 1e-5
    np.testing.assert_array_equal(pk, want.peaks.numpy())
    cfg_j = R.ChainConfig(fft=R.FftConfig(max_size=n), cfar=R.CfarConfig(
        max_ref_window=64, variant=R.CfarVariant.CA, include_cash=False,
        max_fft_size=n))
    want_j = fused_chain_ca_op(R.as_pair(x), rt_j, cfg_j.fft, cfg_j.cfar,
                               interpret=True)
    thr_j = np.asarray(want_j.threshold)
    assert np.abs(thr - thr_j).max() / np.abs(thr_j).max() < 1e-5
    np.testing.assert_array_equal(pk, np.asarray(want_j.peaks))


PC_TAPS = R.golden.lfm_chirp(48, 0.0, 0.25)


@functools.lru_cache(maxsize=None)
def _jax_h_block(n):
    """The JAX ``fused_chain_ca(h_block=...)`` at N = n, jitted once (the
    registers are traced)."""
    cfg = R.ChainConfig(
        fft=R.FftConfig(max_size=n),
        matched_filter=R.MatchedFilterConfig(num_taps=len(PC_TAPS),
                                             fft_size=n),
        cfar=R.CfarConfig(max_ref_window=64, variant=R.CfarVariant.CA,
                          include_cash=False, max_fft_size=n))
    hb = _h_block(PC_TAPS, n, True)
    return jax.jit(lambda x, rt: fused_chain_ca(
        x, rt, cfg.fft, cfg.cfar, interpret=True, h_block=hb))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("regs", CA_REGS)
def test_the_emulated_pulse_compression_rows_match_pc_ca_and_jax(n, regs):
    """Kernel I's plan: H permuted into ``row_order`` by the wrapper's
    ``_permuted``, each thread's 16 cells times H before the magnitude.
    Bar 1e-4 relative Δthr, the bench's: the chirp's H is band-limited, so
    some bins of the product lie ~1e-3 below the largest, and their LOG2
    magnitude carries the FFTs' ~1e-7 relative difference a thousandfold."""
    rng = np.random.RandomState(n + 3 * len(regs))
    x = ((rng.randn(2, n) + 1j * rng.randn(2, n)) * 0.5).astype(np.complex64)
    x[:, 30:30 + len(PC_TAPS)] += 3 * PC_TAPS
    rt_j = R.RuntimeConfig.make(**{"fft_size": n, **regs})
    rt = runtime_from_reference(rt_j.peek())
    cfg_t = T.ChainConfig(fft=T.FftConfig(max_size=n), cfar=T.CfarConfig(
        max_ref_window=64, variant=T.CfarVariant.CA, include_cash=False,
        max_fft_size=n))
    h = h_planes(PC_TAPS, n, True, CPU)
    h_cells = kchain._permuted(h)
    assert kchain._permuted(h) is h_cells       # once per H tensor
    np.testing.assert_array_equal(h_cells.numpy(),
                                  h.numpy()[:, kchain.row_order(n)])
    r = kcfar.ca_registers(rt, cfg_t.cfar, n)
    thr, pk = _chain_ca(x, n, r, fft_scale(n, cfg_t.fft), h_cells.numpy())
    want = kchain.pc_ca_reference(T.as_pair(x), rt, cfg_t.fft, cfg_t.cfar, h)
    scale = np.abs(want.threshold.numpy()).max()
    assert np.abs(thr - want.threshold.numpy()).max() / scale < 1e-4
    np.testing.assert_array_equal(pk, want.peaks.numpy())
    want_j = _jax_h_block(n)(R.as_pair(x), rt_j)
    thr_j = np.asarray(want_j.threshold)
    assert np.abs(thr - thr_j).max() / np.abs(thr_j).max() < 1e-4
    np.testing.assert_array_equal(pk, np.asarray(want_j.peaks))


# ---- the wire plan (Kernel E) ----

def _unpack(words):
    """Pass 1's load of ``rsp_wire_ca_rows_kernel``: the real part in bits
    [31:16] and the imaginary part in [15:0] of each word, sign-extended."""
    u = words.astype(np.uint32)
    re = (u >> 16).astype(np.uint16).view(np.int16)
    im = (u & 0xFFFF).astype(np.uint16).view(np.int16)
    return re.astype(np.float32), im.astype(np.float32)


def _wire_store(thr, pk, n):
    """``RspWireStore`` run by run (cells i0 .. i0 + 15 of thread i0 / 16):
    the float32 threshold clipped to [0, 2^(31 - log2n) - 1] and truncated,
    in bits [31:log2n+1]; the cell's natural bin in [log2n:1]; the peak in
    bit 0."""
    log2n = n.bit_length() - 1
    out = np.empty(thr.shape, np.uint32)
    top = np.float32((1 << (31 - log2n)) - 1)
    for i0 in range(0, n, 16):
        t = np.minimum(np.maximum(thr[:, i0:i0 + 16], np.float32(0)), top)
        cells = np.arange(i0, i0 + 16, dtype=np.uint32)
        out[:, i0:i0 + 16] = ((t.astype(np.uint32) << (log2n + 1))
                              | (cells << 1) | pk[:, i0:i0 + 16])
    return out


WIRE_REGS = [
    dict(),
    dict(cfar_mode=1, peak_grouping=1, ref_window_size=16,
         guard_window_size=2, div_sum=4, cfar_fft_size=200),
]


@pytest.mark.parametrize("n", kchain.FUSABLE_SIZES)
@pytest.mark.parametrize("regs", WIRE_REGS)
def test_the_emulated_wire_rows_match_wire_ca_reference_and_jax(n, regs):
    """Kernel E's plan: words unpacked in pass 1's load, A's forward plan,
    scatter and run-sum tail, the runs packed into words. At the JAX bench's
    wire bar against ``wire_ca_reference`` and the JAX
    ``fused_chain_ca_packed`` (interpret mode): bins equal, the threshold
    field within 2 LSB and 0.05 LSB on average, no peak flip."""
    rng = np.random.RandomState(n + 11 * len(regs))
    x = (rng.randn(3, n) + 1j * rng.randn(3, n)) * 40
    x += 900 * np.exp(2j * np.pi * 0.21 * np.arange(n))
    q = (np.clip(np.round(x.real), -32767, 32767)
         + 1j * np.clip(np.round(x.imag), -32767, 32767)).astype(np.complex64)
    words = np.array(JP.pack_iq(jnp.asarray(q))).view(np.uint32)
    re, im = _unpack(words)
    np.testing.assert_array_equal(re + 1j * im, q)
    rt_j = R.RuntimeConfig.make(**{"fft_size": n, "ref_window_size": 32,
                                   "guard_window_size": 4, "div_sum": 5,
                                   "threshold_scaler": 3.5, **regs})
    rt = runtime_from_reference(rt_j.peek())
    cfg_t = T.ChainConfig(fft=T.FftConfig(max_size=n), cfar=T.CfarConfig(
        max_ref_window=64, variant=T.CfarVariant.CA, include_cash=False,
        max_fft_size=n))
    r = kcfar.ca_registers(rt, cfg_t.cfar, n)
    thr, pk = _chain_ca(re + 1j * im, n, r, fft_scale(n, cfg_t.fft))
    got = _wire_store(thr, pk, n)
    bw = n.bit_length() - 1
    np.testing.assert_array_equal((got >> 1) & (n - 1),
                                  np.broadcast_to(np.arange(n), got.shape))
    want = kchain.wire_ca_reference(torch.from_numpy(words.view(np.int32)),
                                    rt, cfg_t.fft, cfg_t.cfar)
    _assert_wire_bar(got, want.numpy().view(np.uint32), bw)
    cfar_j = R.CfarConfig(max_ref_window=64, variant=R.CfarVariant.CA,
                          include_cash=False, max_fft_size=n)
    want_j = fused_chain_ca_packed(jnp.asarray(words), rt_j,
                                   R.FftConfig(max_size=n), cfar_j,
                                   interpret=True)
    _assert_wire_bar(got, np.asarray(want_j).view(np.uint32), bw)
    for w in (want.numpy().view(np.uint32), np.asarray(want_j)):
        np.testing.assert_array_equal(w & 1, got & 1)
    assert (got & 1).any()


def test_the_row_routes_of_a_f_and_h_keep_their_sizes():
    """The row plan reaches N = 4096 for Kernel I; Kernels A's and H's gates
    and Kernel F's row route stay at 256 ... 1024, as the JAX package's."""
    assert kchain.FUSABLE_SIZES == (256, 512, 1024)
    assert kint.ROW_SIZES == (256, 512, 1024)
    from rsp_chains_tpu_torch.kernels import rd as krd
    assert krd.RD_SIZES == (256, 512, 1024)
    assert tuple(kchain.ROW_RADICES) == kchain.PC_SIZES
    for n, radices in kchain.ROW_RADICES.items():
        assert radices[:2] == (16, 16) and np.prod(radices) == n


# ---- the shared-memory plan ----

def _slot(p):
    return p ^ ((p >> 4) & 31)


def _mag_slot(i):
    return i + (i >> 4)


def _worst_conflict(n, address):
    """The most distinct 4-byte words of one bank that a warp's store of one
    slot k touches, over the block's eight warps and the 16 slots; thread
    t = q T + m, ``address(q, m, k)`` its word."""
    t = n // 16
    worst = 0
    for warp in range(8):
        for k in range(16):
            banks = {}
            for thread in range(32 * warp, 32 * warp + 32):
                a = address(*divmod(thread, t), k)
                banks.setdefault(a % 32, set()).add(a)
            worst = max(worst, max(len(v) for v in banks.values()))
    return worst


@pytest.mark.parametrize("n", SIZES)
def test_the_exchanges_are_conflict_free_and_the_scatters_at_most_two_way(n):
    t, m2 = _plan(n)
    ks = n + 16                                        # RspRowPlan::kS
    kmag = (n + 2 * PAD) // 16 * 17 + 16               # RspRowPlan::kMagS
    for cell in (lambda m, k: m + t * k,
                 lambda m, k: t * (m // m2) + m % m2 + m2 * k,
                 lambda m, k: 16 * m + k):
        assert _worst_conflict(
            n, lambda q, m, k: q * ks + _slot(cell(m, k))) == 1
    bins = {"A and I": kchain.row_order(n)}
    if n in INT_SIZES:
        bins["F"] = [_brev(p, n.bit_length() - 1) for p in range(n)]
    for name, b in bins.items():
        got = _worst_conflict(
            n, lambda q, m, k: q * kmag + _mag_slot(PAD + b[16 * m + k]))
        assert got == (1 if n == 256 else 2), (name, got)
