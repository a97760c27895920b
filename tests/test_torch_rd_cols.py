"""The two schedules of the range-Doppler launches that run down the map's
columns, emulated in numpy as they run on the card, on the CPU:

* the Doppler column plan of Kernels H and J (``csrc/rd_front.cuh``
  ``rsp_rd_doppler_kernel``, ``RspColPlan``): each thread's 16 pulses (8 at
  P = 8) of a range column, windowed on the load, pass for pass through the
  register DFTs, the table twiddles (``row_twiddles(P)``) and the shared
  memory transposes, each slot stored at its bin's (shifted) row, scaled;
  at P = 8 ... 512 against ``np.fft`` and the port's ``doppler_fft``;
* Kernel J's 2-D detector (``csrc/cfar_2d.cuh`` ``rsp_cfar2d_kernel``): the
  32 x 128 tiles, the chunks of 32 staged rows, the 16-cell range runs and
  16-row Doppler runs of ``rsp_window_runs`` in float32 and in the kernel's
  order of adds, the thresholds and the peak test on the staged ``own``
  ring; against the port's ``cfar_2d_op``, the JAX ``cfar_2d_op`` and
  ``cfar_2d_golden``, with the edge cases (a Doppler reach past P, g = 0,
  w = 1, an active range clipped on both sides, grouping at the map's edges
  and tile seams, tiles cut by the map's end). The layouts' bank claims and
  the shared-memory sizes are checked from the same slot functions.

Same seeded numpy inputs through the emulations and the references. Bars:
the Doppler plan within 1e-5 of the output's largest value (float32 tables
and sums, ~1e-7); the detector's thresholds within 1e-5 of the largest
threshold and no peak flipped."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.golden import cfar_2d_golden
from rsp_chains_tpu.ops.cfar_2d import cfar_2d_op as cfar_2d_jax

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.convert import (
    cfar2d_config_from_reference, cfar2d_runtime_from_reference,
)
from rsp_chains_tpu_torch.kernels import chain as kchain
from rsp_chains_tpu_torch.ops.doppler import doppler_fft, doppler_scale
from rsp_chains_tpu_torch.ops.windows import window as make_window

F32 = np.float32
CSRC = Path(T.__file__).parent / "csrc"


def _define(name: str) -> int:
    return int(re.search(rf"#define {name} (\d+)",
                         (CSRC / "cfar_2d.cuh").read_text()).group(1))


TD, TR, RB, RB1 = (_define(k) for k in ("RSP_C2D_TD", "RSP_C2D_TR",
                                        "RSP_C2D_RB", "RSP_C2D_RB1"))
SUMS, OWN, THREADS = TR + 1, TR + 2, 2 * TR
# the column plan's passes for each pulse count (RspColPlan): radix 16 (8 at
# P = 8) at stride P / 16, radix 16 at stride 2 (P = 512 only), the rest over
# contiguous groups
COL_RADICES = {8: (8,), 16: (16,), 32: (16, 2), 64: (16, 4), 128: (16, 8),
               256: (16, 16), 512: (16, 16, 2)}
PULSES = sorted(COL_RADICES)


# ---- the Doppler column plan ----

def _plan(p):
    """RspColPlan<p>: threads a column, pulses a thread, pass 2's stride,
    the last pass's radix."""
    t = max(p // 16, 1)
    m2 = t // 16 if t > 16 else 1
    return t, min(p, 16), m2, m2 if m2 > 1 else t


def _dft(slots):
    return list(np.fft.fft(np.stack(slots), axis=0).astype(np.complex64))


def _doppler_plan(x, win, fft_shift, scale):
    """rsp_rd_doppler_kernel over x [batch, P, n] complex64: thread m of a
    column holds pulses m + T j, the passes run on its slots, the transposes
    go through a [P] plane a column, slot j (cell 16 m + j) is stored at its
    bin's row."""
    p = x.shape[-2]
    t, ell, m2s, last = _plan(p)
    tw = kchain.row_twiddles(p)
    tw = (tw[:, 0] + 1j * tw[:, 1]).astype(np.complex64)
    xs = np.moveaxis(x, -2, 0)                     # [P, batch, n]
    plane = np.zeros_like(xs)
    regs = {}
    for m in range(t):
        v = _dft([xs[m + t * j] * F32(win[m + t * j]) for j in range(ell)])
        if t > 1:
            for k in range(1, 16):
                v[k] = v[k] * tw[m + k * t]
            for k in range(16):
                plane[m + t * k] = v[k]
        regs[m] = v
    if t > 1:
        if m2s > 1:
            nxt = plane.copy()
            for m in range(t):
                mm, b2 = m % m2s, t * (m // m2s) + m % m2s
                v = _dft([plane[b2 + m2s * k] for k in range(16)])
                for k in range(1, 16):
                    v[k] = v[k] * tw[p + mm + k * m2s]
                for k in range(16):
                    nxt[b2 + m2s * k] = v[k]
            plane = nxt
        for m in range(t):
            v = [plane[16 * m + k] for k in range(16)]
            regs[m] = sum((_dft(v[j:j + last]) for j in range(0, 16, last)),
                          [])
    out = np.empty_like(xs)
    half = p // 2 if fft_shift else 0
    for m in range(t):
        for j in range(ell):
            cell = (16 * m if t > 1 else 0) + j
            b = cell // t + 16 * (cell % t // m2s) + 256 * (cell % m2s)
            out[(b + half) & (p - 1)] = regs[m][j] * F32(scale)
    return np.moveaxis(out, 0, -2)


def _digit_order(n, radices):
    """The bin at each cell of a decimation in frequency in place over
    ``radices``: cell d1 (n / R1) + d2 (n / R1 R2) + ... holds bin
    d1 + R1 d2 + ..."""
    bins, p, size, weight = np.zeros(n, np.int64), np.arange(n), n, 1
    for r in radices:
        size //= r
        bins += weight * (p // size)
        p, weight = p % size, weight * r
    return bins


@pytest.mark.parametrize("p", PULSES)
def test_the_column_plan_stores_each_slot_at_its_bin(p):
    t, ell, m2s, last = _plan(p)
    cells = np.arange(p if t > 1 else ell)
    bins = cells // t + 16 * (cells % t // m2s) + 256 * (cells % m2s)
    np.testing.assert_array_equal(bins, _digit_order(p, COL_RADICES[p]))
    assert np.prod(COL_RADICES[p]) == p
    assert COL_RADICES[p] == ((ell,) + ((16,) if m2s > 1 else ())
                              + ((last,) if t > 1 else ()))
    assert t * ell == p and kchain.row_twiddles(p).shape[0] >= (
        p if t > 1 else 0)


@pytest.mark.parametrize("p", PULSES)
@pytest.mark.parametrize("window", ["hann", None])
@pytest.mark.parametrize("fft_shift", [True, False])
@pytest.mark.parametrize("scaling", [T.FftScaling.DIV_N,
                                     T.FftScaling.SQRT_N])
def test_the_doppler_column_plan_is_the_windowed_fft(p, window, fft_shift,
                                                     scaling):
    rng = np.random.RandomState(p)
    x = (rng.randn(2, p, 40) + 1j * rng.randn(2, p, 40)).astype(np.complex64)
    win = (make_window(window, p) if window is not None
           else np.ones(p, np.float32))
    scale = doppler_scale(p, scaling)
    got = _doppler_plan(x, win, fft_shift, scale)
    want = np.fft.fft(x.astype(np.complex128) * win[:, None], axis=-2) * scale
    if fft_shift:
        want = np.roll(want, p // 2, axis=-2)
    peak = np.abs(want).max()
    assert np.abs(got - want).max() / peak < 1e-5
    cfg = T.DopplerConfig(num_pulses=p, window=window, fft_shift=fft_shift,
                          scaling=scaling)
    port = doppler_fft(T.as_pair(x), cfg)
    port = port.re.numpy() + 1j * port.im.numpy()
    assert np.abs(got - port).max() / peak < 1e-5


# ---- the 2-D detector's run schedule ----

def _row_floats(a_r):
    return TR + 2 * a_r + 1


def _run_width(w):
    return 16 if w >= 16 else 8 if w >= 8 else 4 if w >= 4 else \
        2 if w >= 2 else 1


def _window_runs(x, b, w, lo=None, hi=None):
    """rsp_window_runs: the 16 sums of x(t) over [b + k, b + k + w), only t
    in [lo, hi) when given (kClip), C at a time, in the kernel's order of
    float32 adds."""
    clip = lo is not None
    c = _run_width(w)
    out = []
    for k0 in range(0, 16, c):
        bb = b + k0
        t0, t1 = bb + c - 1, bb + w
        if clip:
            t0, t1 = max(t0, lo), min(t1, hi)
        mid = F32(0)
        for t in range(t0, t1):
            mid = mid + x(t)
        v = [None] * c
        v[c - 1] = mid
        e = F32(0)
        for k in range(c - 2, -1, -1):
            if not clip or lo <= bb + k < hi:
                e = e + x(bb + k)
            v[k] = e + mid
        e = F32(0)
        for k in range(1, c):
            if not clip or lo <= bb + w - 1 + k < hi:
                e = e + x(bb + w - 1 + k)
            v[k] = v[k] + e
        out += v
    return out


def _at(plane, t):
    """Row t of a range-sum plane: a read outside the staged rows fails."""
    assert 0 <= t < plane.shape[0], t
    return plane[t]


def _interval(pos, a, lo, hi):
    return np.maximum(np.minimum(pos + a, hi - 1) - np.maximum(pos - a, lo)
                      + 1, 0).astype(F32)


def _cfar2d_kernel(mag, w_r, g_r, w_d, g_d, scaler, log_or_linear=1,
                   peak_grouping=0, active_lo=0, active_hi=None):
    """rsp_cfar2d_kernel over mag [batch, p, n] (float32, n a multiple of
    128) under clamped registers: (thr, peaks)."""
    batch, p, n = mag.shape
    lo, hi = active_lo, n if active_hi is None else active_hi
    a_r, a_d = g_r + w_r, g_d + w_d
    cols = TR + 2 * a_r
    thr = np.full(mag.shape, np.nan, F32)
    peaks = np.zeros(mag.shape, bool)
    for bi in range(batch):
        for d0 in range(0, p, TD):
            for r0 in range(0, n, TR):
                own = np.full((TD + 2, OWN), -np.inf, F32)
                acc = [[np.zeros(TR, F32) for _ in range(16)]
                       for _ in range(2)]
                # the one-chunk route stages the windows' rows whole, zero
                # rows outside the map; the chunked route RB rows at a time
                one = TD + 2 * a_d <= RB1
                s_lo, s_hi = d0 - a_d, d0 + TD - 1 + a_d
                if not one:
                    s_lo, s_hi = max(s_lo, 0), min(s_hi, p - 1)
                rows = s_hi - s_lo + 1 if one else RB
                g = r0 - a_r + np.arange(cols)
                act = (g >= lo) & (g < hi)
                oc = np.arange(cols) - a_r + 1
                ring = (oc >= 0) & (oc < OWN)
                for s0 in range(s_lo, s_hi + 1, rows):
                    nr = min(rows, s_hi - s0 + 1)
                    s = np.arange(s0, s0 + nr)
                    plane = np.where(
                        act & ((s >= 0) & (s < p))[:, None],
                        mag[bi][np.clip(s, 0, p - 1)][:, np.clip(g, 0, n - 1)],
                        F32(0))
                    for jj in range(nr):
                        if d0 - 1 <= s0 + jj <= d0 + TD:
                            own[s0 + jj - d0 + 1, oc[ring]] = np.where(
                                act, plane[jj], -np.inf)[ring]
                    s_out = np.zeros((nr, TR), F32)
                    s_in = np.zeros((nr, TR), F32)
                    for q in range(8):
                        col = lambda t: _at(plane.T, t)   # noqa: E731
                        vo = _window_runs(col, 16 * q, 2 * a_r + 1)
                        vi = _window_runs(col, 16 * q + a_r - g_r, 2 * g_r + 1)
                        for k in range(16):
                            s_out[:, 16 * q + k] = vo[k]
                            s_in[:, 16 * q + k] = vi[k]
                    for u in range(2):
                        dr = d0 + 16 * u
                        b = dr - s0
                        clip = (None, None) if one else (0, nr)
                        if dr < p and b - a_d < nr and b + 15 + a_d >= 0:
                            vo = _window_runs(lambda t: _at(s_out, t),
                                              b - a_d, 2 * a_d + 1, *clip)
                            vi = _window_runs(lambda t: _at(s_in, t),
                                              b - g_d, 2 * g_d + 1, *clip)
                            for k in range(16):
                                acc[u][k] = acc[u][k] + vo[k]
                            for k in range(16):
                                acc[u][k] = acc[u][k] - vi[k]
                rc = r0 + np.arange(TR)
                active = (rc >= lo) & (rc < hi)
                n_out, n_in = _interval(rc, a_r, lo, hi), _interval(rc, g_r,
                                                                   lo, hi)
                whole = (rc - a_r >= lo) & (rc + a_r < hi)
                for u in range(2):
                    for k in range(16):
                        d = d0 + 16 * u + k
                        if d >= p:
                            continue
                        co, ci = _interval(d, a_d, 0, p), _interval(d, g_d,
                                                                    0, p)
                        inv = F32(1) / np.maximum(
                            F32(2 * a_r + 1) * co - F32(2 * g_r + 1) * ci,
                            F32(1))
                        cnt = n_out * co - n_in * ci
                        noise = np.where(whole, acc[u][k] * inv,
                                         acc[u][k] / np.maximum(cnt, F32(1)))
                        t = (noise * F32(scaler) if log_or_linear == 1
                             else noise + F32(scaler))
                        m = own[d - d0 + 1, 1:TR + 1]
                        pk = m > t
                        if peak_grouping == 1:
                            for dd in (-1, 0, 1):
                                for dc in (-1, 0, 1):
                                    if dd or dc:
                                        pk &= m >= own[d - d0 + 1 + dd,
                                                       1 + dc:TR + 1 + dc]
                        thr[bi, d, r0:r0 + TR] = np.where(active, t, F32(0))
                        peaks[bi, d, r0:r0 + TR] = active & pk
    assert not np.isnan(thr).any()
    return thr, peaks


def _map(shape, seed, targets=()):
    rng = np.random.RandomState(seed)
    m = np.abs(rng.randn(*shape) + 1j * rng.randn(*shape)).astype(F32)
    for d, r, a in targets:
        m[..., d, r] = a
    return m


def _regs(ref_range=8, guard_range=2, ref_doppler=4, guard_doppler=1,
          threshold_scaler=2.5, **kw):
    return T.Cfar2dRuntime.make(
        ref_range=ref_range, guard_range=guard_range, ref_doppler=ref_doppler,
        guard_doppler=guard_doppler, threshold_scaler=threshold_scaler, **kw)


def _emulate(m, rt2, active_lo=0, active_hi=None):
    hi = min(rt2.active_range, m.shape[-1]) if active_hi is None \
        else active_hi
    return _cfar2d_kernel(m, rt2.ref_range, rt2.guard_range, rt2.ref_doppler,
                          rt2.guard_doppler, rt2.threshold_scaler,
                          rt2.log_or_linear, rt2.peak_grouping, active_lo, hi)


def _cfg(rt2):
    return T.Cfar2dConfig(max_ref_range=rt2.ref_range,
                          max_guard_range=rt2.guard_range,
                          max_ref_doppler=rt2.ref_doppler,
                          max_guard_doppler=rt2.guard_doppler)


def _assert_bar(thr, peaks, want_thr, want_peaks):
    want_thr, want_peaks = np.asarray(want_thr), np.asarray(want_peaks)
    scale = np.abs(want_thr).max()
    assert np.abs(thr - want_thr).max() / scale < 1e-5
    np.testing.assert_array_equal(peaks, want_peaks)


def _against_plain(m, rt2, **active):
    thr, pk = _emulate(m, rt2, **active)
    want = T.cfar_2d_op(torch.from_numpy(m), rt2, _cfg(rt2), **active)
    _assert_bar(thr, pk, want.threshold.numpy(), want.peaks.numpy())
    return thr, pk


# targets at the map's corners and edges and across the tile seams (rows
# 31 / 32, cells 127 / 128), some of them neighbours, so grouping decides
EDGE_TARGETS = [(0, 0, 40.0), (0, 255, 30.0), (63, 0, 35.0), (63, 255, 25.0),
                (31, 127, 50.0), (32, 128, 45.0), (32, 127, 20.0),
                (5, 128, 28.0), (40, 0, 33.0), (0, 100, 31.0)]

DETECTOR_CASES = [
    ("bench", (2, 64, 256), dict(threshold_scaler=6.0), {}),
    ("bench scaler 2.5", (1, 64, 256), {}, {}),
    ("grouping", (1, 64, 256), dict(peak_grouping=1), {}),
    ("log domain", (1, 64, 256), dict(log_or_linear=0,
                                      threshold_scaler=1.0), {}),
    ("extents at the bench maxima", (1, 64, 256),
     dict(ref_range=16, guard_range=4, ref_doppler=8, guard_doppler=2), {}),
    ("g = 0, w = 1", (1, 64, 256), dict(ref_range=1, guard_range=0,
                                        ref_doppler=1, guard_doppler=0), {}),
    ("g = 0", (1, 32, 256), dict(guard_range=0, guard_doppler=0,
                                 peak_grouping=1), {}),
    ("w = 1", (1, 32, 256), dict(ref_range=1, ref_doppler=1), {}),
    ("active range clipped on both sides", (1, 64, 256),
     dict(peak_grouping=1), dict(active_lo=37, active_hi=200)),
    ("active range inside one tile", (1, 32, 256), {},
     dict(active_lo=130, active_hi=141)),
    ("a tile cut by the map's end, P = 16", (2, 16, 256),
     dict(peak_grouping=1), {}),
    ("a tile cut by the map's end, P = 8", (1, 8, 256), {}, {}),
    ("Doppler reach past P", (1, 16, 256),
     dict(ref_doppler=40, guard_doppler=3, peak_grouping=1), {}),
    ("Doppler reach 80", (1, 128, 256),
     dict(ref_doppler=64, guard_doppler=16), {}),
    ("range reach 63", (1, 32, 256), dict(ref_range=60, guard_range=3), {}),
]


@pytest.mark.parametrize("name, shape, regs, active", DETECTOR_CASES,
                         ids=[c[0] for c in DETECTOR_CASES])
def test_the_detector_schedule_matches_cfar_2d_op(name, shape, regs, active):
    targets = EDGE_TARGETS if shape[1:] == (64, 256) else [
        (0, 0, 40.0), (shape[1] - 1, 255, 30.0), (shape[1] // 2, 128, 35.0)]
    m = _map(shape, seed=len(name), targets=targets)
    thr, pk = _against_plain(m, _regs(**regs), **active)
    if "bench" not in name or "2.5" in name:
        assert pk.any()


def test_the_detector_schedule_matches_jax_and_the_golden():
    rt2 = _regs(ref_range=3, guard_range=1, ref_doppler=2, guard_doppler=1,
                peak_grouping=1, threshold_scaler=2.0, active_range=250)
    m = _map((1, 16, 256), seed=7, targets=[(0, 0, 20.0), (15, 249, 18.0),
                                            (8, 128, 25.0), (8, 127, 24.0)])
    thr, pk = _emulate(m, rt2)
    cj = R.Cfar2dConfig(max_ref_range=3, max_guard_range=1, max_ref_doppler=2,
                        max_guard_doppler=1)
    assert cfar2d_config_from_reference(cj) == _cfg(rt2)
    rt_j = R.Cfar2dRuntime.make(ref_range=3, guard_range=1, ref_doppler=2,
                                guard_doppler=1, peak_grouping=1,
                                threshold_scaler=2.0, active_range=250)
    assert cfar2d_runtime_from_reference(rt_j) == rt2
    want = cfar_2d_jax(jnp.asarray(m), rt_j, cj)
    _assert_bar(thr, pk, want.threshold, want.peaks)
    thr_g, pk_g = cfar_2d_golden(
        m[0], ref_range=3, guard_range=1, ref_doppler=2, guard_doppler=1,
        threshold_scaler=2.0, peak_grouping=1, active_range=250)
    _assert_bar(thr[0], pk[0], thr_g, pk_g)
    assert pk.any()


@pytest.mark.parametrize("a_r", [1, 10, 20, 63])
def test_the_detector_layouts_are_free_of_bank_conflicts(a_r):
    s = _row_floats(a_r)
    assert s % 2 == 1 and s >= TR + 2 * a_r
    # the range runs: lane j of warp q reads cell 16 q + t of staged row j
    # and writes cell 16 q + k of range-sum row j; the Doppler runs read 32
    # consecutive cells of one range-sum row
    for q in range(THREADS // 32):
        for t in range(2 * a_r + 16):
            assert len({(j * s + 16 * q + t) % 32 for j in range(32)}) == 32
        for k in range(16):
            assert len({(j * SUMS + 16 * q + k) % 32 for j in range(32)}) \
                == 32
    assert SUMS % 2 == 1 and SUMS >= TR
    chunked = 4 * (RB * (s + 2 * SUMS) + 3 * TD + (TD + 2) * OWN)
    one = 4 * (RB1 * (s + 2 * SUMS) + 3 * TD)
    assert max(chunked, one) <= 232448
    if a_r <= 10:   # the bench's a_d = 5: three blocks an SM
        assert 3 * (4 * ((TD + 10) * (s + 2 * SUMS) + 3 * TD) + 1024) <= 233472
