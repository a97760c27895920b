"""The row plans of Kernels D (``chain_gos``) and G (``chain_int_gos``) on
the CPU, through numpy emulations of the kernels' layouts and schedule
(``csrc/gos_rows.cuh``, ``csrc/chain_gos.cu``, ``csrc/chain_int_gos.cu``).

* The block's shared memory is emulated as one flat array laid out as the
  kernels lay it out: the FFT planes of the block's frames, then their
  magnitude rows one float of padding in 16 (``rsp_mag_slot``). The rank
  selection (``rsp_gos_rows_stats``) cuts the window starts of the live
  frames into the warps' runs, each run within one frame; each run's first
  window is sorted, each further start slides it (``rsp_slide``, emulated
  compare for compare over the 32 or 64 slots), and the lag and lead ranks
  are stored by cell in the frame's two planes, never outside them. Every start of the loop without range tests (the window
  whole, both ranks kept) is checked to be one; the ranks equal the direct
  sort of each window, and the tail reads them back from the planes.
* D: A's forward plan and scatter (``tests/test_torch_chain_rows.py``),
  then the selection, or CASH's sub-window sums in the first plane and
  each side's least mean, or A's run-sum CA tail (algorithm 0); within 1e-5
  relative Δthr of ``chain_gos_reference``, and of the JAX
  ``fused_chain_gos`` (Pallas in interpret mode) within the 1e-4 of
  ``tests/test_torch_kernels.py`` (that kernel's FFT stands up to 3.6e-5
  from the reference's here), peaks equal.
* G: F's integer pass plan (int64, wrapped to int32), the magnitude, the
  selection on int32 with INT32_MAX as the top value, or F's run-sum tail;
  bit-equal to ``chain_int_gos_reference`` and the JAX
  ``fused_chain_int_gos`` (interpret mode).
* The statistic rows fit inside the planes, and the tail's reads of them
  (a thread's cells m + (N / 16) k) are free of bank conflicts.

Inputs are seeded numpy arrays."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.cplx import C as JC
from rsp_chains_tpu.kernels.chain_pallas import fused_chain_gos
from rsp_chains_tpu.kernels.int_chain_pallas import fused_chain_int_gos

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.convert import runtime_from_reference
from rsp_chains_tpu_torch.kernels import cfar as kcfar
from rsp_chains_tpu_torch.kernels import chain as kchain
from rsp_chains_tpu_torch.kernels import int_chain as kint
from rsp_chains_tpu_torch.ops import bit_true as TB
from rsp_chains_tpu_torch.ops.fft import fft_op, fft_scale
from test_torch_chain_rows import (
    PAD, _chain_ca, _combine, _int_frames, _int_rows_fft, _int_tail,
    _int_thr_peaks, _mag_row, _mag_slot, _masks, _plan, _thr_peaks,
    _worst_conflict,
)

SIZES = list(kchain.FUSABLE_SIZES)
assert SIZES == list(kint.ROW_SIZES)
WARPS = 8
CHUNK = 16          # the starts of a chunk of whole-window starts
INT_TOP = 2**31 - 1
CPU = torch.device("cpu")


def _layout(n):
    """(frames a block, floats a plane kS, floats between magnitude rows:
    Kernel A's kMagS padded to an odd multiple of 16, ``RspGosRows``)."""
    mag = (n + 2 * PAD) // 16 * 17 + 16
    return 256 // _plan(n)[0], n + 16, mag if mag % 32 else mag + 16


def _frames_of(unit, w):
    """The frames a piece of ``_schedule`` covers: a pair for w <= 32."""
    return [2 * unit, 2 * unit + 1] if w <= 32 else [unit]


def _schedule(n, live, w, g, lo, hi):
    """``rsp_gos_rows_stats``' pieces over a block with ``live`` frames:
    (warp, unit, first start, end start), starts as row indices; a unit is
    a pair of frames for w <= 32 (``_frames_of``), else a frame."""
    if hi <= lo:
        return []
    units = (live + 1) // 2 if w <= 32 else live
    s_lo = PAD + lo - g - w
    length = hi - lo + 2 * g + w + 1
    per = -(-units * length // WARPS)
    runs = []
    for warp in range(WARPS):
        u, end = warp * per, min(warp * per + per, units * length)
        while u < end:
            f = u // length
            v = min(end, (f + 1) * length)
            runs.append((warp, f, s_lo + u - f * length, s_lo + v - f * length))
            u = v
    return runs


def _bounds(s_a, s_b, w, g, lo, hi, n):
    """A run's whole-window starts [f_lo, f_hi) (``rsp_gos_ranks``)."""
    return (max(PAD + lo + 1, s_a + 1, PAD + g + 1),
            min(PAD + hi - w + 1, s_b, PAD - g - w + n))


def _drive(s_a, s_b, f_lo, f_hi, chunk):
    """The order of ``rsp_gos_pair_ranks`` (or ``rsp_gos_ranks`` with
    ``RspCellRows``) over a run of starts: ("step", s) and ("chunk", first
    start) events."""
    s, events = s_a + 1, []
    while s < s_b:
        if s == f_lo and f_lo < f_hi:
            while s < f_hi and (s - 1) % chunk:
                events.append(("step", s))
                s += 1
            while s + chunk <= f_hi:
                events.append(("chunk", s))
                s += chunk
            while s < f_hi:
                events.append(("step", s))
                s += 1
            continue
        events.append(("step", s))
        s += 1
    return events


def _half_sort(win):
    """``rsp_half_sort`` over runs: windows [R, 32], slot 2l + e held by
    lane l of the half-warp as x_e; compare for compare."""
    x = win.reshape(-1, 16, 2).copy()
    l = np.arange(16)
    k = 2
    while k <= 32:
        j = k >> 1
        while j > 0:
            up = ((2 * l) & k) == 0
            if j == 1:
                lt = x[..., 1] < x[..., 0]
                lo = np.where(lt, x[..., 1], x[..., 0])
                hi = np.where(lt, x[..., 0], x[..., 1])
                x = np.stack([np.where(up, lo, hi), np.where(up, hi, lo)], -1)
            else:
                keep_min = ((((2 * l) & j) == 0) == up)[:, None]
                o = x[:, l ^ (j >> 1), :]
                x = np.where(np.where(keep_min, o < x, x < o), o, x)
            j >>= 1
        k <<= 1
    return x.reshape(-1, 32)


def _half_slide(win, vo, vi, top):
    """``rsp_half_slide`` over runs: windows [R, 32] (slot 2l + e in lane
    l's x_e), the outgoing and incoming values [R, 1]."""
    l = np.arange(16)
    x0, x1 = win[:, 0::2], win[:, 1::2]
    up, dn = np.roll(x1, 1, axis=-1), np.roll(x0, -1, axis=-1)
    c0, p0 = np.where(x0 < vo, x0, x1), np.where(up < vo, up, x0)
    c1 = np.where(x1 < vo, x1, np.where(l == 15, top, dn))
    p1 = np.where(x0 < vo, x0, x1)
    n0 = np.where(c0 < vi, c0, np.where((l > 0) & ~(p0 < vi), p0, vi))
    n1 = np.where(c1 < vi, c1, np.where(~(p1 < vi), p1, vi))
    return np.stack([n0, n1], -1).reshape(win.shape)


def _slide(a, b, vo, vi, wide, top):
    """``rsp_slide`` over runs: slots [R, 32] ``a`` (and ``b`` for w = 64),
    the outgoing and incoming values [R, 1], every shuffle of the old
    slots."""
    lane = np.arange(32)
    a_dn, a_up = np.roll(a, -1, axis=-1), np.roll(a, 1, axis=-1)
    a_next = np.where(lane == 31, top, a_dn)
    if wide:
        b_dn, b_up = np.roll(b, -1, axis=-1), np.roll(b, 1, axis=-1)
        a_next = np.where(lane == 31, b_dn, a_dn)
        nxt = np.where(lane == 31, top, b_dn)
        prev = np.where(lane == 0, a_up, b_up)
        cur = np.where(b < vo, b, nxt)
        cur_prev = np.where(prev < vo, prev, b)
        b = np.where(cur < vi, cur, np.where(cur_prev < vi, vi, cur_prev))
    cur = np.where(a < vo, a, a_next)
    cur_prev = np.where(a_up < vo, a_up, a)
    a = np.where(cur < vi, cur,
                 np.where((lane > 0) & ~(cur_prev < vi), cur_prev, vi))
    return a, b


def _block_smem(rows, n, frames, dtype, poison):
    """Blocks' shared memory [B, floats]: the planes poisoned, the
    magnitude rows ``rows`` [frames, PAD + n + PAD] at ``rsp_mag_slot``,
    a dead frame's zeros (the front's of zero input)."""
    per, ks, kmag = _layout(n)
    blocks = -(-frames // per)
    smem = np.full((blocks, per * (2 * ks + kmag)), poison, dtype)
    slots = _mag_slot(np.arange(PAD + n + PAD))
    assert slots.max() < kmag and len(set(slots)) == len(slots)
    for f in range(blocks * per):
        b, q = divmod(f, per)
        smem[b, 2 * per * ks + q * kmag + slots] = rows[f] if f < frames else 0
    return smem


def _select(smem, n, frames, w, g, lo, hi, k0, k1, top):
    """The rank selection of every block, all runs in lockstep (each
    run's slides depend on its own window only), into ``smem``; returns how
    many times each word was written. Checks the order of
    ``rsp_gos_pair_ranks`` and ``rsp_gos_ranks``: each run's starts once
    each, in order, by single steps and chunks of 16 whole-window starts
    from one whose outgoing cell is 16-aligned (``_check_chunks``)."""
    per, ks, kmag = _layout(n)
    runs = []
    for b in range(smem.shape[0]):
        live_b = min(per, frames - b * per)
        for warp, unit, a, e in _schedule(n, live_b, w, g, lo, hi):
            order = _drive(a, e, *_bounds(a, e, w, g, lo, hi, n), CHUNK)
            seen = [s0 + t for kind, s0 in order
                    for t in range(CHUNK if kind == "chunk" else 1)]
            assert seen == list(range(a + 1, e))
            _check_chunks([s0 for kind, s0 in order if kind == "chunk"], w,
                          g, lo, hi, n)
            for fr in _frames_of(unit, w):    # a pair: the same starts
                runs.append((b, warp, fr, a, e, fr < live_b))
    writes = np.zeros(smem.shape, np.int64)
    if not runs:
        return writes
    blk, _, f, s_a, s_b, alive = (np.array(v) for v in zip(*runs))
    wide, idx = w > 32, np.arange(len(runs))
    alo, ahi = PAD + lo, PAD + hi
    off0, off1 = PAD - g - w, PAD + g + 1
    mag0 = 2 * per * ks + f * kmag

    def active(c):
        return (c >= alo) & (c < ahi)

    def at(c):                          # the cells c [R, ...] where active
        c2 = np.where(active(c), c, alo)
        return smem[blk.reshape((-1,) + (1,) * (c.ndim - 1)),
                    mag0.reshape((-1,) + (1,) * (c.ndim - 1)) + _mag_slot(c2)]

    c = s_a[:, None] + np.arange(64 if wide else 32)
    act = (np.arange(c.shape[1]) < w) & active(c)
    win = np.where(act, at(c), top)
    if wide:
        win = np.sort(win, axis=-1)
    else:
        win = _half_sort(win)
        np.testing.assert_array_equal(win, np.sort(win, axis=-1))
    nv = act.sum(-1)
    f_lo = np.maximum(np.maximum(alo + 1, s_a + 1), off1)
    f_hi = np.minimum(np.minimum(ahi - w + 1, s_b), off0 + n)

    def store(s, live):
        for k, off, plane in ((k0, off0, f), (k1, off1, per + f)):
            j = np.clip(np.minimum(k, nv - 1), 0, None)
            x = np.where(nv > 0, win[idx, j], 0)
            cell = s - off
            keep = live & alive & (cell >= 0) & (cell < n)
            at_ = plane * ks + np.clip(cell, 0, n - 1)
            assert ((at_ >= plane * ks) & (at_ < plane * ks + n)).all()
            smem[blk[keep], at_[keep]] = x[keep]
            np.add.at(writes, (blk[keep], at_[keep]), 1)

    store(s_a, np.ones(len(runs), bool))
    for t in range(1, int((s_b - s_a).max())):
        s = s_a + t
        live = s < s_b
        co, ci = s - 1, s - 1 + w
        ao, ai = active(co), active(ci)
        vo = np.where(ao, at(co[:, None])[:, 0], top)[:, None]
        vi = np.where(ai, at(ci[:, None])[:, 0], top)[:, None]
        if wide:
            a, b = _slide(win[:, :32], win[:, 32:], vo, vi, wide, top)
            slid = np.concatenate([a, b], -1)
        else:
            slid = _half_slide(win, vo, vi, top)
        move = (live & (ao | ai))[:, None]
        win = np.where(move, slid, win)
        nv = nv + np.where(live & (ao | ai), ai.astype(int) - ao, 0)
        assert (win[:, 1:] >= win[:, :-1]).all()        # still sorted
        fast = live & (s >= f_lo) & (s < f_hi)
        assert (nv[fast] == w).all() and ao[fast].all() and ai[fast].all()
        for off in (off0, off1):         # both ranks kept, unchecked
            assert ((s[fast] - off >= 0) & (s[fast] - off < n)).all()
        store(s, live)
    return writes


def _check_chunks(starts, w, g, lo, hi, n):
    """A run's chunks: 16-aligned outgoing cells, every cell active, the
    outgoing cells (and the incoming ones where w % 16 == 0) contiguous in
    the padded row, both ranks' cells in the frame."""
    t = np.arange(CHUNK)
    for c0 in starts:
        assert (c0 - 1) % CHUNK == 0
        for first in (c0 - 1, c0 - 1 + w):
            cells = first + t
            assert ((cells >= PAD + lo) & (cells < PAD + hi)).all()
            if (first - c0 + 1) % CHUNK == 0:
                np.testing.assert_array_equal(_mag_slot(cells),
                                              _mag_slot(first) + t)
        for off in (PAD - g - w, PAD + g + 1):
            assert ((c0 - off + t >= 0) & (c0 - off + t < n)).all()


def _read_stats(smem, n, frames):
    """The tail's reads: each frame's lag and lead ranks [frames, n] from
    its two planes, by cell."""
    per, ks, _ = _layout(n)
    cells = np.arange(n)
    lag = np.stack([smem[f // per, f % per * ks + cells]
                    for f in range(frames)])
    lead = np.stack([smem[f // per, (per + f % per) * ks + cells]
                     for f in range(frames)])
    return lag, lead


def _direct_ranks(row, n, w, g, lo, hi, k, top, lead):
    """The k-th smallest active cell of each cell's lag (or lead) window,
    by a sort of the window: [F, n]."""
    idx = np.arange(row.shape[-1])
    active = (idx >= PAD + lo) & (idx < PAD + hi)
    start = PAD + np.arange(n) + (g + 1 if lead else -g - w)
    cells = start[:, None] + np.arange(w)
    win = np.sort(np.where(active, row, top)[:, cells], axis=-1)
    nv = np.broadcast_to(active[cells].sum(-1), win.shape[:-1])
    j = np.clip(np.minimum(k, nv - 1), 0, None)
    got = np.take_along_axis(win, j[..., None], -1)[..., 0]
    return np.where(nv > 0, got, 0)


def _check_stats(smem, writes, row, n, frames, w, g, lo, hi, k0, k1, top):
    """The ranks read back equal the direct sort of each window, and each
    active cell's ranks were written exactly once."""
    lag, lead = _read_stats(smem, n, frames)
    on = (np.arange(n) >= lo) & (np.arange(n) < hi)
    w_lag, w_lead = _read_stats(writes, n, frames)
    assert (w_lag[:, on] == 1).all() and (w_lead[:, on] == 1).all()
    for got, k, side in ((lag, k0, False), (lead, k1, True)):
        want = _direct_ranks(row, n, w, g, lo, hi, k, top, side)
        np.testing.assert_array_equal(got[:, on], want[:, on])
    return lag, lead


# ---- the schedule and the layout ----

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("live", ["1", "3", "all"])
@pytest.mark.parametrize("w, g, lo, hi", [(32, 4, 0, None), (8, 2, 0, 200),
                                          (64, 8, 37, -21)])
def test_the_warps_runs_cover_each_live_frames_starts_once(n, live, w, g, lo,
                                                           hi):
    per = _layout(n)[0]
    live = per if live == "all" else int(live)
    hi = n if hi is None else hi % n
    runs = _schedule(n, live, w, g, lo, hi)
    length = hi - lo + 2 * g + w + 1
    units = (live + 1) // 2 if w <= 32 else live
    seen = {}
    for warp, unit, s_a, s_b in runs:
        assert 0 <= unit < units and s_a < s_b
        assert PAD + lo - g - w <= s_a and s_b <= PAD + hi + g + 1
        for f in _frames_of(unit, w):
            for s in range(s_a, s_b):
                seen[f, s] = seen.get((f, s), 0) + 1
    # every live frame's starts once; a pair's dead frame rides along
    assert {(f, s) for f, s in seen if f < live} == {
        (f, s) for f in range(live)
        for s in range(PAD + lo - g - w, PAD + hi + g + 1)}
    assert set(seen.values()) == {1}
    # each warp's share is one contiguous run of the units' starts in a
    # row, at most ceil(units * length / 8) starts, split only at units
    share = -(-units * length // WARPS)
    for warp in range(WARPS):
        mine = [r for r in runs if r[0] == warp]
        assert sum(s_b - s_a for _, _, s_a, s_b in mine) <= share
        for (_, f1, _, e1), (_, f2, s2, _) in zip(mine, mine[1:]):
            assert f2 == f1 + 1 and e1 == PAD + hi + g + 1 \
                and s2 == PAD + lo - g - w
    if live == 1:     # a served frame: all eight warps on its starts
        assert len(runs) == WARPS


@pytest.mark.parametrize("n", SIZES)
def test_the_statistic_rows_fit_in_the_dead_planes(n):
    """Each statistic row (n values by cell) lies inside one plane of its
    frame; the block keeps Kernel A's shared memory but for the magnitude
    rows' pad (16 floats a row at N = 512 and 1024); the tail's
    reads of both rows, the cells m + (N / 16) k of thread m, and CASH's
    reads at any offset are free of bank conflicts, the reads of the
    magnitude row at most 2-way."""
    per, ks, kmag = _layout(n)
    t = n // 16
    assert n <= ks
    block = per * (2 * ks + kmag) * 4          # bytes, A's and a pad
    assert block == 55552 if n == 1024 else block <= 70656
    # a pair's loads (rows kmag apart) and stores (planes ks apart) at one
    # cell fall in banks 16 apart
    assert kmag % 32 == 16 and ks % 32 == 16
    assert 3 * (block + 1024) <= 228 * 1024    # RSP_ROWS_BLOCKS an SM
    for side in (0, 1):
        assert _worst_conflict(
            n, lambda q, m, k: (side * per + q) * ks + m + t * k) == 1
    for off in (-37, 5, 16, 41):
        assert _worst_conflict(
            n, lambda q, m, k: q * ks + (m + t * k + off) % n) == 1
    for k2 in (0, 7, 63):   # 32 cells in 33 slots: at most 2-way
        assert _worst_conflict(
            n, lambda q, m, k: 2 * per * ks + q * kmag
            + _mag_slot(PAD + m + t * k + k2)) <= 2


# ---- Kernel D ----

def _gos_cfg(n):
    """The default elaboration (GOSCA + CASH, max_ref_window 64) at n."""
    return (R.ChainConfig(fft=R.FftConfig(max_size=n),
                          cfar=R.CfarConfig(max_fft_size=n)),
            T.ChainConfig(fft=T.FftConfig(max_size=n),
                          cfar=T.CfarConfig(max_fft_size=n)))


GOS = dict(ref_window_size=32, guard_window_size=4, threshold_scaler=3.5,
           div_sum=5, cfar_algorithm=1, index_lagg=16, index_lead=16)


def _regs(n, regs, raw):
    """(JAX registers, the port's) over GOS, ``raw`` written past make()."""
    rt_j = R.RuntimeConfig.make(**{"fft_size": n, **GOS, **regs})
    rt_j = dataclasses.replace(rt_j, **{k: jnp.asarray(v, jnp.int32)
                                        for k, v in raw.items()})
    return rt_j, runtime_from_reference(rt_j.peek())


def _frames(count, n, seed, kind="noise"):
    """Complex frames: noise and two strong tones, or integer impulses at
    multiples of n/4 and a weak tone, whose spectra tie in every window."""
    rng = np.random.RandomState(seed)
    if kind == "noise":
        x = (rng.randn(count, n) + 1j * rng.randn(count, n)) * 50
        x[:, 40] += 4000 + 100j
        x[:, 100] += 900 - 500j
    else:
        x = np.zeros((count, n), np.complex128)
        for k in range(4):
            x[:, k * n // 4] = (rng.randint(1, 9, count)
                                + 1j * rng.randint(-8, 9, count))
        x += 2.0 * np.exp(2j * np.pi * 40 * np.arange(n) / n)
    return x.astype(np.complex64)


# (registers over GOS, raw registers, active cut, frames, input)
D_POINTS = {
    "bench GOS": (dict(), {}, None, "rows + 1", "noise"),
    "GO, w 8, ranks 0": (dict(cfar_mode=1, ref_window_size=8,
                              guard_window_size=2, div_sum=3, index_lagg=0,
                              index_lead=0), {}, None, 1, "noise"),
    "SO, w 64, ranks 8/24, grouping": (
        dict(cfar_mode=2, ref_window_size=64, guard_window_size=8, div_sum=6,
             index_lagg=8, index_lead=24, peak_grouping=1), {}, None, 3,
        "noise"),
    "ranks >= window, LOG2": (
        dict(mag_mode=3, log_or_linear=0, threshold_scaler=2.0),
        dict(index_lagg=40, index_lead=64), None, 3, "noise"),
    "short range, w 16": (dict(cfar_fft_size=200, ref_window_size=16,
                               guard_window_size=2, index_lagg=15,
                               index_lead=2, peak_grouping=1), {}, None, 1,
                          "noise"),
    "active 37 .. N - 21": (dict(index_lagg=3, index_lead=20,
                                 peak_grouping=1), {}, (37, -21),
                            "rows + 1", "noise"),
    "tied spectra": (dict(ref_window_size=8, guard_window_size=2,
                          index_lagg=2, index_lead=5, mag_mode=1), {}, None,
                     3, "impulses"),
    "CASH sub_w 8": (dict(cfar_mode=3, sub_window_size=8), {}, None,
                     "rows + 1", "noise"),
    "CASH sub_w 2, short range": (dict(cfar_mode=3, sub_window_size=2,
                                       cfar_fft_size=200), {}, None, 3,
                                  "noise"),
    "CASH sub_w > w": (dict(cfar_mode=3, mag_mode=3, log_or_linear=0,
                            threshold_scaler=2.0),
                       dict(sub_window_size=64), None, 1, "noise"),
    "CA sums (algorithm 0)": (dict(cfar_algorithm=0, cfar_mode=1), {}, None,
                              3, "noise"),
}


def _count(n, frames):
    return _layout(n)[0] + 1 if frames == "rows + 1" else frames


def _cash_noise(smem, row, n, frames, r):
    """CASH on the row plan: the sub-window sums of each frame's cells, in
    the kernel's order, into its first plane, then each side's least mean
    read back from it: [frames, n]."""
    per, ks, _ = _layout(n)
    lo, hi, sw, w, g = r.active_lo, r.active_hi, r.sub_w, 1 << r.log2w, r.guard
    u = np.arange(n)
    s = np.zeros((frames, n), np.float32)
    for k in range(sw):
        s = s + row[:, PAD + k:PAD + k + n]
    sub = np.where((u >= lo) & (u + sw <= hi), s, np.float32(np.inf))
    for f in range(frames):
        smem[f // per, f % per * ks + u] = sub[f]

    def side(u0):
        mn = np.full((frames, n), np.inf, np.float32)
        for t in range(w - sw + 1):
            v = u0 + t
            ok = (v >= lo) & (v <= hi - sw)
            got = np.stack([smem[f // per, f % per * ks + np.clip(v, 0, n - 1)]
                            for f in range(frames)])
            mn = np.where(ok, np.minimum(mn, got), mn)
        return np.where(mn < np.inf, mn / np.float32(max(sw, 1)),
                        np.float32(0))

    return np.maximum(side(u - g - w), side(u + g + 1))


def _chain_gos(x, n, r, scale):
    """Kernel D's plan: A's front, then the selection, CASH or the CA sums,
    and the tail: (threshold, peaks)."""
    frames = x.shape[0]
    row = _mag_row(x, n, r, scale)
    smem = _block_smem(row, n, frames, np.float32, np.nan)
    w, g, lo, hi = 1 << r.log2w, r.guard, r.active_lo, r.active_hi
    if r.cfar_mode == 3:
        return _thr_peaks(row, _cash_noise(smem, row, n, frames, r), r)
    if r.algorithm == 1:
        writes = _select(smem, n, frames, w, g, lo, hi, r.rank_lagg,
                         r.rank_lead, np.float32(np.inf))
        lag, lead = _check_stats(smem, writes, row, n, frames, w, g, lo, hi,
                                 r.rank_lagg, r.rank_lead, np.inf)
        on = (np.arange(n) >= lo) & (np.arange(n) < hi)
        assert not np.isnan(lag[:, on]).any()
        return _thr_peaks(row, _combine(r.cfar_mode, lag, lead), r)
    ca = kcfar.CaRegs(log2w=r.log2w, guard=g, div_sum=r.div_sum,
                      cfar_mode=r.cfar_mode, log_or_linear=r.log_or_linear,
                      peak_grouping=r.peak_grouping, active_lo=lo,
                      active_hi=hi, mag_mode=r.mag_mode, scaler=r.scaler)
    return _chain_ca(x, n, ca, scale)


@functools.lru_cache(maxsize=None)
def _jax_chain_gos(n):
    """The JAX ``fused_chain_gos`` at N = n, jitted once (the registers are
    traced)."""
    cfg_j, _ = _gos_cfg(n)
    return jax.jit(lambda x, rt: fused_chain_gos(x, rt, cfg_j.fft, cfg_j.cfar,
                                                 interpret=True))


def _assert_rel(thr, want, bar=1e-5):
    assert np.abs(thr - want).max() / np.abs(want).max() < bar


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("point", list(D_POINTS))
def test_the_emulated_gos_rows_match_chain_gos_and_jax(n, point):
    regs, raw, cut, frames, kind = D_POINTS[point]
    frames = _count(n, frames)
    x = _frames(frames, n, seed=n + len(point), kind=kind)
    rt_j, rt = _regs(n, regs, raw)
    cfg_j, cfg = _gos_cfg(n)
    lo, hi = (None, None) if cut is None else (cut[0], cut[1] % n)
    r = kcfar.gos_registers(rt, cfg.cfar, n, lo, hi)
    assert (r.cfar_mode == 3) == ("CASH" in point)
    assert r.algorithm == (0 if "algorithm 0" in point else 1)
    thr, pk = _chain_gos(x, n, r, fft_scale(n, cfg.fft))
    if cut is None:
        want = kchain.chain_gos_reference(T.as_pair(x), rt, cfg.fft, cfg.cfar)
    else:
        want = kcfar.mag_cfar_reference(fft_op(T.as_pair(x), None, cfg.fft),
                                        rt, cfg.cfar, active_lo=lo,
                                        active_hi=hi)
    _assert_rel(thr, want.threshold.numpy())
    np.testing.assert_array_equal(pk, want.peaks.numpy())
    assert pk.any() or point != "bench GOS"
    if frames == 3 and cut is None and n in (256, 1024):
        # the bar of tests/test_torch_kernels.py: the Pallas kernel's
        # split-matmul FFT stands up to 3.6e-5 from chain_gos_reference's
        # torch.fft at these points (SO over w 64 picks cells ~1e-3 below the
        # tones), and the emulation as far from it as the reference is
        got_j = _jax_chain_gos(n)(R.as_pair(x), rt_j)
        _assert_rel(thr, np.asarray(got_j.threshold), 1e-4)
        np.testing.assert_array_equal(pk, np.asarray(got_j.peaks))


# ---- Kernel G ----

# (registers over GOS, raw registers, expanding stages, input, frames)
G_POINTS = {
    "bench GOS": (dict(), {}, 0, "random", "rows + 1"),
    "GO, w 8, ranks 0, grouping": (
        dict(cfar_mode=1, ref_window_size=8, guard_window_size=2,
             index_lagg=0, index_lead=0, peak_grouping=1), {}, 0, "random", 1),
    "SO, w 64, ranks 8/24, short range": (
        dict(cfar_mode=2, ref_window_size=64, guard_window_size=8, div_sum=6,
             index_lagg=8, index_lead=24, cfar_fft_size=200), {}, 0, "random",
        3),
    "ranks >= window": (dict(), dict(index_lagg=40, index_lead=64), 0,
                        "random", 3),
    "SQR saturated, full scale": (
        dict(mag_mode=1, ref_window_size=16, guard_window_size=2,
             index_lagg=15, index_lead=12), {}, 7, "full", "rows + 1"),
    "tied: impulses": (dict(ref_window_size=8, guard_window_size=2,
                            index_lagg=3, index_lead=7), {}, 0, "impulses",
                       3),
    "CA sums (algorithm 0)": (dict(cfar_algorithm=0, cfar_mode=1, mag_mode=1,
                                   div_sum=0), {}, 0, "random", 3),
}


def _int_input(kind, frames, n, seed):
    if kind == "impulses":
        re = np.zeros((frames, n), np.int32)
        re[:, 0] = 1000 * np.arange(1, frames + 1)
        return re, np.zeros_like(re)
    return _int_frames(n, seed, 32767 if kind == "full" else 30000, frames)


@functools.lru_cache(maxsize=None)
def _jax_chain_int_gos(n):
    cfg_j, _ = _gos_cfg(n)
    return jax.jit(lambda x, rt: fused_chain_int_gos(
        x, rt, cfg_j.fft, cfg_j.cfar, interpret=True))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("point", list(G_POINTS))
def test_the_emulated_integer_gos_rows_equal_chain_int_gos_and_jax(n, point):
    regs, raw, expanding, kind, frames = G_POINTS[point]
    frames = _count(n, frames)
    re, im = _int_input(kind, frames, n, n + len(point))
    rt_j, rt = _regs(n, regs, raw)
    cfg_j, cfg = _gos_cfg(n)
    el, km = _masks(n, expand=tuple(range(expanding)))
    fft_t = T.FftConfig(max_size=n, expand_logic=el, keep_msb_or_lsb=km)
    r = kint.int_registers(rt, cfg.cfar, n)
    sr, si = _int_rows_fft(re, im, n, *kint.fft_masks(fft_t, n))
    mag = TB.mag_int_op(T.C(torch.from_numpy(sr.astype(np.int32)),
                            torch.from_numpy(si.astype(np.int32))),
                        rt.mag_mode).numpy().astype(np.int64)
    w, g, hi = 1 << r.log2w, r.guard, r.n_active
    if r.algorithm == 1:
        row = np.zeros((frames, PAD + n + PAD), np.int64)
        row[:, PAD:PAD + n] = np.where(np.arange(n) < hi, mag, 0)
        smem = _block_smem(row, n, frames, np.int64, 2**40)
        writes = _select(smem, n, frames, w, g, 0, hi, r.rank_lagg,
                         r.rank_lead, INT_TOP)
        lag, lead = _check_stats(smem, writes, row, n, frames, w, g, 0, hi,
                                 r.rank_lagg, r.rank_lead, INT_TOP)
        thr, pk = _int_thr_peaks(row, lag, lead, r)
    else:
        thr, pk = _int_tail(mag, r)
    if kind == "full":
        assert (mag == INT_TOP).mean() > 0.2      # the square sums saturate
    if kind == "impulses":
        assert (mag[:, :1] == mag).all()           # every magnitude equal
    x = T.C(torch.from_numpy(re), torch.from_numpy(im))
    want = kint.chain_int_gos_reference(x, rt, fft_t, cfg.cfar)
    np.testing.assert_array_equal(thr, want.threshold.numpy())
    np.testing.assert_array_equal(pk, want.peaks.numpy())
    if frames == 3 and expanding == 0 and n in (256, 1024):
        got_j = _jax_chain_int_gos(n)(JC(jnp.asarray(re), jnp.asarray(im)),
                                      rt_j)
        np.testing.assert_array_equal(thr, np.asarray(got_j.threshold))
        np.testing.assert_array_equal(pk, np.asarray(got_j.peaks))
