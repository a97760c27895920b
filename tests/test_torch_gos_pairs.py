"""Two windows a warp (``csrc/gos_cfar.cuh`` ``rsp_gos_pair_ranks``) where
Kernel C (``mag_gos_cfar``), Kernel G's mid-size route
(``chain_int_gos_mid``, ``csrc/int_mid.cu``) and G's split tail
(``chain_int_gos_split``, ``csrc/int_split.cu``) run their rank selection
at w <= 32, on the CPU through numpy emulations of the kernels' schedules
and shared memory.

* Schedules. Frame pairs (``rsp_gos_row_pairs``: C's range tile of two
  frames, G's 4 or 2 rows a block at N = 2048 and 4096) give both halves of
  a warp the same starts of two rows; run pairs (``rsp_gos_stats``: G's one
  row a block at N = 8192 and 16384, the split tail's tiles) give half 1 of
  warp k the run of starts an odd number past half 0's. Each live row's
  window starts are covered once; at w = 64 one row a warp.
* The selection, compare for compare (``_half_sort``, ``_half_slide`` of
  ``tests/test_torch_gos_rows.py``), every warp in lockstep. Every branch is
  taken on values the two halves share: the whole-window stretch's bounds
  are met over the halves, every cell a half reads there is active and a
  live half keeps both ranks there; elsewhere both halves slide, the top
  value out and in for an inactive cell, or neither where neither has an
  active cell (a warp vote). So both halves shuffle together. The ranks
  stored equal a direct sort of each window; only the starts that the
  row's cells read are stored, each rank once, and a dead half stores
  nothing. (The chunks of the stretch change no value here:
  ``RspStartRows`` keeps a row's cells contiguous.)
* The active ranges that ``tests/test_torch_cuda.py`` (``_run_cut``) and
  ``chip_smoke.py`` (``run_boundary``) end "at a run boundary" end where
  the emulated schedule's fourth run starts, under the same registers.
* Banks: the two halves' words of one load or store lie in different
  banks (C's rows and G's rows an odd multiple of 16 words apart, run
  pairs an odd number of starts apart); the shared memory fits.
* The kernels: C within 1e-5 relative of ``mag_gos_cfar_reference``, peaks
  equal, and of the JAX ``fused_mag_gos_cfar`` (interpret mode) at n = 1024
  and 1280; G bit-equal to ``chain_int_gos_reference`` at N = 2048 ... 32768
  and to the JAX ``fused_chain_int_gos`` (interpret mode) at 2048, with
  magnitudes saturated at INT32_MAX. The spectra come from the plain FFTs:
  the fronts are emulated in ``tests/test_torch_int_mid.py`` and
  ``tests/test_torch_int_split.py``.

Inputs are seeded numpy arrays."""

import dataclasses
import functools
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.cplx import C as JC
from rsp_chains_tpu.kernels.cfar_pallas import fused_mag_gos_cfar
from rsp_chains_tpu.kernels.int_chain_pallas import fused_chain_int_gos

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.convert import runtime_from_reference
from rsp_chains_tpu_torch.kernels import cfar as kcfar
from rsp_chains_tpu_torch.kernels import int_chain as kint
from rsp_chains_tpu_torch.ops import bit_true as TB
from rsp_chains_tpu_torch.ops.logmag import logmag
from test_torch_chain_rows import _combine, _masks, _thr_peaks, _w32
from test_torch_gos_rows import _half_slide, _half_sort
from test_torch_cuda import _pair_rt, _run_cut

PAD = kcfar.PAD
INT_TOP = 2**31 - 1
POISON = -7                  # statistic words no store reached
WINDOWS = [1, 2, 8, 16, 32]
RANKS = ["0", "w - 1"]
SMEM_MAX = 227 * 1024        # a block's shared memory (opt-in)
SMEM_PLAIN = 48 * 1024       # without the opt-in
HALF = 8192                  # int_mid.cu: cells a block; the split's sub-frame
TILE = 4096                  # int_split.cu: the tail's tile
# the registers that place a window: its length, guard and two ranks
REG_FIELDS = ("ref_window_size", "guard_window_size", "index_lagg",
              "index_lead")

_SMOKE = importlib.util.spec_from_file_location(
    "chip_smoke",
    pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SMOKE)
_SMOKE.loader.exec_module(chip_smoke)


# ---- the two schedules ----

def _frame_pairs(live, s_lo, length, warps):
    """``rsp_gos_row_pairs`` at w <= 32: the pieces (warp, pair, first
    start, end start) of the starts [s_lo, s_lo + length) of rows 0 .. live
    - 1, pair after pair, cut into ``warps`` equal runs, a run split where
    it crosses into the next pair. At w = 64 the same with rows for pairs
    (``units``)."""
    return _pieces((live + 1) // 2, s_lo, length, warps)


def _pieces(units, s_lo, length, warps):
    per = -(-units * length // warps)
    out = []
    for warp in range(warps):
        u, end = warp * per, min(warp * per + per, units * length)
        while u < end:
            p = u // length
            v = min(end, (p + 1) * length)
            out.append((warp, p, s_lo + u - p * length, s_lo + v - p * length))
            u = v
    return out


def _run_pairs(s_lo, s_hi, warps):
    """``rsp_gos_stats`` at w <= 32: (the runs' odd length, [(warp, half 0's
    first start)] of the warps that have starts); half h of a warp runs
    from its first start + h per."""
    per = -(-(s_hi - s_lo) // (2 * warps)) | 1
    return per, [(k, s_lo + 2 * k * per) for k in range(warps)
                 if s_lo + 2 * k * per < s_hi]


def _frame_pair_warps(rows0, live, s_lo, length, warps, alo, ahi):
    """The warps of a block on frame pairs, as (s_a, s_b, [(row, shift,
    alo, ahi, keep)] of both halves); ``rows0`` the block's first row."""
    out = []
    for _, p, s_a, s_b in _frame_pairs(live, s_lo, length, warps):
        halves = [(rows0 + 2 * p + h, 0, alo, ahi,
                   s_b - s_a if 2 * p + h < live else 0) for h in (0, 1)]
        out.append((s_a, s_b, halves))
    return out


def _run_pair_warps(row, s_lo, s_hi, warps, alo, ahi, w):
    """The warps of a block on run pairs over row ``row``: half h sees the
    row shifted by h per (its alo, ahi shifted back), the active cells cut
    at s_hi - 1 + w, and keeps min(per, s_hi - its first start) starts."""
    per, firsts = _run_pairs(s_lo, s_hi, warps)
    ahi = min(ahi, s_hi - 1 + w)
    out = []
    for _, s_a in firsts:
        halves = [(row, d, alo - d, ahi - d, max(min(per, s_hi - s_a - d), 0))
                  for d in (0, per)]
        out.append((s_a, s_a + per, halves))
    return out


# ---- the selection ----

def _pair_select(cells, st, writes, warps, w, k0, k1, top):
    """``rsp_gos_pair_ranks`` of every warp in ``warps`` in lockstep over
    the rows ``cells`` [rows, L] (row coordinates, the rows by start);
    stores the lag and lead ranks into ``st`` [2, rows, L] and counts each
    store in ``writes``. Checks that every branch is the warp's and that the
    stretch reads only active cells and keeps both ranks of a live half."""
    if not warps:
        return
    sa = np.array([x[0] for x in warps])
    sb = np.array([x[1] for x in warps])
    half = np.array([x[2] for x in warps])          # [R, 2, 5]
    row, d, alo, ahi, keep = (half[..., i] for i in range(5))
    length = cells.shape[1]
    live = keep > 0
    s_k = sa[:, None] + keep

    def active(c):
        return (c >= alo[..., None]) & (c < ahi[..., None])

    def at(c):                     # c [R, 2, k] in the halves' coordinates
        idx = c + d[..., None]
        ok = active(c)
        assert ((idx >= 0) & (idx < length))[ok].all()
        return cells[row[..., None], np.clip(idx, 0, length - 1)]

    c = np.broadcast_to(sa[:, None, None] + np.arange(32), row.shape + (32,))
    act = (np.arange(32) < w) & active(c)
    win = np.where(act, at(c), top)
    win = _half_sort(win.reshape(-1, 32)).reshape(win.shape)
    assert (win[..., 1:] >= win[..., :-1]).all()
    nv = np.maximum(np.minimum(sa[:, None] + w, ahi)
                    - np.maximum(sa[:, None], alo), 0)
    assert (nv == act.sum(-1)).all()
    # the stretch's bounds, met over the halves: uniform over the warp
    f_lo = np.maximum(alo + 1, sa[:, None] + 1).max(1)
    f_hi = np.minimum(ahi - w + 1, sb[:, None])
    f_hi = np.where(live, np.minimum(f_hi, s_k), f_hi).min(1)
    f0, f1 = min(k0, w - 1), min(k1, w - 1)

    def store(s, on, stretch):
        kept = on[:, None] & (s[:, None] < s_k)
        for side, k, f in ((0, k0, f0), (1, k1, f1)):
            j = np.clip(np.minimum(k, nv - 1), 0, None)
            assert (j[stretch] == f).all()          # the stretch's fixed slot
            x = np.where(nv > 0, np.take_along_axis(win, j[..., None],
                                                    -1)[..., 0], 0)
            r, at_ = row[kept], (s[:, None] + d)[kept]
            st[side, r, at_] = x[kept]
            np.add.at(writes[side], (r, at_), 1)

    store(sa, np.ones(len(sa), bool), np.zeros_like(live))
    for t in range(1, int((sb - sa).max())):
        s = sa + t
        on = s < sb
        stretch = on & (s >= f_lo) & (s < f_hi)
        co = np.broadcast_to((s - 1)[:, None, None], row.shape + (1,))
        ci = co + w
        ao, ai = active(co)[..., 0], active(ci)[..., 0]
        # the stretch slides on unconditional reads: both halves' cells are
        # active, each window whole, and a live half keeps both ranks
        assert (ao & ai)[stretch].all()
        assert (nv[stretch] == w).all()
        assert (s[stretch][:, None] < s_k[stretch])[live[stretch]].all()
        vo = np.where(ao, at(co)[..., 0], top)
        vi = np.where(ai, at(ci)[..., 0], top)
        slid = _half_slide(win.reshape(-1, 32), vo.reshape(-1, 1),
                           vi.reshape(-1, 1), top).reshape(win.shape)
        # both halves slide, unless neither has an active cell (a vote)
        moved = on & (ao | ai).any(1)
        win = np.where(moved[:, None, None], slid, win)
        nv = nv + np.where(moved[:, None], ai.astype(int) - ao, 0)
        assert (win[..., 1:] >= win[..., :-1]).all()
        store(s, on, stretch[:, None] & live)


def _direct(cells, s_lo, s_hi, w, alo, ahi, k, top):
    """The min(k, nv - 1)-th smallest active cell of each window [s, s + w)
    of the rows ``cells`` [rows, L], s_lo <= s < s_hi, by a sort; 0 where
    nv = 0."""
    s = np.arange(s_lo, s_hi)
    idx = s[:, None] + np.arange(w)
    valid = (idx >= alo) & (idx < ahi)
    win = np.sort(np.where(valid, cells[:, np.clip(idx, 0, cells.shape[1]
                                                   - 1)], top), axis=-1)
    nv = valid.sum(-1)
    j = np.clip(np.minimum(k, nv - 1), 0, None)
    got = np.take_along_axis(win, np.broadcast_to(j[:, None], win.shape[:-1]
                                                  + (1,)), -1)[..., 0]
    return np.where(nv > 0, got, 0)


# ---- the schedules and the layouts ----

def _c_tile(n):
    """``rsp_mag_gos_cfar``'s tile: the largest of 1024, 512, 256 that
    divides n."""
    return next(t for t in (1024, 512, 256) if n % t == 0)


def _c_stride(tile):
    """``rsp_gos_stride``: the tile, its margins and 16 words."""
    return tile + 2 * PAD + 16


def _mid_rows(n):
    """``RspMidPlan``: (rows a block, a row's span, words between G's rows
    kStatP, the front's words, all words)."""
    rows = 1 if n > HALF else HALF // n
    span = HALF if n > HALF else n
    stat_p = span + 2 * PAD + 16
    front = max(2 * HALF, 3 * rows * stat_p)
    row = (span + 2 * PAD) // 16 * 17 + 16            # rsp_mag_floats
    return rows, span, stat_p, front, front + rows * row


@pytest.mark.parametrize("layout", ["C 1024", "C 1280", "C 512",
                                    "G 2048", "G 4096", "G 8192", "G 16384",
                                    "G split"])
@pytest.mark.parametrize("w", WINDOWS + [64])
def test_each_live_rows_starts_are_covered_once(layout, w):
    """Frame pairs cover each live row's starts once at every live row
    count of a block (an odd one leaves a dead half); run pairs cover the
    row's starts once, their halves an odd number of starts apart; at
    w = 64 runs of one row a warp."""
    g = max(1, w // 8) if w > 1 else 0
    kind, size = layout.split()
    if kind == "C":
        span, warps, lives = _c_tile(int(size)), 8, (1, 2)
    elif size == "split":
        span, warps, lives = TILE, 8, (1,)
    else:
        rows, span, _, _, _ = _mid_rows(int(size))
        warps, lives = 32, range(1, rows + 1)
    s_lo, s_hi = PAD - g - w, PAD + span + g + 1
    for live in lives:
        seen = np.zeros((max(live + live % 2, 1), s_hi), np.int64)
        if w > 32:
            for _, f, a, b in _pieces(live, s_lo, s_hi - s_lo, warps):
                seen[f, a:b] += 1
        elif live > 1 or kind == "C" or size in ("2048", "4096"):
            for _, p, a, b in _frame_pairs(live, s_lo, s_hi - s_lo, warps):
                seen[2 * p:2 * p + 2, a:b] += 1
            seen[live:] = 0                  # a dead half keeps nothing
        else:
            per, firsts = _run_pairs(s_lo, s_hi, warps)
            assert per % 2 == 1 and len(firsts) <= warps
            for _, a in firsts:
                for dd in (0, per):
                    seen[0, a + dd:min(a + dd + per, s_hi)] += 1
        assert (seen[:live, s_lo:] == 1).all() and (seen[:, :s_lo] == 0).all()
    # every window inside its row of span + 2 PAD cells
    assert s_lo >= 0 and s_hi - 1 + w <= span + 2 * PAD


@pytest.mark.parametrize("layout", ["C", "G 2048", "G 4096", "run pairs"])
def test_the_halves_words_lie_in_different_banks_and_fit(layout):
    """One load or store instruction of a pair touches one word of each
    half: C's rows ``rsp_gos_stride`` apart and G's rows kStatP apart are an
    odd multiple of 16 words apart, run pairs an odd number; C's six rows of
    a frame pair need no opt-in, G's fit a block past its magnitude
    rows."""
    if layout == "C":
        for n in (256, 512, 768, 1024, 1280):
            stride = _c_stride(_c_tile(n))
            assert stride % 32 == 16 and stride >= _c_tile(n) + 2 * PAD
            assert 6 * stride * 4 <= SMEM_PLAIN
    elif layout.startswith("G"):
        rows, span, stat_p, front, words = _mid_rows(int(layout.split()[1]))
        assert stat_p % 32 == 16 and stat_p >= span + 2 * PAD
        assert front >= 3 * rows * stat_p and words * 4 <= SMEM_MAX
    else:
        for span, warps in ((HALF, 32), (TILE, 8)):
            for w in WINDOWS:
                g = max(1, w // 8) if w > 1 else 0
                per, _ = _run_pairs(PAD - g - w, PAD + span + g + 1, warps)
                assert per % 32 != 0 and per % 2 == 1


# ---- Kernel C: a range tile of two frames a block ----

def _c_emulated(mag, r):
    """``rsp_mag_gos_cfar_kernel`` at algorithm 1 over the magnitudes [F, n]
    (zero outside the active range): each block's two frames' rows of its
    tile, the frame-pair selection of 8 warps, the tail; (threshold,
    peaks)."""
    frames, n = mag.shape
    tile, w, g = _c_tile(n), 1 << r.log2w, r.guard
    lo, hi = r.active_lo, r.active_hi
    slab = tile + 2 * PAD
    blocks = [(p, ts) for p in range(0, frames, 2) for ts in range(0, n, tile)]
    padded = np.zeros((frames + 1, PAD + n + PAD), np.float32)  # a dead frame
    padded[:frames, PAD:PAD + n] = mag
    cells = np.zeros((2 * len(blocks), slab), np.float32)
    warps = []
    s_lo, s_hi = PAD - g - w, PAD + tile + g + 1
    for b, (p, ts) in enumerate(blocks):
        cells[2 * b:2 * b + 2] = padded[p:p + 2, ts:ts + slab]
        warps += _frame_pair_warps(2 * b, min(2, frames - p), s_lo,
                                   s_hi - s_lo, 8, lo - ts + PAD,
                                   hi - ts + PAD)
    live = np.array([p + h < frames for p, _ in blocks for h in (0, 1)])
    # every block's alo / ahi differ; check the ranks tile by tile
    st = np.full((2,) + cells.shape, POISON, np.float32)
    writes = np.zeros(st.shape, np.int64)
    _pair_select(cells, st, writes, warps, w, r.rank_lagg, r.rank_lead,
                 np.float32(np.inf))
    noise = np.zeros((frames, n), np.float32)
    j = np.arange(tile)
    k = PAD + j
    for b, (p, ts) in enumerate(blocks):
        rows = slice(2 * b, 2 * b + 2)
        on = live[rows]
        for side, rank in ((0, r.rank_lagg), (1, r.rank_lead)):
            assert (writes[side, rows][on, s_lo:s_hi] == 1).all()
            assert (writes[side, rows][:, :s_lo] == 0).all()
            assert (writes[side, rows][:, s_hi:] == 0).all()
            assert (writes[side, rows][~on] == 0).all()
            np.testing.assert_array_equal(
                st[side, rows][on, s_lo:s_hi],
                _direct(cells[rows][on], s_lo, s_hi, w, lo - ts + PAD,
                        hi - ts + PAD, rank, np.float32(np.inf)))
        for h in np.flatnonzero(on):
            noise[p + h, ts:ts + tile] = _combine(
                r.cfar_mode, st[0, 2 * b + h, k - g - w],
                st[1, 2 * b + h, k + g + 1])
    return _thr_peaks(padded[:frames], noise, r)


def _spectrum(frames, n, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(frames, n) + 1j * rng.randn(frames, n)) * 40
    x[:, 40] += 3000 + 100j
    x[:, n // 3] += 800 - 400j
    return x.astype(np.complex64)


def _regs(w, rank, n=1024, **kw):
    """JAX's and the port's registers at FFT size n and window w (guard
    max(1, w // 8); w = 1 with guard 0 written past make()'s rules), the
    lag rank 0 or w - 1 and the lead rank its mirror."""
    k = 0 if rank == "0" else w - 1
    mw = max(w, 2)
    rt_j = R.RuntimeConfig.make(**{
        "fft_size": n, "ref_window_size": mw,
        "guard_window_size": max(1, mw // 8), "threshold_scaler": 3.5,
        "div_sum": 5, "cfar_algorithm": 1, "index_lagg": min(k, mw - 1),
        "index_lead": min(w - 1 - k, mw - 1), **kw})
    if w == 1:
        rt_j = dataclasses.replace(rt_j, **{f: jnp.asarray(0, jnp.int32)
                                            for f in ("guard_window_size",
                                                      "index_lagg",
                                                      "index_lead")},
                                   ref_window_size=jnp.asarray(1, jnp.int32))
    return rt_j, runtime_from_reference(rt_j.peek())


C_CFG = T.CfarConfig()                   # the default GOSCA + CASH elaboration


@pytest.mark.parametrize("n, frames, cut", [
    (1024, 3, None), (1280, 2, (37, 1280 - 101)), (512, 5, (100, 430))])
@pytest.mark.parametrize("w", WINDOWS)
@pytest.mark.parametrize("rank", RANKS)
def test_the_emulated_c_pairs_match_mag_gos_cfar(n, frames, cut, w, rank):
    """Kernel C over an odd or even frame count (the last block's dead
    half), the whole frame or an active range cut inside a tile; windows
    whose nv < w at the range's edges; within 1e-5 of the plain version,
    peaks equal."""
    x = _spectrum(frames, n, seed=n + w + len(rank))
    _, rt = _regs(w, rank, cfar_mode=WINDOWS.index(w) % 3,
                  peak_grouping=WINDOWS.index(w) % 2)
    rt = dataclasses.replace(rt, cfar_fft_size=n)
    lo, hi = cut or (None, None)
    r = kcfar.gos_registers(rt, C_CFG, n, lo, hi)
    spec = T.as_pair(x)
    mag = logmag(spec, rt.mag_mode).numpy()
    mag = np.where((np.arange(n) >= r.active_lo) & (np.arange(n)
                                                     < r.active_hi), mag, 0)
    thr, pk = _c_emulated(mag.astype(np.float32), r)
    want = kcfar.mag_gos_cfar_reference(spec, rt, C_CFG, active_lo=lo,
                                        active_hi=hi)
    scale = np.abs(want.threshold.numpy()).max()
    assert np.abs(thr - want.threshold.numpy()).max() / scale < 1e-5
    np.testing.assert_array_equal(pk, want.peaks.numpy())


# an elaboration of windows up to 8: interpret mode's window stacks cost by
# the widest window
SMALL = dict(max_ref_window=8, max_guard_window=4)


@pytest.mark.parametrize("n, rank", [(1024, "w - 1"), (1280, "0")])
def test_the_emulated_c_pairs_match_the_jax_kernel(n, rank):
    """One point each against the JAX ``fused_mag_gos_cfar`` in interpret
    mode, at n = 1024 (one tile of 1024) and the halo-extended 1280 (five
    tiles of 256), an odd frame count, w 8."""
    x = _spectrum(3, n, seed=n)
    rt_j, rt = _regs(8, rank)
    rt_j = dataclasses.replace(rt_j, cfar_fft_size=jnp.asarray(n, jnp.int32))
    rt = dataclasses.replace(rt, cfar_fft_size=n)
    r = kcfar.gos_registers(rt, T.CfarConfig(max_fft_size=n, **SMALL), n)
    mag = logmag(T.as_pair(x), rt.mag_mode).numpy().astype(np.float32)
    thr, pk = _c_emulated(mag, r)
    cfg_j = R.CfarConfig(max_fft_size=n, **SMALL)
    got_j = fused_mag_gos_cfar(R.as_pair(x), rt_j, cfg_j, interpret=True)
    want = np.asarray(got_j.threshold)
    assert np.abs(thr - want).max() / np.abs(want).max() < 1e-5
    np.testing.assert_array_equal(pk, np.asarray(got_j.peaks))


# ---- Kernel G beyond N = 1024: the mid-size route and the split tail ----

def _g_rows(mag, n, hi):
    """The rows G's selection reads, [rows, span + 2 PAD] by cell, with
    each row's first frame cell (org) and frame: a frame's row at L <= 13,
    its halves at 16384, the split tail's tiles beyond."""
    frames = mag.shape[0]
    padded = np.zeros((frames, PAD + n + PAD), np.int64)
    padded[:, PAD:PAD + n] = np.where(np.arange(n) < hi, mag, 0)
    span = min(n, HALF) if n <= 2 * HALF else TILE
    orgs = range(0, n, span)
    cells = np.stack([padded[f, o:o + span + 2 * PAD] for f in range(frames)
                      for o in orgs])
    return cells, [(f, o) for f in range(frames) for o in orgs], span


def _g_emulated(mag, r, n):
    """Kernel G's selection and tail at N > 1024 over the magnitudes [F, n]:
    frame pairs over a block's rows at 2048 and 4096, run pairs over each
    row at 8192 and 16384 (32 warps) and each tile of the split tail (8
    warps); (threshold int32, peaks)."""
    frames = mag.shape[0]
    w, g, hi = 1 << r.log2w, r.guard, r.n_active
    cells, owner, span = _g_rows(mag, n, hi)
    s_lo, s_hi = PAD - g - w, PAD + span + g + 1
    warps, live = [], np.ones(len(cells), bool)
    per_block = HALF // n if n < HALF else 1
    if per_block > 1:
        rows_to = -(-frames // per_block) * per_block   # dead frames' rows
        cells = np.concatenate([cells, np.zeros((rows_to - frames,
                                                 cells.shape[1]), np.int64)])
        live = np.arange(rows_to) < frames
        for b0 in range(0, rows_to, per_block):
            warps += _frame_pair_warps(b0, min(per_block, frames - b0), s_lo,
                                       s_hi - s_lo, 32, PAD, PAD + hi)
    else:
        for row, (_, org) in enumerate(owner):
            warps += _run_pair_warps(row, s_lo, s_hi,
                                     32 if n <= 2 * HALF else 8,
                                     PAD - org, PAD - org + hi, w)
    # the rows' own active ranges differ (org); check row by row
    st = np.full((2,) + cells.shape, POISON, np.int64)
    writes = np.zeros(st.shape, np.int64)
    _pair_select(cells, st, writes, warps, w, r.rank_lagg, r.rank_lead,
                 INT_TOP)
    thr = np.zeros((frames, n), np.int64)
    pk = np.zeros((frames, n), bool)
    k = PAD + np.arange(span)
    for row, (f, org) in enumerate(owner):
        for side, rank in ((0, r.rank_lagg), (1, r.rank_lead)):
            np.testing.assert_array_equal(
                writes[side, row], (np.arange(cells.shape[1]) >= s_lo)
                & (np.arange(cells.shape[1]) < s_hi))
            np.testing.assert_array_equal(
                st[side, row, s_lo:s_hi],
                _direct(cells[row:row + 1], s_lo, s_hi, w, PAD - org,
                        PAD - org + hi, rank, INT_TOP)[0])
        s_lag, s_lead = st[0, row, k - g - w], st[1, row, k + g + 1]
        noise = (np.maximum(s_lag, s_lead) if r.cfar_mode == 1
                 else np.minimum(s_lag, s_lead) if r.cfar_mode == 2
                 else _w32(s_lag + s_lead) >> 1)
        t = (_w32(_w32(noise * r.scaler_q) + 32) >> 6
             if r.log_or_linear == 1 else _w32(noise + r.scaler_add))
        i = org + np.arange(span)
        m = cells[row, k]
        p = m > t
        if r.peak_grouping == 1:
            left = np.where(i >= 1, cells[row, k - 1], TB.PEAK_EDGE)
            right = np.where(i + 1 < hi, cells[row, k + 1], TB.PEAK_EDGE)
            p &= (m >= left) & (m >= right)
        thr[f, org:org + span] = np.where(i < hi, t, 0)
        pk[f, org:org + span] = p & (i < hi)
    assert (writes[:, ~live] == 0).all()
    return thr.astype(np.int32), pk


G_FRAMES = {2048: 3, 4096: 3, 8192: 2, 16384: 1, 32768: 1}


@functools.lru_cache(maxsize=None)
def _g_input(n, saturated):
    """Seeded integer frames of n and the plain FFT's spectrum: samples of
    +-32767 through seven expanding stages where ``saturated`` (the square
    sums saturate in a tenth or more of the cells), else the bench's
    flags."""
    rng = np.random.RandomState(n + saturated)
    if saturated:
        re, im = (32767 * rng.choice([-1, 1], (G_FRAMES[n], n))
                  .astype(np.int32) for _ in range(2))
    else:
        re, im = (rng.randint(-20000, 20001, (G_FRAMES[n], n))
                  .astype(np.int32) for _ in range(2))
    el, km = _masks(n, expand=tuple(range(7 if saturated else 0)))
    fft_t = T.FftConfig(max_size=n, expand_logic=el, keep_msb_or_lsb=km)
    x = T.C(torch.from_numpy(re), torch.from_numpy(im))
    return x, fft_t, TB.fft_int_op(x, None, fft_t)


def _kernel(n):
    """The route of G at N = n beyond 1024, as ``_run_cut`` names it."""
    return "split" if n > 2 * HALF else "mid"


@pytest.mark.parametrize("n", list(G_FRAMES))
@pytest.mark.parametrize("w", WINDOWS)
def test_the_run_boundary_cuts_start_the_fourth_run(n, w):
    """The CFAR size at which the card tests (``_run_cut``) and
    ``chip_smoke.py`` (``run_boundary``) end the active range is the one
    whose first inactive cell starts the fourth run of window starts of the
    emulated schedule: frame pairs over the first row pair at 2048 and
    4096, run pairs (warp 1, half 1) over the one row at 8192, the second
    half-frame at 16384 and the split tail's second tile. Their registers
    are the emulation's window, guard and ranks."""
    g = max(1, max(w, 2) // 8) if w > 1 else 0
    s_lo = PAD - g - w
    if n in (2048, 4096):
        warp, pair, start, _ = _frame_pairs(
            HALF // n, s_lo, n + 2 * g + w + 1, 32)[3]
        assert (warp, pair) == (3, 0)
        org = 0
    else:
        span, warps, org = ((TILE, 8, TILE) if n > 2 * HALF
                            else (HALF, 32, HALF if n == 2 * HALF else 0))
        per, firsts = _run_pairs(s_lo, PAD + span + g + 1, warps)
        start = firsts[1][1] + per
    cut = org + start - PAD
    assert _run_cut(n, w, g, _kernel(n)) == cut
    assert chip_smoke.run_boundary(n, w, g) == cut
    for rank in RANKS:
        _, rt = _regs(w, rank, n)
        k = 0 if rank == "0" else w - 1
        for other in (_pair_rt(n, w, rank),
                      chip_smoke.pair_registers(n, w, k)):
            assert [int(getattr(other, f)) for f in REG_FIELDS] == \
                [int(getattr(rt, f)) for f in REG_FIELDS]


# (n, w, rank, case): every window and rank at each N; the active range
# ending at a run boundary and saturated magnitudes at every window and rank
# at 2048, at w 1, 8, 32 and the rank w - 1 beyond
G_CASES = [(n, w, rank, "plain") for n in G_FRAMES for w in WINDOWS
           for rank in RANKS] + [
    (n, w, rank, case)
    for case in ("cut at a run boundary", "SQR saturated") for n in G_FRAMES
    for w in (WINDOWS if n == 2048 else [1, 8, 32])
    for rank in (RANKS if n == 2048 else ["w - 1"])]


@pytest.mark.parametrize("n, w, rank, case", G_CASES)
def test_the_emulated_g_pairs_equal_chain_int_gos(n, w, rank, case):
    """Kernel G at N = 2048 ... 32768: three frames at 2048 and 4096 (a
    block's dead rows and a dead half), the active range ending at a run
    boundary, or magnitudes saturated at INT32_MAX, the padding's value;
    bit-equal to the plain version."""
    g = max(1, max(w, 2) // 8) if w > 1 else 0
    kw = dict(mag_mode=1) if case == "SQR saturated" else {}
    _, rt = _regs(w, rank, n, cfar_mode=WINDOWS.index(w) % 3, **kw)
    cut = _run_cut(n, w, g, _kernel(n)) if case.startswith("cut") else n
    rt = dataclasses.replace(rt, cfar_fft_size=cut)
    cfg = T.CfarConfig(max_fft_size=n)
    x, fft_t, spec = _g_input(n, case == "SQR saturated")
    r = kint.int_registers(rt, cfg, n)
    assert (1 << r.log2w, r.guard, r.n_active) == (w, g, cut)
    mag = TB.mag_int_op(spec, rt.mag_mode).numpy().astype(np.int64)
    if case == "SQR saturated":
        assert (mag == INT_TOP).mean() > 0.1
    thr, pk = _g_emulated(mag, r, n)
    want = kint.chain_int_gos_reference(x, rt, fft_t, cfg)
    np.testing.assert_array_equal(thr, want.threshold.numpy())
    np.testing.assert_array_equal(pk, want.peaks.numpy())


def test_the_emulated_g_pairs_equal_the_jax_kernel():
    """One point against the JAX ``fused_chain_int_gos`` in interpret mode:
    N = 2048, three frames (frame pairs with a dead half), w 8, ranks
    w - 1 / 0."""
    n = 2048
    rt_j, rt = _regs(8, "w - 1", n)
    cfg = T.CfarConfig(max_fft_size=n, **SMALL)
    x, fft_t, spec = _g_input(n, False)
    r = kint.int_registers(rt, cfg, n)
    thr, pk = _g_emulated(TB.mag_int_op(spec, rt.mag_mode).numpy()
                          .astype(np.int64), r, n)
    cfg_j = R.ChainConfig(fft=R.FftConfig(max_size=n),
                          cfar=R.CfarConfig(max_fft_size=n, **SMALL))
    got_j = jax.jit(lambda v, rr: fused_chain_int_gos(
        v, rr, cfg_j.fft, cfg_j.cfar, interpret=True))(
        JC(jnp.asarray(x.re.numpy()), jnp.asarray(x.im.numpy())), rt_j)
    np.testing.assert_array_equal(thr, np.asarray(got_j.threshold))
    np.testing.assert_array_equal(pk, np.asarray(got_j.peaks))
    assert pk.any()
