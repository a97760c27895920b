"""The mid-size route of Kernels F and G (``csrc/int_mid.cu``) for frames of
N = 2^L = 2048 ... 16384 on the CPU, through a numpy emulation of its one
launch: which cells each thread holds, the butterflies, flags and twiddles
it applies to them, where each bin's magnitude lands, and what each tail
reads.

* Front: a block of 1024 threads holds 8192 cells, 8 a thread, on the split
  route's body (``rsp_split_passes``). At L <= 13 the block holds 2^d whole
  frames (d = 13 - L, a part-filled last block's dead frames zero); the
  first pass skips d stages, so every butterfly pairs two cells of one
  frame, and the masks come shifted left by d. At L = 14 two blocks of a
  cluster hold a frame: each reads both halves, runs DIF stage 0 on them
  and keeps its own output (the sums, the differences), then the body on
  it at s = 1. The
  emulated FFT (int64 wrapped to int32 as the kernel's ``uint32_t``
  arithmetic wraps) is bit-equal to the port's ``fft_int_op`` at each size
  with the bench's flags, expanding and keepLSB stages (stage 0 among
  them) and full-scale frames through seven expanding stages.
* Rows: slot k of thread m holds cell 8 m + k, whose bin is its bit
  reversal over L bits (at L = 14 the half's cell q is bin 2 bitrev_13(q) +
  r); each magnitude lands at its bin in its frame's padded row, zeros at
  and beyond n_active and outside the frame. At L = 14 each block writes
  every bin it holds into each of the two rows that span it: every row
  cell is written once, the margins outside the frame by their owner.
* Tail: F's run sums, 16 cells a thread, and G's rank statistics, the
  block's 32 warps on two windows a warp at w <= 32 (frame pairs over 4 or
  2 rows, run pairs over one), their runs covering each row's window starts
  once. The emulated chain equals ``chain_int_reference`` and
  ``chain_int_gos_reference`` over register points at every size, and the
  JAX integer ops (jitted, on the CPU) on the same seeded frames.
* Shared memory: the exchanges free of bank conflicts at every size, the
  magnitude stores at most two-way (four at the pair's), F's run-sum reads
  and G's reads of its rows copied by cell free; the planes, G's
  statistic rows and rows by cell, and the magnitude rows fit a block.
* The wrapper's route by N: the row plan up to 1024, ``rsp_int_mid`` from
  2048 to 16384 (``chain_int_mid``, ``chain_int_gos_mid``), the split route
  beyond.

Inputs are seeded numpy arrays."""

import jax
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.ops import bit_true as JB

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.convert import runtime_from_reference
from rsp_chains_tpu_torch.kernels import cfar as kcfar
from rsp_chains_tpu_torch.kernels import int_chain as kint
from rsp_chains_tpu_torch.ops import bit_true as TB
from test_torch_chain_rows import (
    _butterfly, _int_frames, _masks, _side_sums, _w32,
)
from test_torch_int_split import (
    CELLS, SMEM_MAX, SUB_LOG2, _body_bins, _body_fft, _body_passes, _brevs,
    _flags, _rank, _split_slot, _stages,
)

MID = [2048, 4096, 8192, 16384]
THREADS = (1 << SUB_LOG2) // CELLS     # 1024
HALF = 1 << SUB_LOG2                   # a pair's half frame, 8192 cells
PAD = kcfar.PAD
CPU = torch.device("cpu")
# frames a test drives: a part-filled last block at 2048 (4 frames a block)
# and 4096 (2)
FRAMES = {2048: 3, 4096: 3, 8192: 1, 16384: 1}


def _log2(n):
    return n.bit_length() - 1


def _pair(n):
    return n > HALF


def _per_block(n):
    """Frames a block, 1 for the pair (a frame a cluster of two)."""
    return 1 if _pair(n) else HALF // n


def _span(n):
    """Cells of a magnitude row's own span: a frame, or the pair's half."""
    return HALF if _pair(n) else n


def _mag_slot(i):
    """``rsp_mag_slot``: one word of padding in 16."""
    return i + (i >> 4)


def _mag_words(n_cells):
    """``rsp_mag_floats``."""
    return (n_cells + 2 * PAD) // 16 * 17 + 16


def _plan_words(n):
    """``RspMidPlan<L>``: (the FFT's words, a row by cell, the front's
    words, a magnitude row's words, all words). G's rows by cell and its
    statistic rows lie kStatP = a row by cell + 16 words apart."""
    rows = _per_block(n)
    stat = _span(n) + 2 * PAD
    fft = 2 * HALF                            # the planes
    front = max(fft, 3 * rows * (stat + 16))  # or G's statistics and cells
    row = _mag_words(_span(n))
    return fft, stat, front, row, front + rows * row


# ---- the front ----

def _skip_body(y, d, em, lm, tw):
    """``rsp_split_passes<0, d>`` over blocks [B, 8192]: the first pass
    skips d stages; ``em``/``lm`` the masks shifted left by d."""
    grown, s0 = False, 0
    for p, (stages, stride, base) in enumerate(_body_passes()):
        skip = d if p == 0 else 0
        held = base[:, None] + stride * np.arange(CELLS)
        xr, xi = y[0][:, held], y[1][:, held]
        grown = _stages(xr, xi, base, stride, s0 + skip, stages - skip, tw,
                        em, lm, grown)
        y[0][:, held], y[1][:, held] = xr, xi
        s0 += stages
    assert s0 == SUB_LOG2
    return y


def _front(re, im, n, em, lm):
    """``rsp_int_mid_kernel``'s FFT over frames [F, n]: the spectrum in
    natural bin order, [F, n] each (int64 holding int32)."""
    tw = kint._int_twiddles(n, CPU).numpy().astype(np.int64)
    log2n = _log2(n)
    x = [re.astype(np.int64), im.astype(np.int64)]
    frames = re.shape[0]
    if _pair(n):
        # each block reads both halves and runs stage 0 on them
        expanding, lsb = _flags(em, lm, 0)
        w = tw[HALF + np.arange(HALF)]
        ar, ai, br, bi = _butterfly(x[0][:, :HALF], x[1][:, :HALF],
                                    x[0][:, HALF:], x[1][:, HALF:], w[:, 0],
                                    w[:, 1], expanding, lsb, expanding)
        y = _body_fft([np.concatenate([ar, br], 1),
                       np.concatenate([ai, bi], 1)], n, em, lm, tw)
        out = [np.empty((frames, n), np.int64) for _ in range(2)]
        for o, v in zip(out, y):
            o[:, _body_bins(n)] = v           # half r's cell q: 2 brev(q) + r
        return out
    d = SUB_LOG2 - log2n
    per = 1 << d
    blocks = -(-frames // per)
    y = []
    for v in x:                                # dead frames load zeros
        b = np.zeros((blocks * per, n), np.int64)
        b[:frames] = v
        y.append(b.reshape(blocks, HALF))
    y = _skip_body(y, d, em << d, lm << d, tw)
    rev = _brevs(np.arange(n), log2n)
    out = []
    for v in y:
        nat = np.empty((blocks * per, n), np.int64)
        nat[:, rev] = v.reshape(blocks * per, n)   # cell q holds bin brev(q)
        out.append(nat[:frames])
    return out


# stage flags: (expanding stages, keepLSB stages) as functions of L, and the
# frames' amplitude
FRONT_CASES = {
    "bench flags": (lambda L: dict(), 30000),
    "expanding from stage 0": (lambda L: dict(expand=(0, 1, 2, 3)), 30000),
    "keepLSB at stage 0 and late": (
        lambda L: dict(lsb=(0, 4, L - 2)), 30000),
    "expanding and keepLSB at the passes' seams": (
        lambda L: dict(expand=(1, L - 10, L - 4), lsb=(2, L - 7, L - 1)),
        30000),
    "full scale, seven expanding": (
        lambda L: dict(expand=tuple(range(7))), 32767),
}


@pytest.mark.parametrize("n", MID)
@pytest.mark.parametrize("case", list(FRONT_CASES))
def test_the_mid_front_is_bit_equal_to_fft_int_op(n, case):
    masks, amp = FRONT_CASES[case]
    el, km = _masks(n, **masks(_log2(n)))
    re, im = _int_frames(n, n % 983 + len(case), amp, frames=FRAMES[n])
    fft_t = T.FftConfig(max_size=n, expand_logic=el, keep_msb_or_lsb=km)
    got_re, got_im = _front(re, im, n, *kint.fft_masks(fft_t, n))
    want = TB.fft_int_op(T.C(torch.from_numpy(re), torch.from_numpy(im)),
                         None, fft_t)
    np.testing.assert_array_equal(got_re, want.re.numpy())
    np.testing.assert_array_equal(got_im, want.im.numpy())


@pytest.mark.parametrize("n", MID)
def test_each_butterfly_pairs_two_cells_of_one_frame_at_its_stage(n):
    """At L <= 13 the first pass's stages pair cells of one frame, and body
    stage t is each frame's stage t - d (pair distance N >> (s + 1)); the
    frames' stages run 0 .. L-1 once each. At L = 14 stage 0 pairs cell q
    of the first half with q of the second (twiddle row 8192 + q), then the
    halves' body stages are the frame's 1 .. 13."""
    log2n = _log2(n)
    d = SUB_LOG2 - log2n
    stages_seen = [0] if _pair(n) else []
    for p, (stages, stride, base) in enumerate(_body_passes()):
        skip = d if p == 0 and d > 0 else 0
        held = base[:, None] + stride * np.arange(CELLS)
        p0 = sum(s for s, _, _ in _body_passes()[:p])
        for l in range(stages - skip):
            hs = (1 << (stages - skip - 1)) >> l
            t = p0 + skip + l                       # the body stage
            qs = np.array([q for q in range(CELLS) if not q & hs])
            a, b = held[:, qs], held[:, qs + hs]
            assert np.all(b - a == 1 << (SUB_LOG2 - 1 - t))
            if not _pair(n):
                assert np.array_equal(a >> log2n, b >> log2n)  # one frame
            s = t - d if not _pair(n) else t + 1     # the frame's stage
            assert b[0, 0] - a[0, 0] == n >> (s + 1)
            stages_seen.append(s)
    assert stages_seen == list(range(log2n))


# ---- the rows and the tail ----

def _rows(mag, n):
    """The magnitude rows the launch leaves in shared memory, [F, rows a
    frame, span + 2 PAD] by row cell (``mag`` natural, zero at and beyond
    n_active): a frame's row with zero margins; at L = 14 the two halves'
    rows as the blocks' writes fill them, every cell written once."""
    frames = mag.shape[0]
    if not _pair(n):
        row = np.zeros((frames, 1, n + 2 * PAD), np.int64)
        row[:, 0, PAD:PAD + n] = mag
        return row
    rows = np.full((frames, 2, HALF + 2 * PAD), -1, np.int64)
    writes = np.zeros((2, HALF + 2 * PAD), np.int64)
    rows[:, 0, :PAD] = 0                    # the owners' outer margins
    rows[:, 1, PAD + HALF:] = 0
    writes[0, :PAD] += 1
    writes[1, PAD + HALF:] += 1
    for rank in (0, 1):                     # block rank's cells q
        b = (_brevs(np.arange(HALF), SUB_LOG2) << 1) | rank
        for t, keep in ((0, b < HALF + PAD), (1, b >= HALF - PAD)):
            j = PAD + b[keep] - t * HALF
            rows[:, t, j] = mag[:, b[keep]]
            writes[t, j] += 1
    assert (writes == 1).all() and (rows >= 0).all()
    return rows


def _row_tail(row, r, org):
    """Threshold and peaks of a row's span ([F, S + 2 PAD], row cell j the
    frame's cell org - PAD + j): F's run sums (``rsp_int_ca_runs``, 16 cells
    a run) or, with the algorithm register at 1, G's rank statistics of the
    active cells."""
    span = row.shape[-1] - 2 * PAD
    w, g, hi = 1 << r.log2w, r.guard, r.n_active
    j = np.arange(span)
    k, i = PAD + j, org + j
    if r.algorithm == 1:
        c = org - PAD + np.arange(span + 2 * PAD)
        sides = []
        for first, rank in ((k - g - w, r.rank_lagg),
                            (k + g + 1, r.rank_lead)):
            idx = first[:, None] + np.arange(w)
            valid = (c[idx] >= 0) & (c[idx] < hi)
            sides.append(_rank(row[:, idx], valid, rank))
        s_lag, s_lead = sides
    else:
        lag, lead = _side_sums(row.astype(np.uint32), span, w, g)
        s_lag, s_lead = (v.astype(np.int32).astype(np.int64) >> r.div_sum
                         for v in (lag, lead))
    noise = (np.maximum(s_lag, s_lead) if r.cfar_mode == 1
             else np.minimum(s_lag, s_lead) if r.cfar_mode == 2
             else _w32(s_lag + s_lead) >> 1)
    t = (_w32(_w32(noise * r.scaler_q) + 32) >> 6 if r.log_or_linear == 1
         else _w32(noise + r.scaler_add))
    m = row[:, k]
    p = m > t
    if r.peak_grouping == 1:
        left = np.where(i >= 1, row[:, k - 1], TB.PEAK_EDGE)
        right = np.where(i + 1 < hi, row[:, k + 1], TB.PEAK_EDGE)
        p &= (m >= left) & (m >= right)
    on = i < hi
    return np.where(on, t, 0).astype(np.int32), p & on


def _emulated(re, im, n, fft_t, rt, cfar_t, gos):
    """The launch over frames [F, n]: (threshold int32, peaks)."""
    r = kint.int_registers(rt, cfar_t, n)
    if not gos:
        r.algorithm = 0                     # chain_int's launch
    sr, si = _front(re, im, n, *kint.fft_masks(fft_t, n))
    mag = TB.mag_int_op(T.C(torch.from_numpy(sr.astype(np.int32)),
                            torch.from_numpy(si.astype(np.int32))),
                        rt.mag_mode).numpy().astype(np.int64)
    mag = np.where(np.arange(n) < r.n_active, mag, 0)
    rows = _rows(mag, n)
    outs = [_row_tail(rows[:, t], r, t * _span(n))
            for t in range(rows.shape[1])]
    return (np.concatenate([o[0] for o in outs], -1),
            np.concatenate([o[1] for o in outs], -1))


# (name, registers over the bench's, elaboration); cut: n_active n - 300
CHAIN_POINTS = [
    ("F CA JPL", dict(), "ca"),
    ("F GO grouping w64 g8, cut", dict(
        cfar_mode=1, peak_grouping=1, ref_window_size=64, guard_window_size=8,
        div_sum=6, mag_mode=0, threshold_scaler=1.5, cut=True), "ca"),
    ("F SQR overflow, SO", dict(
        mag_mode=1, div_sum=0, threshold_scaler=64.0, cfar_mode=2), "ca"),
    ("G GOS ranks 8/24", dict(
        cfar_algorithm=1, index_lagg=8, index_lead=24), "gos"),
    ("G GOS w64 rank 63, cut, grouping, SQR", dict(
        cfar_algorithm=1, ref_window_size=64, guard_window_size=8,
        index_lagg=63, index_lead=5, peak_grouping=1, mag_mode=1,
        cut=True), "gos"),
    ("G algorithm 0, GO, log domain", dict(
        cfar_algorithm=0, cfar_mode=1, log_or_linear=0, threshold_scaler=8.0),
     "gos"),
]


def _point(n, regs, kind):
    """(the port's RuntimeConfig, the JAX one, the port's and JAX's
    CfarConfig) of a chain point at frames of n."""
    regs = dict(regs)
    if regs.pop("cut", False):
        regs["cfar_fft_size"] = n - 300
    make = {"fft_size": n, "ref_window_size": 32, "guard_window_size": 4,
            "div_sum": 5, "threshold_scaler": 3.5, **regs}
    rt_j = R.RuntimeConfig.make(**make)
    ca = kind == "ca"
    cfar_t = T.CfarConfig(max_ref_window=64,
                          variant=T.CfarVariant.CA if ca
                          else T.CfarVariant.GOSCA,
                          include_cash=not ca, max_fft_size=n)
    cfar_j = R.CfarConfig(max_ref_window=64,
                          variant=R.CfarVariant.CA if ca
                          else R.CfarVariant.GOSCA,
                          include_cash=not ca, max_fft_size=n)
    return runtime_from_reference(rt_j.peek()), rt_j, cfar_t, cfar_j


@pytest.mark.parametrize("n", MID)
@pytest.mark.parametrize("name, regs, kind", CHAIN_POINTS)
def test_the_emulated_mid_chain_equals_the_plain_versions(n, name, regs,
                                                          kind):
    rt, _, cfar_t, _ = _point(n, regs, kind)
    el, km = _masks(n, expand=(0, 1, 9))
    fft_t = T.FftConfig(max_size=n, expand_logic=el, keep_msb_or_lsb=km)
    amp = 32767 if "SQR overflow" in name else 12000
    re, im = _int_frames(n, n % 991 + len(name), amp, frames=FRAMES[n])
    thr, pk = _emulated(re, im, n, fft_t, rt, cfar_t, kind == "gos")
    x = T.C(torch.from_numpy(re), torch.from_numpy(im))
    ref = (kint.chain_int_reference if kind == "ca"
           else kint.chain_int_gos_reference)
    want = ref(x, rt, fft_t, cfar_t)
    np.testing.assert_array_equal(thr, want.threshold.numpy())
    np.testing.assert_array_equal(pk, want.peaks.numpy())
    assert pk.any()
    if "SQR overflow" in name:
        assert (thr < 0).any()              # the sums and products wrap


@pytest.mark.parametrize("n, name", [
    (2048, "F GO grouping w64 g8, cut"),
    (16384, "G GOS w64 rank 63, cut, grouping, SQR"),
])
def test_the_emulated_mid_chain_equals_the_jax_integer_ops(n, name):
    """The same frames through the JAX integer ops (jitted), with expanding
    and keepLSB stages, stage 0 among them."""
    _, regs, kind = next(p for p in CHAIN_POINTS if p[0] == name)
    rt, rt_j, cfar_t, cfar_j = _point(n, regs, kind)
    masks = dict(expand=(0, 5, 9), lsb=(1, _log2(n) - 1))
    el, km = _masks(n, **masks)
    re, im = _int_frames(n, n % 887, 16000, frames=FRAMES[n])
    fft_t = T.FftConfig(max_size=n, expand_logic=el, keep_msb_or_lsb=km)
    fft_j = R.FftConfig(max_size=n, expand_logic=el, keep_msb_or_lsb=km)
    thr, pk = _emulated(re, im, n, fft_t, rt, cfar_t, kind == "gos")
    tail = JB.ca_cfar_int if kind == "ca" else JB.cfar_int
    want = jax.jit(lambda x, r: tail(JB.mag_int_op(
        JB.fft_int_op(x, None, fft_j), r.mag_mode), r, cfar_j))(
        R.as_pair(re + 1j * im), rt_j)
    np.testing.assert_array_equal(thr, np.asarray(want.threshold))
    np.testing.assert_array_equal(pk, np.asarray(want.peaks))
    assert pk.any()


@pytest.mark.parametrize("n", MID)
@pytest.mark.parametrize("w, g", [(1, 0), (2, 1), (8, 2), (16, 2), (32, 4),
                                  (64, 8)])
def test_g_warps_cover_each_rows_window_starts_once(n, w, g):
    """G's selection over a block's rows [PAD - g - w, PAD + span + g + 1)
    by the schedules of ``csrc/gos_cfar.cuh``: at w <= 32 frame pairs where
    the block holds 4 or 2 rows (``rsp_gos_row_pairs``: the pairs' starts
    cut into 32 equal runs, both halves of a warp on one run of two rows
    kStatP words apart, an odd multiple of 16) and run pairs over its one
    row at 8192 and 16384 (``rsp_gos_stats``: two runs a warp of one odd
    length, half h of warp k on run 2k + h); at w = 64 a row's starts in
    runs, one a warp. Every live row's starts are covered once, at every
    live row count, and every window stays inside its row."""
    rows, span = _per_block(n), _span(n)
    s_lo, s_hi = PAD - g - w, PAD + span + g + 1
    length = s_hi - s_lo
    stat_p = _plan_words(n)[1] + 16
    assert stat_p % 32 == 16
    for live in range(1, rows + 1):
        seen = np.zeros((rows + 1, s_hi), np.int64)
        if rows == 1 and w <= 32:
            per = -(-length // 64) | 1
            for k in range(32):
                for h in (0, 1):
                    a = s_lo + (2 * k + h) * per
                    seen[0, max(a, 0):max(min(a + per, s_hi), 0)] += 1
        else:
            pairs = w <= 32
            units = (live + 1) // 2 if pairs else live
            per = -(-units * length // 32)
            for warp in range(32):
                u, end = warp * per, min(warp * per + per, units * length)
                while u < end:
                    p = u // length
                    v = min(end, (p + 1) * length)
                    a, b = s_lo + u - p * length, s_lo + v - p * length
                    for f in ((2 * p, 2 * p + 1) if pairs else (p,)):
                        seen[f, a:b] += f < live
                    u = v
        assert (seen[:live, s_lo:] == 1).all() and not seen[live:].any()
        assert not seen[:, :s_lo].any()
    assert s_lo >= 0 and s_hi - 1 + w <= span + 2 * PAD


# ---- shared memory ----

def _worst(address):
    """The most distinct words of one bank that one warp's access touches,
    over the block's warps and the accesses ``address(lanes, k)``, k < 8."""
    worst = 0
    for warp in range(THREADS // 32):
        lanes = np.arange(32 * warp, 32 * warp + 32)
        for k in range(CELLS):
            a = np.unique(address(lanes, k))
            worst = max(worst, np.bincount(a % 32).max())
    return worst


@pytest.mark.parametrize("n", MID)
def test_the_exchanges_are_conflict_free_and_the_stores_fit(n):
    """The body's exchanges (``rsp_split_slot``) at every pass are free of
    bank conflicts at every size; each thread's magnitude stores at its
    bins (``rsp_mag_slot``) are at most two-way, four-way at the pair's
    writes into either row; F's run-sum reads (16 cells a thread) are free;
    G's copy of its rows by cell reads them two-way and writes them free,
    and its reads of them and of its statistic rows are free; the rows sit
    past the planes and the statistic rows, and the whole fits a block's
    shared memory."""
    for stages, stride, base in _body_passes()[:-1]:
        slots = _split_slot(base[:, None] + stride * np.arange(CELLS))
        assert _worst(lambda m, k: slots[m, k]) == 1
    log2n = _log2(n)
    fft, stat, front, row, words = _plan_words(n)

    def store(rank, t):
        def at(m, k):
            p = CELLS * m + k
            if not _pair(n):
                b = _brevs(p & (n - 1), log2n)
                return (p >> log2n) * row + _mag_slot(PAD + b)
            b = (_brevs(p, SUB_LOG2) << 1) | rank
            return _mag_slot(PAD + b - t * HALF)
        return at

    worst = max(_worst(store(rank, t)) for rank in (0, 1) for t in (0, 1)) \
        if _pair(n) else _worst(store(0, 0))
    assert worst <= (4 if _pair(n) else 2 if log2n != 12 else 1)
    # F: thread m reads the cells 16 m + c of its row, any offset c (a
    # warp's 32 threads lie in one row)
    for c in (-72, -1, 0, 5, 15, 16, 88):
        assert _worst(lambda m, k: _mag_slot(PAD + 16 * m + c)) == 1
    # G: the copy reads 32 consecutive cells a warp across one word of
    # padding and writes them unpadded, each row kStatP = stat + 16 words
    # past the last, as the output loop reads them
    assert _worst(lambda m, k: _mag_slot(m + THREADS * k)) == 2
    assert _worst(lambda m, k: (m + THREADS * k)
                  + 16 * ((m + THREADS * k) // stat)) == 1
    assert front >= fft and front >= 3 * _per_block(n) * (stat + 16)
    assert _mag_slot(stat - 1) < row
    assert words * 4 <= SMEM_MAX


# ---- the route by N ----

@pytest.mark.parametrize("gos", [False, True])
def test_the_wrapper_routes_by_n(gos, monkeypatch):
    """``_route`` (the CUDA branch of ``chain_int`` / ``chain_int_gos``)
    takes the row plan at 256-1024, ``rsp_int_mid`` at 2048-16384 and the
    split route beyond, each counted under its own name."""
    taken = []
    monkeypatch.setattr(kint, "_int_kernel", lambda name, symbol, *a:
                        taken.append((name, symbol)))
    monkeypatch.setattr(kint, "_split_kernel", lambda name, *a:
                        taken.append((name, "rsp_int_split")))
    g = "_gos" if gos else ""
    for n in (256, 1024, 2048, 4096, 8192, 16384, 32768):
        x = T.C(torch.zeros(1, n, dtype=torch.int32),
                torch.zeros(1, n, dtype=torch.int32))
        kint._route(x, kint.IntRegs(), T.FftConfig(max_size=n), gos)
    assert taken == (
        [(f"chain_int{g}", f"rsp_chain_int{g}_rows")] * 2
        + [(f"chain_int{g}_mid", "rsp_int_mid")] * 4
        + [(f"chain_int{g}_split", "rsp_int_split")])
