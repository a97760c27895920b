"""The split route of Kernels F and G (``csrc/int_split.cu``) for frames of
N = 2^L > 16384 on the CPU, through a numpy emulation of its three launches:
which cells each thread or block holds, the butterflies, flags and twiddles
it applies to them, where each bin's magnitude lands, and what each tail
tile reads.

* Head: under DIF stages 0 .. s-1 (s = L - 13) the cells j + t N/2^s form
  closed groups; each launch (up to five stages: one launch up to N = 2^18,
  two at 2^19 and 2^20) covers every cell once, and a butterfly's partner
  lies in its thread's group.
* Body: each sub-frame of 8192 cells runs stages s .. L-1 with the masks
  shifted by s and ``grown`` inherited from the head, on F's register
  passes: 1024 threads of 8 cells, passes of 3 stages at the strides 1024,
  128, 16 and 2, then the last stage across lane pairs. Each pass holds
  every cell in one slot; its exchange through shared memory
  (an XOR swizzle) and the staging of the magnitudes (one word of padding
  in 32) are free of bank conflicts. Cell q of sub-frame b is bin
  bitrev_13(q) 2^s + bitrev_s(b).
* Hand-off: sub-frame b's bin k lands at b 8192 + k up to N = 2^20 (s <= 7),
  at its natural bin beyond. A tail tile of 4096 cells and a 128-cell
  margin either side reads 2^s runs of at least 32 consecutive words up to
  2^20 (natural cells beyond), every row cell once, zeros outside the frame.
* The emulated FFT (head + body, int64 wrapped to int32 as the kernel's
  ``uint32_t`` arithmetic wraps) is bit-equal to the port's ``fft_int_op``
  at N = 2^15, 2^16, 2^18 (one five-stage head launch) and 2^19 (two), with
  expanding and keepLSB stages before and after stage s, and full-scale
  frames through seven expanding stages (the split form of the 1.15
  products).
* Tail: F's run sums over a tile equal the direct wrapping window sums, and
  the tail equals ``ca_cfar_int``, tile seams and a cut active range
  included; the emulated chain equals ``fft_int_op`` -> ``mag_int_op`` ->
  ``ca_cfar_int`` (F) and ``cfar_int`` (G's rank statistics, and its
  algorithm 0) exactly at N = 2^15 and 2^16 over the register points, and
  at 2^18 and 2^19.
* The plain versions, chunked by cells, equal their unchunked selves.

Inputs are seeded numpy arrays."""

import dataclasses

import numpy as np
import pytest
import torch

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.kernels import cfar as kcfar
from rsp_chains_tpu_torch.kernels import int_chain as kint
from rsp_chains_tpu_torch.ops import bit_true as TB
from test_torch_chain_rows import (
    _butterfly, _int_frames, _masks, _side_sums, _w32,
)

SUB_LOG2 = 13       # csrc/int_split.cu RSP_SPLIT_LOG2
CELLS = 8           # RSP_SPLIT_CELLS: the body's cells a thread
HEAD_MAX = 5        # RSP_SPLIT_HEAD
RUNS_MAX = 7        # RSP_SPLIT_RUNS: the largest s whose hand-off is in runs
TILE = 4096         # 1 << RSP_SPLIT_TILE_LOG2
PAD = kcfar.PAD
ROW = TILE + 2 * PAD                        # a tail tile's cells
SMEM_MAX = 227 * 1024                       # a block's shared memory
SMEM_SM = 228 * 1024        # an SM's, 1 KiB of it reserved for each block
CPU = torch.device("cpu")
INT_MAX = 2**31 - 1


def _log2(n):
    return n.bit_length() - 1


def _s(n):
    return _log2(n) - SUB_LOG2


def _brevs(v, bits):
    """Bit reversal of each of ``v`` over ``bits`` bits."""
    v = np.asarray(v, np.int64)
    out = np.zeros_like(v)
    for i in range(bits):
        out |= ((v >> i) & 1) << (bits - 1 - i)
    return out


def _head_launches(n):
    """(t0, stages) of each head launch: up to five stages a launch."""
    s = _s(n)
    return [(t0, min(HEAD_MAX, s - t0)) for t0 in range(0, s, HEAD_MAX)]


def _head_cells(n, t0, k):
    """(lo, the frame cells of each thread's slots [threads, 2^k], stride)
    of the head launch over stages t0 .. t0 + k - 1."""
    log2n = _log2(n)
    sh = log2n - t0 - k
    idx = np.arange(n >> k)
    lo = idx & ((1 << sh) - 1)
    first = ((idx >> sh) << (log2n - t0)) + lo
    return lo, first[:, None] + (np.arange(1 << k) << sh), 1 << sh


def _flags(expand_mask, lsb_mask, s):
    expanding = bool(expand_mask >> s & 1)
    return expanding, not expanding and bool(lsb_mask >> s & 1)


def _stages(xr, xi, base, stride, s0, stages, tw, em, lm, grown):
    """``stages`` DIF stages from s0 on each thread's slots (the last axis;
    slot q at cell base + stride q), pairing slots q and q + hs, hs =
    2^(stages - 1) at the first, in place; returns ``grown``."""
    for l in range(stages):
        hs = (1 << (stages - 1)) >> l
        half = hs * stride
        expanding, lsb = _flags(em, lm, s0 + l)
        grown = grown or expanding
        for q in range(xr.shape[-1]):
            if q & hs:
                continue
            w = tw[half + ((base + stride * q) & (half - 1))]
            xr[..., q], xi[..., q], xr[..., q + hs], xi[..., q + hs] = (
                _butterfly(xr[..., q], xi[..., q], xr[..., q + hs],
                           xi[..., q + hs], w[:, 0], w[:, 1], expanding,
                           lsb, grown))
    return grown


def _head(re, im, n, expand_mask, lsb_mask, tw):
    """``rsp_int_split_head_kernel`` launch by launch over frames [F, n]."""
    x = [re.astype(np.int64).copy(), im.astype(np.int64).copy()]
    for t0, k in _head_launches(n):
        lo, cells, stride = _head_cells(n, t0, k)
        xr, xi = x[0][:, cells], x[1][:, cells]
        _stages(xr, xi, lo, stride, t0, k, tw, expand_mask, lsb_mask,
                bool(expand_mask & ((1 << t0) - 1)))
        x[0][:, cells], x[1][:, cells] = xr, xi
    return x


def _body_passes():
    """``rsp_split_passes<p>`` for each p: (its stages, its stride, thread
    m's first cell), thread m's slot k on the sub-frame cell base + stride
    k inside blocks of 2^(13 - 3 p) cells; then the last stage
    (``rsp_split_last``), which leaves the cells 8 m + k."""
    c = CELLS.bit_length() - 1
    m = np.arange((1 << SUB_LOG2) // CELLS)
    out = []
    for p in range(SUB_LOG2 // c):
        lb = SUB_LOG2 - c * p
        ls = lb - c
        out.append((c, 1 << ls, ((m >> ls) << lb) | (m & ((1 << ls) - 1))))
    assert out[-1][1] == 2 and SUB_LOG2 == c * len(out) + 1
    return out + [(1, 1, CELLS * m)]


def _body_fft(x, n, expand_mask, lsb_mask, tw):
    """``rsp_int_split_body_kernel``'s passes: stages s .. L-1 of each
    sub-frame, the masks shifted by s, ``grown`` inherited; returns the
    planes [F, 2^s, 8192] in the cells' order."""
    s = _s(n)
    y = [v.reshape(v.shape[0], 1 << s, 1 << SUB_LOG2).copy() for v in x]
    grown = bool(expand_mask & ((1 << s) - 1))
    s0 = 0
    for stages, stride, base in _body_passes():
        held = base[:, None] + stride * np.arange(CELLS)
        assert np.array_equal(np.sort(held.ravel()),
                              np.arange(1 << SUB_LOG2))
        xr, xi = y[0][..., held], y[1][..., held]
        grown = _stages(xr, xi, base, stride, s0, stages, tw,
                        expand_mask >> s, lsb_mask >> s, grown)
        y[0][..., held], y[1][..., held] = xr, xi
        s0 += stages
    assert s0 == SUB_LOG2
    return y


def _body_bins(n):
    """The bin of cell q of sub-frame b: [2^s, 8192]."""
    s = _s(n)
    k = _brevs(np.arange(1 << SUB_LOG2), SUB_LOG2)
    return (k[None, :] << s) | _brevs(np.arange(1 << s), s)[:, None]


def _store_offsets(n):
    """Where the body stores sub-frame b's bin k in the frame's magnitude
    scratch (the kernel's address): [2^s, 8192], by k."""
    s = _s(n)
    b = np.arange(1 << s)[:, None]
    k = np.arange(1 << SUB_LOG2)[None, :]
    if s <= RUNS_MAX:
        return (b << SUB_LOG2) + k
    return (k << s) | _brevs(b, s)


def _split_fft(re, im, n, expand_mask, lsb_mask):
    """Head and body: the spectrum in natural bin order, [F, n] each."""
    tw = kint._int_twiddles(n, CPU).numpy().astype(np.int64)
    y = _body_fft(_head(re, im, n, expand_mask, lsb_mask, tw), n,
                  expand_mask, lsb_mask, tw)
    bins = _body_bins(n)
    out = [np.empty((re.shape[0], n), np.int64) for _ in range(2)]
    for o, v in zip(out, y):
        o[:, bins] = v
    return out


def _handoff(sr, si, r, n):
    """The body's magnitude store from the natural spectrum [F, n]:
    ``rsp_int_magnitude`` of each bin, zero at and beyond n_active, staged
    by k and stored at ``_store_offsets``; the frames' scratch [F, n]."""
    mag = TB.mag_int_op(T.C(torch.from_numpy(sr.astype(np.int32)),
                            torch.from_numpy(si.astype(np.int32))),
                        r.mag_mode).numpy().astype(np.int64)
    mag = np.where(np.arange(n) < r.n_active, mag, 0)
    return _store(mag, n)


def _bins_by_k(n):
    """Sub-frame b's bin k: k 2^s + bitrev_s(b), [2^s, 8192]."""
    k = np.arange(1 << SUB_LOG2)[None, :]
    return (k << _s(n)) | _brevs(np.arange(1 << _s(n)), _s(n))[:, None]


def _store(mag, n):
    """Natural-order magnitudes [F, n] at the body's store offsets."""
    buf = np.full(mag.shape, -1, np.int64)
    buf[:, _store_offsets(n)] = mag[:, _bins_by_k(n)]
    assert (buf >= 0).all()
    return buf


def _tail_fill(n, ts):
    """The tail block's reads of the tile at ts, thread slot i < ROW in
    order: (its row index j, the cell c0 + j; the frame scratch offset it
    reads, -1 for a zero outside the frame), as ``rsp_int_split_tail_kernel``
    computes them."""
    s = _s(n)
    i = np.arange(ROW)
    c0 = ts - PAD
    if s <= RUNS_MAX:
        t = (i >> (8 - s)) // (ROW >> 8)               # i // (ROW >> s)
        kk = i - t * (ROW >> s)
        k = (c0 >> s) + kk
        j = (kk << s) | t
        inside = (k >= 0) & (k < 1 << SUB_LOG2)
        return j, np.where(inside, (_brevs(t, s) << SUB_LOG2) + k, -1)
    c = c0 + i
    return i, np.where((c >= 0) & (c < n), c, -1)


def _rank(win, valid, rank):
    """The min(rank, nv-1)-th smallest valid cell of each window, 0 where nv
    is 0 (invalid cells sort as INT32_MAX, as the warp keeps them)."""
    valid = np.broadcast_to(valid, win.shape)
    s = np.sort(np.where(valid, win, INT_MAX), axis=-1)
    nv = valid.sum(-1)
    idx = np.clip(np.minimum(rank, nv - 1), 0, None)
    got = np.take_along_axis(s, idx[..., None], axis=-1)[..., 0]
    return np.where(nv > 0, got, 0)


def _tile_row(buf, n, ts):
    """The tile's row [F, ROW] as the tail's fill leaves it."""
    j, src = _tail_fill(n, ts)
    row = np.zeros((buf.shape[0], ROW), np.int64)
    row[:, j] = np.where(src >= 0, buf[:, np.maximum(src, 0)], 0)
    return row


def _tail(buf, r, n):
    """``rsp_int_split_tail_kernel`` tile by tile over the frames' scratch
    [F, n]: (threshold, peaks). Each tile reads only its row of TILE +
    2 PAD cells; F's sides are the run sums of ``rsp_int_ca_runs``."""
    w, g, hi = 1 << r.log2w, r.guard, r.n_active
    thr = np.zeros(buf.shape, np.int64)
    pk = np.zeros(buf.shape, bool)
    for ts in range(0, n, TILE):
        row = _tile_row(buf, n, ts)
        c = ts - PAD + np.arange(ROW)
        j = np.arange(TILE)
        i, k = ts + j, PAD + j
        if r.algorithm == 1:
            sides = []
            for first, rank in ((k - g - w, r.rank_lagg),
                                (k + g + 1, r.rank_lead)):
                idx = first[:, None] + np.arange(w)
                assert idx.min() >= 0 and idx.max() < ROW
                valid = (c[idx] >= 0) & (c[idx] < hi)
                sides.append(_rank(row[:, idx], valid, rank))
            s_lag, s_lead = sides
        else:
            lag, lead = _side_sums(row.astype(np.uint32), TILE, w, g)
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
        thr[:, ts:ts + TILE] = np.where(on, t, 0)
        pk[:, ts:ts + TILE] = p & on
    return thr.astype(np.int32), pk


@pytest.mark.parametrize("n", [1 << 15, 1 << 16, 1 << 18, 1 << 19, 1 << 20])
def test_the_head_groups_are_closed_and_cover_each_frame_once(n):
    """Each launch's threads hold every cell once, and each stage pairs a
    cell with one of the same thread (i and i + N >> (t + 1), the block of
    2 half starting at a multiple of 2 half); the stages of the launches
    make stages 0 .. s-1, one launch up to N = 2^18 and two at 2^19 and
    2^20, and the twiddle index stays in the table."""
    stages = []
    launches = _head_launches(n)
    assert len(launches) == (1 if n <= 1 << 18 else 2)
    for t0, k in launches:
        lo, cells, stride = _head_cells(n, t0, k)
        assert k <= HEAD_MAX
        assert np.array_equal(np.sort(cells.ravel()), np.arange(n))
        for l in range(k):
            half = n >> (t0 + l + 1)
            hs = ((1 << k) >> 1) >> l
            assert hs * stride == half
            qs = np.array([q for q in range(1 << k) if not q & hs])
            a = cells[:, qs]
            assert np.all((a & half) == 0)            # the 'a' cell
            assert np.array_equal(a + half, cells[:, qs + hs])
            j = (lo[:, None] + stride * qs) & (half - 1)  # the kernel's
            assert np.array_equal(j, a & (half - 1))
            assert (half + j).max() < n
            stages.append(t0 + l)
    assert stages == list(range(_s(n)))


@pytest.mark.parametrize("n", [1 << 15, 1 << 16, 1 << 18, 1 << 21])
def test_the_bin_map_is_the_bit_reversal_of_the_frame(n):
    """Cell q of sub-frame b holds bin brev_L(b 8192 + q); the body's
    store offsets of the bins cover the frame's scratch once: sub-frame
    b's bins contiguous in order of k up to N = 2^20, natural beyond."""
    bins = _body_bins(n)
    p = np.arange(n)
    np.testing.assert_array_equal(bins.ravel(), _brevs(p, _log2(n)))
    off = _store_offsets(n)
    assert np.array_equal(np.sort(off.ravel()), p)
    if _s(n) <= RUNS_MAX:
        np.testing.assert_array_equal(off.ravel(), p)
    else:
        k = np.arange(1 << SUB_LOG2)
        np.testing.assert_array_equal(
            off, (k[None, :] << _s(n)) | _brevs(np.arange(1 << _s(n)),
                                               _s(n))[:, None])


def _worst_conflict(address):
    """The most distinct 4-byte words of one bank that one warp's access of
    one slot k touches, over the body block's warps and slots;
    ``address(m, k)`` the word of thread m (arrays of lanes)."""
    worst = 0
    for warp in range((1 << SUB_LOG2) // CELLS // 32):
        lanes = np.arange(32 * warp, 32 * warp + 32)
        for k in range(CELLS):
            a = np.unique(address(lanes, k))
            worst = max(worst, np.bincount(a % 32).max())
    return worst


def _split_slot(p):
    """``rsp_split_slot``: the low 5 bits XOR-swizzled by bits 5-7."""
    q = p >> 5
    return p ^ ((q & 7) | ((q & 1) << 3) | ((q & 4) << 2))


def _stage_slot(k):
    """``rsp_split_mag_slot``: one word of padding in 32."""
    return k + (k >> 5)


@pytest.mark.parametrize("what", ["pass 0", "pass 1", "pass 2", "pass 3",
                                  "the last stage", "magnitude staging"])
def test_the_body_holds_each_cell_once_and_its_exchanges_are_conflict_free(
        what):
    """Each pass's threads hold the 8192 cells once, its pairs lie in one
    thread, and its reads and writes of the planes (``rsp_split_slot``, a
    bijection) are free of bank conflicts; the last stage's pairs lie in
    the slots k of lanes m and m ^ 1 (``rsp_split_last``), which leave the
    cells 8 m + k; the magnitudes' staging by bin k
    (``rsp_split_mag_slot``) and the store's reads of it are free of bank
    conflicts too; the planes and the staging fit a block's shared
    memory."""
    sub = 1 << SUB_LOG2
    t = sub // CELLS
    passes = _body_passes()
    assert len(passes) == 5 and sum(p[0] for p in passes) == SUB_LOG2
    if what.startswith("pass "):
        p = int(what[5:])
        stages, stride, base = passes[p]
        s0 = sum(q[0] for q in passes[:p])
        held = base[:, None] + stride * np.arange(CELLS)
        assert np.array_equal(np.sort(held.ravel()), np.arange(sub))
        for l in range(stages):
            half = (sub >> (s0 + 1)) >> l
            hs = (1 << (stages - 1)) >> l
            assert hs * stride == half
            qs = np.array([q for q in range(CELLS) if not q & hs])
            assert np.all((held[:, qs] & half) == 0)
            assert np.array_equal(held[:, qs] + half, held[:, qs + hs])
        slots = _split_slot(held)
        assert np.array_equal(np.sort(slots.ravel()), np.arange(sub))
        assert _worst_conflict(lambda m, k: slots[m, k]) == 1
        return
    if what == "the last stage":
        _, stride, base = passes[-2]
        held = base[:, None] + stride * np.arange(CELLS)   # the last pass's
        m = np.arange(0, t, 2)
        assert np.array_equal(held[m] + 1, held[m + 1])    # half 1 apart
        assert np.all(held[m] % 2 == 0)
        h = CELLS // 2
        # the even lane's butterflies k < H, the odd lane's H + k, each as
        # slots 2k (the even cell) and 2k + 1 of its result
        out = np.empty((t, CELLS), np.int64)
        out[m, 0::2], out[m, 1::2] = held[m, :h], held[m + 1, :h]
        out[m + 1, 0::2], out[m + 1, 1::2] = held[m, h:], held[m + 1, h:]
        want = CELLS * np.arange(t)[:, None] + np.arange(CELLS)
        np.testing.assert_array_equal(out, want)
        stages, stride, base = passes[-1]
        np.testing.assert_array_equal(base[:, None] + np.arange(CELLS), want)
        return
    # thread m's slot k holds the cell 8 m + k after the last stage: its
    # bin k' = brev13(8 m + k) is staged at rsp_split_mag_slot(k')
    write = _stage_slot(_brevs(CELLS * np.arange(t)[:, None]
                               + np.arange(CELLS), SUB_LOG2))
    staged = _stage_slot(sub)                  # words past the two planes
    assert len(np.unique(write)) == sub and write.max() < staged
    assert _worst_conflict(lambda m, k: write[m, k]) == 1
    # the store: thread m reads k' = m + t i
    assert _worst_conflict(lambda m, k: _stage_slot(m + t * k)) == 1
    assert (2 * sub + staged) * 4 + 1024 <= SMEM_SM


CASES = {
    "none": (dict(), 30000),
    "expanding in the head, keepLSB in the body": (
        dict(expand=(0, 6), lsb=(9,)), 30000),
    "keepLSB in the head, expanding in the body": (
        dict(expand=(4, 10), lsb=(0,)), 30000),
    "both before and after stage s": (
        dict(expand=(1, 7), lsb=(0, 12)), 30000),
    "full scale, seven expanding": (dict(expand=tuple(range(7))), 32767),
}


@pytest.mark.parametrize("n", [1 << 15, 1 << 16, 1 << 18, 1 << 19])
@pytest.mark.parametrize("case", list(CASES))
def test_the_split_fft_is_bit_equal_to_fft_int_op(n, case):
    masks, amp = CASES[case]
    el, km = _masks(n, **masks)
    re, im = _int_frames(n, n % 977 + len(case), amp,
                         frames=2 if n <= 1 << 16 else 1)
    fft_t = T.FftConfig(max_size=n, expand_logic=el, keep_msb_or_lsb=km)
    expand, lsb = kint.fft_masks(fft_t, n)
    got_re, got_im = _split_fft(re, im, n, expand, lsb)
    want = TB.fft_int_op(T.C(torch.from_numpy(re), torch.from_numpy(im)),
                         None, fft_t)
    np.testing.assert_array_equal(got_re, want.re.numpy())
    np.testing.assert_array_equal(got_im, want.im.numpy())


@pytest.mark.parametrize("n", [1 << 15, 1 << 16, 1 << 20, 1 << 21])
@pytest.mark.parametrize("gos", [False, True])
def test_the_tail_tiles_cover_every_cell_once_within_shared_memory(n, gos):
    """The tiles of a frame cover it once; each block fills every cell of
    its row of TILE + 2 PAD once (which holds the windows, w + g + 1 <=
    PAD, and neighbours of its cells), from the word where the body stored
    that cell's bin, zeros outside the frame: 2^s runs of ROW / 2^s >= 32
    consecutive words up to N = 2^20, natural cells beyond. The shared
    memory a block asks for (F's padded row, or three rows for G's rank
    statistics) fits."""
    tiles = [range(ts, ts + TILE) for ts in range(0, n, TILE)]
    cover = np.concatenate([np.asarray(t) for t in tiles])
    assert np.array_equal(cover, np.arange(n))
    stored = np.empty(n, np.int64)
    stored[_bins_by_k(n).ravel()] = _store_offsets(n).ravel()
    s = _s(n)
    for ts in sorted({0, TILE, n // 2, n - TILE}):
        j, src = _tail_fill(n, ts)
        assert np.array_equal(np.sort(j), np.arange(ROW))
        c = ts - PAD + j
        inside = (c >= 0) & (c < n)
        assert np.array_equal(src >= 0, inside)
        np.testing.assert_array_equal(src[inside], stored[c[inside]])
        if s <= RUNS_MAX:
            run = ROW >> s
            assert run * (1 << s) == ROW and run >= 32
            for r in src.reshape(1 << s, run):
                r = r[r >= 0]
                assert np.all(np.diff(r) == 1)
        else:
            np.testing.assert_array_equal(src[inside], c[inside])
    mag_words = (ROW // 16) * 17 + 16                  # rsp_mag_floats(TILE)
    assert (ROW - 1) + (ROW - 1) // 16 < mag_words     # rsp_mag_slot
    assert (3 * ROW if gos else mag_words) * 4 <= SMEM_MAX


@pytest.mark.parametrize("w", [1, 2, 4, 8, 16, 32, 64])
def test_the_run_sum_tail_equals_the_direct_wrapping_sums(w):
    """On magnitudes with saturated square sums at the body's store
    offsets, each tile's run sums equal its direct wrapping window sums,
    and the tail equals ``ca_cfar_int``, across tile seams and active
    ranges cut inside a tile and just past a seam."""
    n = 1 << 15
    rng = np.random.RandomState(w)
    mag = rng.randint(0, INT_MAX, (2, n), dtype=np.int64)
    mag[:, ::7] = INT_MAX
    cfar_t = T.CfarConfig(max_ref_window=64, variant=T.CfarVariant.CA,
                          include_cash=False, max_fft_size=n)
    for g, n_active in ((1, n), (3, 20000), (8, TILE + 4)):
        # written raw, past make()'s rules (w > g), as a register write can
        rt = dataclasses.replace(
            T.RuntimeConfig.make(fft_size=n, div_sum=3,
                                 cfar_fft_size=n_active, peak_grouping=1),
            ref_window_size=w, guard_window_size=g)
        r = kint.int_registers(rt, cfar_t, n)
        assert (1 << r.log2w, r.guard) == (w, g)
        buf = _store(np.where(np.arange(n) < n_active, mag, 0), n)
        for ts in (0, TILE, n - TILE):
            row = _tile_row(buf, n, ts)
            lag, lead = _side_sums(row.astype(np.uint32), TILE, w, g)
            k = PAD + np.arange(TILE)
            for got, first in ((lag, k - g - w), (lead, k + g + 1)):
                direct = sum(row[:, first + q] for q in range(w))
                np.testing.assert_array_equal(got.astype(np.int64),
                                              direct & 0xFFFFFFFF)
        thr, pk = _tail(buf, r, n)
        want = TB.ca_cfar_int(torch.from_numpy(mag.astype(np.int32)), rt,
                              cfar_t)
        np.testing.assert_array_equal(thr, want.threshold.numpy())
        np.testing.assert_array_equal(pk, want.peaks.numpy())


# (name, registers, elaboration): the F route's CA registers, and G's
CHAIN_POINTS = [
    ("F CA JPL", dict(), "ca"),
    ("F GO grouping w64, cut", dict(
        cfar_mode=1, peak_grouping=1, ref_window_size=64, guard_window_size=8,
        div_sum=6, mag_mode=0, cfar_fft_size=20000), "ca"),
    ("F SQR overflow, SO", dict(
        mag_mode=1, div_sum=0, threshold_scaler=64.0, cfar_mode=2), "ca"),
    ("F log domain", dict(log_or_linear=0, threshold_scaler=8.0), "ca"),
    ("G GOS ranks 8/24", dict(
        cfar_algorithm=1, index_lagg=8, index_lead=24), "gos"),
    ("G GOS w64 rank 63, cut, grouping", dict(
        cfar_algorithm=1, ref_window_size=64, guard_window_size=8,
        index_lagg=63, index_lead=5, cfar_fft_size=12345, peak_grouping=1,
        mag_mode=1), "gos"),
    ("G algorithm 0", dict(cfar_algorithm=0, cfar_mode=1), "gos"),
]


def _emulated_chain(n, seed, masks, regs, kind, amp, frames,
                    max_ref_window):
    """The emulated route and the integer ops on seeded frames:
    ((threshold, peaks), the ops' CfarOutput)."""
    el, km = _masks(n, **masks)
    re, im = _int_frames(n, seed, amp, frames=frames)
    fft_t = T.FftConfig(max_size=n, expand_logic=el, keep_msb_or_lsb=km)
    variant = T.CfarVariant.CA if kind == "ca" else T.CfarVariant.GOSCA
    cfar_t = T.CfarConfig(max_ref_window=max_ref_window, variant=variant,
                          include_cash=kind == "gos", max_fft_size=n)
    rt = T.RuntimeConfig.make(**{"fft_size": n, "ref_window_size": 32,
                                 "guard_window_size": 4, "div_sum": 5,
                                 "threshold_scaler": 3.5, **regs})
    r = kint.int_registers(rt, cfar_t, n)
    if kind == "ca":
        r.algorithm = 0                     # chain_int's launch
    sr, si = _split_fft(re, im, n, *kint.fft_masks(fft_t, n))
    got = _tail(_handoff(sr, si, r, n), r, n)
    x = T.C(torch.from_numpy(re), torch.from_numpy(im))
    mag = TB.mag_int_op(TB.fft_int_op(x, None, fft_t), rt.mag_mode)
    return got, (TB.ca_cfar_int if kind == "ca" else TB.cfar_int)(
        mag, rt, cfar_t)


@pytest.mark.parametrize("n", [1 << 15, 1 << 16])
@pytest.mark.parametrize("name, regs, kind", CHAIN_POINTS)
def test_the_emulated_split_chain_equals_the_integer_ops(n, name, regs, kind):
    (thr, pk), want = _emulated_chain(n, n % 991 + len(name),
                                      dict(expand=(0, 1, 9)), regs, kind,
                                      12000, 2, 64)
    np.testing.assert_array_equal(thr, want.threshold.numpy())
    np.testing.assert_array_equal(pk, want.peaks.numpy())
    assert pk.any()
    if "SQR overflow" in name:
        assert (thr < 0).any()              # the sums and products wrap


@pytest.mark.parametrize("n", [1 << 18, 1 << 19])
@pytest.mark.parametrize("kind", ["ca", "gos"])
def test_the_emulated_split_chain_is_exact_through_five_stage_heads(n, kind):
    """One frame of 2^18 (one head launch of five stages) and of 2^19 (five
    and one), expanding and keepLSB stages in the head and the body."""
    regs = (dict(ref_window_size=8, guard_window_size=2, div_sum=3,
                 peak_grouping=1, cfar_fft_size=n - 5000) if kind == "ca"
            else dict(cfar_algorithm=1, ref_window_size=8,
                      guard_window_size=2, index_lagg=2, index_lead=6))
    (thr, pk), want = _emulated_chain(
        n, n % 991 + len(kind), dict(expand=(1, 4, 8), lsb=(0, 5, 12)), regs,
        kind, 20000, 1, 8)
    np.testing.assert_array_equal(thr, want.threshold.numpy())
    np.testing.assert_array_equal(pk, want.peaks.numpy())
    assert pk.any()


@pytest.mark.parametrize("which", ["chain_int_reference",
                                   "chain_int_gos_reference",
                                   "int_ops_chain"])
def test_the_plain_versions_chunked_by_cells_equal_their_whole_selves(
        which, monkeypatch):
    n = 512
    re, im = _int_frames(n, 3, 30000, frames=7)
    x = T.C(torch.from_numpy(re), torch.from_numpy(im))
    cfg = T.ChainConfig(
        fft=T.FftConfig(max_size=n, expand_logic=_masks(n, expand=(0,))[0]),
        cfar=T.CfarConfig(max_ref_window=16, max_guard_window=4,
                          max_fft_size=n),
        fixed_point=T.FixedPointConfig(enabled=True, width=16, bin_point=0,
                                       bit_true=True))
    rt = T.RuntimeConfig.make(fft_size=n, ref_window_size=8,
                              guard_window_size=2, div_sum=3,
                              cfar_algorithm=1, index_lagg=3, index_lead=6,
                              peak_grouping=1)
    fn = getattr(kint, which)

    def run():
        if which == "int_ops_chain":
            return fn(x, rt, cfg)
        return fn(x, rt, cfg.fft, cfg.cfar)

    whole = run()
    monkeypatch.setattr(kint, "OPS_CELLS", 2 * n)     # chunks of 2, 2, 2, 1
    chunked = run()
    monkeypatch.setattr(kint, "OPS_CELLS", n // 2)    # one frame at least
    single = run()
    for got in (chunked, single):
        assert torch.equal(got.threshold, whole.threshold)
        assert torch.equal(got.peaks, whole.peaks)
    assert whole.threshold.shape == (7, n) and bool(whole.peaks.any())
