"""The split route of Kernels F and G (``csrc/int_split.cu``) for frames of
N = 2^L > 16384 on the CPU, through a numpy emulation of its three launches:
which cells each thread or block holds, the butterflies, flags and twiddles
it applies to them, where each bin's magnitude lands, and what each tail
tile reads.

* Head: under DIF stages 0 .. s-1 (s = L - 14) the cells j + t N/2^s form
  closed groups; each launch (up to four stages) covers every cell once,
  and a butterfly's partner lies in its thread's group.
* Body: each sub-frame of 16384 cells runs stages s .. L-1 with the masks
  shifted by s and ``grown`` inherited from the head; cell q of sub-frame b
  is bin bitrev_14(q) 2^s + bitrev_s(b).
* The emulated FFT (head + body, int64 wrapped to int32 as the kernel's
  ``uint32_t`` arithmetic wraps) is bit-equal to the port's ``fft_int_op``
  at N = 32768, 65536 and 2^19 (two head launches), with expanding and
  keepLSB stages before and after stage s, and full-scale frames through
  seven expanding stages (the split form of the 1.15 products).
* Tail: tiles of 4096 cells with a 128-cell margin read from the magnitude
  row (zeros outside the frame) cover every cell once and hold every window
  and neighbour; the emulated chain equals ``fft_int_op`` -> ``mag_int_op``
  -> ``ca_cfar_int`` (F) and ``cfar_int`` (G's rank statistics, and its
  algorithm 0) exactly.
* The plain versions, chunked by cells, equal their unchunked selves.

Inputs are seeded numpy arrays."""

import numpy as np
import pytest
import torch

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.kernels import cfar as kcfar
from rsp_chains_tpu_torch.kernels import int_chain as kint
from rsp_chains_tpu_torch.ops import bit_true as TB
from test_torch_chain_rows import _brev, _butterfly, _int_frames, _masks, _w32

SUB_LOG2 = 14       # csrc/int_split.cu RSP_SPLIT_LOG2
TILE = 4096         # 1 << RSP_SPLIT_TILE_LOG2
PAD = kcfar.PAD
SMEM_MAX = 227 * 1024
CPU = torch.device("cpu")
INT_MAX = 2**31 - 1


def _head_launches(n):
    """(t0, stages) of each head launch: up to four stages a launch."""
    s = n.bit_length() - 1 - SUB_LOG2
    return [(t0, min(4, s - t0)) for t0 in range(0, s, 4)]


def _head_cells(n, t0, k):
    """(lo, the frame cells of each thread's slots [threads, 2^k], stride)
    of the head launch over stages t0 .. t0 + k - 1."""
    log2n = n.bit_length() - 1
    sh = log2n - t0 - k
    idx = np.arange(n >> k)
    lo = idx & ((1 << sh) - 1)
    first = ((idx >> sh) << (log2n - t0)) + lo
    return lo, first[:, None] + (np.arange(1 << k) << sh), 1 << sh


def _flags(expand_mask, lsb_mask, s):
    expanding = bool(expand_mask >> s & 1)
    return expanding, not expanding and bool(lsb_mask >> s & 1)


def _head(re, im, n, expand_mask, lsb_mask, tw):
    """``rsp_int_split_head_kernel`` launch by launch over frames [F, n]."""
    x = [re.astype(np.int64).copy(), im.astype(np.int64).copy()]
    for t0, k in _head_launches(n):
        lo, cells, stride = _head_cells(n, t0, k)
        grown = bool(expand_mask & ((1 << t0) - 1))
        g = 1 << k
        xr, xi = x[0][:, cells], x[1][:, cells]
        for l in range(k):
            hs = (g >> 1) >> l
            half = hs * stride
            expanding, lsb = _flags(expand_mask, lsb_mask, t0 + l)
            grown = grown or expanding
            for q in range(g):
                if q & hs:
                    continue
                w = tw[half + ((lo + stride * q) & (half - 1))]
                xr[..., q], xi[..., q], xr[..., q + hs], xi[..., q + hs] = (
                    _butterfly(xr[..., q], xi[..., q], xr[..., q + hs],
                               xi[..., q + hs], w[:, 0], w[:, 1], expanding,
                               lsb, grown))
        x[0][:, cells], x[1][:, cells] = xr, xi
    return x


def _body_fft(x, n, expand_mask, lsb_mask, tw):
    """``rsp_int_split_body_kernel``'s ``rsp_int_fft``: stages s .. L-1 of
    each sub-frame, the masks shifted by s, ``grown`` inherited; returns the
    planes [F, 2^s, 16384] in the cells' order."""
    s = n.bit_length() - 1 - SUB_LOG2
    sub = 1 << SUB_LOG2
    y = [v.reshape(v.shape[0], 1 << s, sub).copy() for v in x]
    grown = bool(expand_mask & ((1 << s) - 1))
    em, lm = expand_mask >> s, lsb_mask >> s
    b = np.arange(sub // 2)
    for st in range(SUB_LOG2):
        half = sub >> (st + 1)
        expanding, lsb = _flags(em, lm, st)
        grown = grown or expanding
        j = b & (half - 1)
        i0 = ((b >> (SUB_LOG2 - 1 - st)) << (SUB_LOG2 - st)) + j
        i1 = i0 + half
        w = tw[half + j]
        (y[0][..., i0], y[1][..., i0], y[0][..., i1], y[1][..., i1]) = (
            _butterfly(y[0][..., i0], y[1][..., i0], y[0][..., i1],
                       y[1][..., i1], w[:, 0], w[:, 1], expanding, lsb,
                       grown))
    return y


def _bins(n):
    """The bin of cell q of sub-frame b: [2^s, 16384]."""
    s = n.bit_length() - 1 - SUB_LOG2
    k = np.arange(1 << SUB_LOG2)
    q = np.array([_brev(v, SUB_LOG2) for v in k])      # the cell of bin k
    rb = np.array([_brev(b, s) for b in range(1 << s)])
    bins = np.empty((1 << s, 1 << SUB_LOG2), np.int64)
    bins[:, q] = (k[None, :] << s) | rb[:, None]
    return bins


def _split_fft(re, im, n, expand_mask, lsb_mask):
    """Head and body: the spectrum in natural bin order, [F, n] each."""
    tw = kint._int_twiddles(n, CPU).numpy().astype(np.int64)
    y = _body_fft(_head(re, im, n, expand_mask, lsb_mask, tw), n,
                  expand_mask, lsb_mask, tw)
    bins = _bins(n)
    out = [np.empty((re.shape[0], n), np.int64) for _ in range(2)]
    for o, v in zip(out, y):
        o[:, bins] = v
    return out


def _magnitude_row(sr, si, r, n):
    """The body's magnitude store: ``rsp_int_magnitude`` of each bin, zero at
    and beyond n_active."""
    mag = TB.mag_int_op(T.C(torch.from_numpy(sr.astype(np.int32)),
                            torch.from_numpy(si.astype(np.int32))),
                        r.mag_mode).numpy().astype(np.int64)
    return np.where(np.arange(n) < r.n_active, mag, 0)


def _rank(win, valid, rank):
    """The min(rank, nv-1)-th smallest valid cell of each window, 0 where nv
    is 0 (invalid cells sort as INT32_MAX, as the warp keeps them)."""
    valid = np.broadcast_to(valid, win.shape)
    s = np.sort(np.where(valid, win, INT_MAX), axis=-1)
    nv = valid.sum(-1)
    idx = np.clip(np.minimum(rank, nv - 1), 0, None)
    got = np.take_along_axis(s, idx[..., None], axis=-1)[..., 0]
    return np.where(nv > 0, got, 0)


def _tail(mag, r, n):
    """``rsp_int_split_tail_kernel`` tile by tile over the magnitude rows
    [F, n]: (threshold, peaks). Each tile reads only its row of TILE +
    2 PAD cells."""
    w, g, hi = 1 << r.log2w, r.guard, r.n_active
    thr = np.zeros(mag.shape, np.int64)
    pk = np.zeros(mag.shape, bool)
    for ts in range(0, n, TILE):
        c = ts - PAD + np.arange(TILE + 2 * PAD)
        row = np.where((c >= 0) & (c < n), mag[:, np.clip(c, 0, n - 1)], 0)
        j = np.arange(TILE)
        i, k = ts + j, PAD + j
        sides = []
        for first, rank in ((k - g - w, r.rank_lagg),
                            (k + g + 1, r.rank_lead)):
            idx = first[:, None] + np.arange(w)
            assert idx.min() >= 0 and idx.max() < row.shape[-1]
            win = row[:, idx]
            if r.algorithm == 1:
                valid = (c[idx] >= 0) & (c[idx] < hi)
                sides.append(_rank(win, valid, rank))
            else:
                sides.append(_w32(win.sum(-1)) >> r.div_sum)
        s_lag, s_lead = sides
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
    make stages 0 .. s-1, and the twiddle index stays in the table."""
    stages = []
    for t0, k in _head_launches(n):
        lo, cells, stride = _head_cells(n, t0, k)
        assert k <= 4
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
    assert stages == list(range(n.bit_length() - 1 - SUB_LOG2))


@pytest.mark.parametrize("n", [1 << 15, 1 << 16, 1 << 18])
def test_the_bin_map_is_the_bit_reversal_of_the_frame(n):
    log2n = n.bit_length() - 1
    bins = _bins(n)
    p = np.arange(n)
    want = np.array([_brev(v, log2n) for v in p])
    np.testing.assert_array_equal(bins.ravel(), want)
    assert np.array_equal(np.sort(bins.ravel()), p)


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


@pytest.mark.parametrize("n", [1 << 15, 1 << 16, 1 << 19])
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


@pytest.mark.parametrize("n", [1 << 15, 1 << 16, 1 << 20])
@pytest.mark.parametrize("gos", [False, True])
def test_the_tail_tiles_cover_every_cell_once_within_shared_memory(n, gos):
    """Each block's tile holds TILE cells and PAD either side, which holds
    the windows (w + g + 1 <= PAD) and neighbours of its cells; the tiles of
    a frame cover it once; the shared memory a block asks for (one row, or
    three for G's rank statistics) fits."""
    tiles = [range(ts, ts + TILE) for ts in range(0, n, TILE)]
    cover = np.concatenate([np.asarray(t) for t in tiles])
    assert np.array_equal(cover, np.arange(n))
    assert (3 if gos else 1) * (TILE + 2 * PAD) * 4 <= SMEM_MAX
    assert 2 * (1 << SUB_LOG2) * 4 <= SMEM_MAX        # the body's planes


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


@pytest.mark.parametrize("n", [1 << 15, 1 << 16])
@pytest.mark.parametrize("name, regs, kind", CHAIN_POINTS)
def test_the_emulated_split_chain_equals_the_integer_ops(n, name, regs, kind):
    el, km = _masks(n, expand=(0, 1, 9))
    re, im = _int_frames(n, n % 991 + len(name), 12000, frames=2)
    fft_t = T.FftConfig(max_size=n, expand_logic=el, keep_msb_or_lsb=km)
    variant = T.CfarVariant.CA if kind == "ca" else T.CfarVariant.GOSCA
    cfar_t = T.CfarConfig(max_ref_window=64, variant=variant,
                          include_cash=kind == "gos", max_fft_size=n)
    rt = T.RuntimeConfig.make(**{"fft_size": n, "ref_window_size": 32,
                                 "guard_window_size": 4, "div_sum": 5,
                                 "threshold_scaler": 3.5, **regs})
    r = kint.int_registers(rt, cfar_t, n)
    if kind == "ca":
        r.algorithm = 0                     # chain_int's launch
    sr, si = _split_fft(re, im, n, *kint.fft_masks(fft_t, n))
    thr, pk = _tail(_magnitude_row(sr, si, r, n), r, n)
    x = T.C(torch.from_numpy(re), torch.from_numpy(im))
    mag = TB.mag_int_op(TB.fft_int_op(x, None, fft_t), rt.mag_mode)
    want = (TB.ca_cfar_int if kind == "ca" else TB.cfar_int)(mag, rt, cfar_t)
    np.testing.assert_array_equal(thr, want.threshold.numpy())
    np.testing.assert_array_equal(pk, want.peaks.numpy())
    assert pk.any()
    if "SQR overflow" in name:
        assert (thr < 0).any()              # the sums and products wrap


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
