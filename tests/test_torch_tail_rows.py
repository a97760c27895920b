"""Kernel B (``mag_cfar``, ``csrc/mag_cfar.cu``) on the CPU, through a numpy
emulation of the kernel's layout: which rows and tiles each block holds,
which 16 contiguous cells each thread takes, what its padded magnitude row
holds (the tile's cells and RSP_PAD cells on either side: the neighbouring
cells' magnitude inside the frame and the active range, zero elsewhere), and
the run-sum tail of ``csrc/row_fft.cuh`` (``rsp_ca_runs``), adds in the
kernel's order (the magnitude and run sums of
``tests/test_torch_chain_rows.py``).

* The launch covers every cell of every frame exactly once, for frames of
  N % 128 == 0 in rows packed several a block (N <= 4096) and in tiles of
  4096 cells (longer N, the last tile part-filled), with at most 256 threads
  and 227 KB of shared memory a block.
* The emulated kernel is within 1e-5 relative Δthr of ``mag_cfar_reference``
  and of the JAX ``fused_mag_cfar`` (Pallas in interpret mode), peaks equal,
  at N = 128, 384, 1152, 4096, 4224 and 8320 (two tile seams), over CA / GO /
  SO, linear / LOG2, grouping, windows 2 to 64, an active range inside the
  frame and across a seam, and the given magnitude.
* The shared-memory plan: the magnitude stores of a warp's threads and their
  window reads are free of bank conflicts for every N.

Inputs are seeded numpy arrays."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.kernels.cfar_pallas import MAG_PASSTHROUGH, fused_mag_cfar

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.convert import runtime_from_reference
from rsp_chains_tpu_torch.kernels import cfar as kcfar
from rsp_chains_tpu_torch.ops.logmag import logmag
from test_torch_chain_rows import _magnitude, _run_sums

PAD = kcfar.PAD
TILE = 4096        # csrc/mag_cfar.cu RSP_B_TILE
THREADS = 256      # csrc/ca_cfar.cuh RSP_THREADS
SMEM_MAX = 227 * 1024
SIZES = [128, 384, 1152, 4096, 4224, 8320]


def _mag_floats(length):
    """``rsp_mag_floats``: a padded magnitude row of ``length`` cells."""
    return (length + 2 * PAD) // 16 * 17 + 16


def _mag_slot(i):
    return i + (i >> 4)


def _layout(n):
    """The launch of ``rsp_mag_cfar_launch``: (cells a tile, rows a block,
    threads a block, tiles a frame)."""
    length = min(n, TILE)
    rows = THREADS // (length // 16) if n <= TILE else 1
    return length, rows, rows * length // 16, -(-n // length)


def _threads(frames, n):
    """Every thread of the launch, as arrays [blocks, threads]: its row, its
    tile's first cell and cell count, m (its run is cells 16 m .. 16 m + 15
    of the tile) and whether it computes a run."""
    length, rows, threads, tiles = _layout(n)
    blocks = -(-frames // rows) if n <= TILE else frames * tiles
    b, tid = np.meshgrid(np.arange(blocks), np.arange(threads), indexing="ij")
    q, m = np.divmod(tid, length // 16)
    if n <= TILE:
        row, start = b * rows + q, np.zeros_like(b)
    else:
        row, start = b // tiles, b % tiles * length
    cells = np.minimum(length, n - start)
    return row, start, cells, m, (row < frames) & (16 * m < cells)


def _ca_runs(rw, i0, r, lo, hi):
    """``rsp_ca_runs`` of the runs starting at the tile cells ``i0`` of the
    row ``rw`` ([PAD | tile | PAD], unpadded, float32), ``lo`` / ``hi`` the
    active range in the tile's cells: (threshold, peaks), [runs, 16]."""
    w, g = 1 << r.log2w, r.guard
    c = min(w, 16)
    lag = np.concatenate([_run_sums(rw, i0 + c0 - g - w, w, c)
                          for c0 in range(0, 16, c)], -1)
    lead = np.concatenate([_run_sums(rw, i0 + c0 + g + 1, w, c)
                           for c0 in range(0, 16, c)], -1)
    inv = np.float32(2.0 ** -r.div_sum)
    s_lag, s_lead = lag * inv, lead * inv
    noise = (np.maximum(s_lag, s_lead) if r.cfar_mode == 1
             else np.minimum(s_lag, s_lead) if r.cfar_mode == 2
             else np.float32(0.5) * (s_lag + s_lead))
    scaler = np.float32(r.scaler)
    th = noise * scaler if r.log_or_linear == 1 else noise + scaler
    i = i0[:, None] + np.arange(16)
    m = rw[PAD + i]
    pk = m > th
    if r.peak_grouping == 1:
        left = np.where(i - 1 >= lo, rw[PAD + i - 1], -np.inf)
        right = np.where(i + 1 < hi, rw[PAD + i + 1], -np.inf)
        pk &= (m >= left) & (m >= right)
    active = (i >= lo) & (i < hi)
    return np.where(active, th, np.float32(0)), pk & active


def _mag_cfar_b(mag, r):
    """Kernel B over the magnitudes ``mag`` [frames, n] (before the active
    mask) with the register struct ``r``: each tile's padded row as its
    block loads it, then the runs of its threads."""
    frames, n = mag.shape
    thr = np.full(mag.shape, np.nan, np.float32)
    pk = np.zeros(mag.shape, bool)
    row, start, cells, m, mine = _threads(frames, n)
    for f, s in sorted({(int(a), int(b)) for a, b in zip(row[mine],
                                                          start[mine])}):
        cnt = int(cells[(row == f) & (start == s)][0])
        lo, hi = r.active_lo - s, r.active_hi - s     # the tile's cells
        c = np.arange(-PAD, cnt + PAD)
        inside = (c >= lo) & (c < hi) & (s + c >= 0) & (s + c < n)
        rw = np.where(inside, mag[f, np.clip(s + c, 0, n - 1)],
                      np.float32(0)).astype(np.float32)
        i0 = 16 * m[(row == f) & (start == s) & mine]
        t, p = _ca_runs(rw, i0, r, lo, hi)
        cols = s + i0[:, None] + np.arange(16)
        thr[f, cols], pk[f, cols] = t, p
    return thr, pk


@pytest.mark.parametrize("n", SIZES + [256, 2048, 4352, 12288, 16384])
@pytest.mark.parametrize("frames", [1, 3, 33])
def test_the_launch_covers_every_cell_once(n, frames):
    length, rows, threads, tiles = _layout(n)
    assert threads <= THREADS and length % 128 == 0
    assert rows * _mag_floats(length) * 4 <= SMEM_MAX
    row, start, cells, m, mine = _threads(frames, n)
    hits = np.zeros((frames, n), int)
    for j in range(16):
        np.add.at(hits, (row[mine], start[mine] + 16 * m[mine] + j), 1)
    assert (hits == 1).all()
    if n <= TILE:
        assert (start == 0).all() and rows == THREADS // (n // 16)
    else:
        assert set(np.unique(start)) == set(range(0, n, TILE))


# (registers, active_lo, active_hi or None for the frame's end, given)
CASES = {
    "CA w32": (dict(), 0, None, False),
    "GO grouping w16": (dict(cfar_mode=1, peak_grouping=1,
                             ref_window_size=16, guard_window_size=2,
                             div_sum=4, mag_mode=0), 0, None, False),
    "SO LOG2 w2": (dict(cfar_mode=2, mag_mode=3, log_or_linear=0,
                        threshold_scaler=2.0, ref_window_size=2,
                        guard_window_size=1, div_sum=1), 0, None, False),
    "w64 g8 SQR, active range": (dict(ref_window_size=64,
                                      guard_window_size=8, div_sum=6,
                                      mag_mode=1), 37, -21, False),
    "given, grouping, active range across a seam": (
        dict(peak_grouping=1), 100, 4200, True),
}


def _frames(n, seed, frames=3):
    rng = np.random.RandomState(seed)
    x = (rng.randn(frames, n) + 1j * rng.randn(frames, n)) * 50
    x[:, 40] += 4000 + 100j
    x[:, n - 60] += 900 - 500j
    s = TILE if n > TILE else n // 2
    x[:, s - 1:s + 2] += 3000          # a peak group, across the first seam
    return x.astype(np.complex64)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", list(CASES))
def test_the_emulated_kernel_matches_mag_cfar_reference_and_jax(n, case):
    regs, lo, hi, given = CASES[case]
    hi = n if hi is None else min(hi % n if hi < 0 else hi, n)
    lo = min(lo, hi)
    rt_j = R.RuntimeConfig.make(**{"fft_size": 1024, "cfar_fft_size": n,
                                   **regs})
    rt = runtime_from_reference(rt_j.peek())
    cfg_j = R.CfarConfig(max_ref_window=64, variant=R.CfarVariant.CA,
                         include_cash=False)
    cfg_t = T.CfarConfig(max_ref_window=64, variant=T.CfarVariant.CA,
                         include_cash=False)
    x = _frames(n, seed=n + len(case))
    mag_t = logmag(T.as_pair(x), rt.mag_mode)
    mag = mag_t.numpy() if given else _magnitude(x.real, x.imag, rt.mag_mode)
    r = kcfar.ca_registers(rt, cfg_t, n, lo, hi)
    assert (r.active_lo, r.active_hi) == (lo, hi)
    thr, pk = _mag_cfar_b(mag.astype(np.float32), r)
    assert not np.isnan(thr).any()
    want = kcfar.mag_cfar_reference(mag_t if given else T.as_pair(x), rt,
                                    cfg_t, active_lo=lo, active_hi=hi,
                                    mag_given=given)
    scale = np.abs(want.threshold.numpy()).max()
    assert np.abs(thr - want.threshold.numpy()).max() / scale < 1e-5
    np.testing.assert_array_equal(pk, want.peaks.numpy())
    if given:
        want_j = fused_mag_cfar(
            R.as_pair(mag.astype(np.complex64)),
            dataclasses.replace(rt_j, mag_mode=jnp.asarray(MAG_PASSTHROUGH,
                                                           jnp.int32)),
            cfg_j, interpret=True, active_lo=lo, active_hi=hi)
    else:
        want_j = fused_mag_cfar(jnp.asarray(x), rt_j, cfg_j, interpret=True,
                                active_lo=lo, active_hi=hi)
    thr_j = np.asarray(want_j.threshold)
    assert np.abs(thr - thr_j).max() / np.abs(thr_j).max() < 1e-5
    np.testing.assert_array_equal(pk, np.asarray(want_j.peaks))
    assert not pk[:, :lo].any() and not pk[:, hi:].any()


def test_the_wrapper_copies_a_misaligned_plane():
    """The kernel loads float4: a contiguous plane at an offset that is not
    16-byte aligned goes to the kernel as an aligned copy, an aligned one as
    it is."""
    base = torch.zeros(4 * 256 + 1)
    odd = base[1:].view(4, 256)
    even = torch.zeros(4, 256)
    got = kcfar._aligned(T.C(odd, even))
    assert got.re.data_ptr() % 16 == 0 and torch.equal(got.re, odd)
    assert got.im is even
    assert kcfar._aligned(T.C(even, None)).im is None
    strided = torch.zeros(4, 512)[:, ::2]
    assert kcfar._aligned(T.C(strided, strided)).re is strided


@pytest.mark.parametrize("n", range(128, 2 * TILE + 1, 128))
def test_the_stores_and_window_reads_are_free_of_bank_conflicts(n):
    """A warp's threads store slot j of their runs, and read a window cell at
    a common offset from their runs, in 32 distinct banks, in every warp of
    the block (a warp may span two rows)."""
    length, rows, threads, _ = _layout(n)
    t = length // 16
    for offset in (0, 15, -33, -(64 + 8), 64 + 8 + 16):
        for warp in range(-(-threads // 32)):
            tid = np.arange(32 * warp, min(32 * warp + 32, threads))
            q, m = np.divmod(tid, t)
            for j in range(16):
                addr = q * _mag_floats(length) + _mag_slot(
                    PAD + 16 * m + j + offset)
                assert len(np.unique(addr % 32)) == len(addr), (n, warp, j)
