"""Sharded chain execution, the port of ``rsp_chains_tpu.parallel.sharded``.

Three levels, in order of exchange cost:

1. **Channel sharding** (``channel_sharded``): N chain instances become the
   shards of the ``ch`` axis, with no exchange.
2. **Range sharding of the window stages** (``range_sharded_mag_cfar``,
   ``range_sharded_fir``): the spectrum (or time-domain stream) is sharded
   over ``rng``; CFAR windows and FIR history cross shard edges as one
   neighbour halo each way.
3. **Full pipelines** (``make_sharded_pipeline``,
   ``make_sharded_rd_pipeline``): the per-channel front (FFT, or matched
   filter and Doppler transform) with no exchange, a scatter of the range
   axis, then the halo-exchanged CFAR tail.

How sharded data and per-shard execution stand in for the JAX package's
``NamedSharding`` and ``shard_map``:

* A sharded array is a grid of blocks, ``grid[c][r]`` a tensor, a ``C`` pair
  or a ``CfarOutput`` on ``mesh.devices[c][r]`` (``scatter``). An axis the
  data is not split over keeps one block, on the axis's first shard.
* A step takes a global array, which it scatters as ``in_shardings`` and
  ``with_sharding_constraint`` do, or a grid of blocks already placed.
* A shard-local function runs under its shard's device, on that device's
  current stream: torch ops follow their tensors, and the kernel wrappers
  launch on their block's device. A function whose shards exchange a halo
  takes the blocks of one range row in ring order, the ``shard_map`` over
  ``rng``.
* The global result is assembled only at the end (``gather``), on the
  mesh's first device. No host round trip and no ``.item()`` happen between
  the stages of a step.

Routing follows the JAX package's gates exactly: the port takes a kernel
where JAX takes Pallas and the plain ops where JAX takes XLA.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional

import numpy as np
import torch

from ..configs import CfarConfig, ChainConfig, RuntimeConfig
from ..cplx import C, as_pair, like
from ..ops.cfar import CfarOutput, cfar_op
from ..ops.fft import fft_op
from ..ops.logmag import logmag
from .halo import exchange_halo, extend_with_halo
from .mesh import CHANNEL_AXIS, RANGE_AXIS, Mesh

# the fields of a CfarOutput that hold a value a cell
_CELL_FIELDS = ("threshold", "peaks", "noise", "cut")


def _tmap(fn: Callable, *trees):
    """``fn`` over the tensors of a tensor, a ``C`` or a ``CfarOutput``
    (None fields stay None). A ``CfarOutput``'s fields of cells are mapped;
    a kernel's count of the whole output (``detections``) follows no split,
    slice or join, so the result has none."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, CfarOutput):
        return CfarOutput(*(_tmap(fn, *(getattr(t, f) for t in trees))
                            for f in _CELL_FIELDS))
    return type(first)(*(_tmap(fn, *parts) for parts in zip(*trees)))


def _leaf(tree) -> torch.Tensor:
    return tree if isinstance(tree, torch.Tensor) else _leaf(tree[0])


def _split(tree, parts: int, dim: int) -> list:
    n = _leaf(tree).shape[dim]
    if n % parts:
        raise ValueError(f"axis of {n} does not split into {parts} shards")
    return [_tmap(lambda t: t.split(n // parts, dim)[i], tree)
            for i in range(parts)]


def _place(tree, device: torch.device):
    return _tmap(lambda t: t.to(device).contiguous(), tree)


def _on(device: torch.device):
    """The device guard of a shard-local call."""
    return torch.cuda.device(device) if device.type == "cuda" \
        else contextlib.nullcontext()


def scatter(x, mesh: Mesh, *, channels: bool, ranges: bool) -> list:
    """The grid of blocks of ``x`` (``[C, ..., N]``, a tensor or ``C``) on
    ``mesh``: the first axis split over ``ch`` where ``channels``, the last
    over ``rng`` where ``ranges``."""
    rows = mesh.shape[CHANNEL_AXIS] if channels else 1
    cols = mesh.shape[RANGE_AXIS] if ranges else 1
    return [[_place(part, mesh.devices[c][r])
             for r, part in enumerate(_split(row, cols, -1))]
            for c, row in enumerate(_split(x, rows, 0))]


def _join(ts, dim: int) -> torch.Tensor:
    return ts[0] if len(ts) == 1 else torch.cat(ts, dim)


def gather(grid: list, device: Optional[torch.device] = None):
    """The global array of a grid of blocks, contiguous on ``device`` (by
    default the first block's): each row's blocks joined along the last
    axis, the rows along the first. An axis of one shard joins nothing."""
    device = device if device is not None else _leaf(grid[0][0]).device
    rows = [_tmap(lambda *ts: _join([t.to(device) for t in ts], -1), *row)
            for row in grid]
    return _tmap(lambda *ts: _join(ts, 0).contiguous(), *rows)


def _is_grid(x) -> bool:
    return isinstance(x, list)


def _map_blocks(fn: Callable, grid: list) -> list:
    """``fn(block)`` for every block, under its shard's device."""
    out = []
    for row in grid:
        out_row = []
        for b in row:
            with _on(_leaf(b).device):
                out_row.append(fn(b))
        out.append(out_row)
    return out


def _scatter_ranges(grid: list, mesh: Mesh) -> list:
    """Split each channel block of a one-column grid over the ``rng`` axis:
    the range scatter after a per-channel front."""
    cols = mesh.shape[RANGE_AXIS]
    return [[_place(part, mesh.devices[c][r])
             for r, part in enumerate(_split(row[0], cols, -1))]
            for c, row in enumerate(grid)]


def channel_sharded(fn: Callable, mesh: Mesh, batch_ndim: int = 1):
    """Shard a chain over its leading channel axis, the analog of elaborating
    N independent chain instances: ``f(x, rt)`` runs ``fn(block, rt)`` on
    each channel shard, ``x`` ``[C, ...]`` with ``batch_ndim`` axes after the
    channel axis."""
    def step(x, rt: RuntimeConfig):
        if not _is_grid(x):
            x = as_pair(x)
            if x.re.dim() != 1 + batch_ndim:
                raise ValueError(f"expected [C] + {batch_ndim} axes, got "
                                 f"{tuple(x.shape)}")
        return gather(_map_blocks(lambda b: fn(b, rt),
                                  _channel_blocks(x, mesh)))

    return step


def _slice_out(out: CfarOutput, halo: int, n_loc: int) -> CfarOutput:
    return _tmap(lambda a: a[..., halo:halo + n_loc], out)


def _active(halo: int, r: int, row: list, frame: int) -> tuple[int, int]:
    """Shard ``r``'s active cells in its extended block's coordinates: the
    global frame's ``[0, frame)`` moved by the shard's start. ``frame`` is
    clipped to the row's cells, as the unsharded ops clip it; the JAX
    package's sharded tails do not clip it, so a register past the frame
    end (the 2-D detector's default ``active_range`` of 2^30) counts the
    last shard's zero halo as active cells there (ROADMAP §3)."""
    n_loc = row[0].shape[-1]
    n_ext = n_loc + 2 * halo
    start = r * n_loc
    frame = min(frame, n_loc * len(row))
    return (min(max(halo - start, 0), n_ext),
            min(max(frame - start + halo, 0), n_ext))


def cfar_halo_shard(mag_row: list, rt: RuntimeConfig,
                    cfg: CfarConfig) -> list:
    """CFAR on the magnitude blocks of one range row: exchanges halo =
    max_guard + max_ref cells with the ring neighbours (sized for the
    elaborated maxima, so a runtime window change never re-shards), then
    runs ``cfar_op`` on each extended block with the global frame's valid
    cells in local coordinates."""
    halo = cfg.max_ref_window + cfg.max_guard_window
    n_loc = mag_row[0].shape[-1]
    outs = []
    for r, ext in enumerate(extend_with_halo(mag_row, halo)):
        lo, hi = _active(halo, r, mag_row, int(rt.cfar_fft_size))
        with _on(ext.device):
            out = cfar_op(ext, rt, cfg, active_lo=lo, active_hi=hi)
        outs.append(_slice_out(out, halo, n_loc))
    return outs


def cfar_2d_halo_shard(mag_row: list, rt2, cfg2d) -> list:
    """2-D (range x Doppler) CA-CFAR on the RD-map blocks of one range row.
    The Doppler axis is shard-local, so only the range axis exchanges a halo
    of ``max_guard_range + max_ref_range`` cells, sized for the elaborated
    maxima like the 1-D tail. The plain ``cfar_2d_op`` runs on each shard, as
    in the JAX package."""
    from ..ops.cfar_2d import cfar_2d_op

    halo = cfg2d.max_ref_range + cfg2d.max_guard_range
    n_loc = mag_row[0].shape[-1]
    outs = []
    for r, ext in enumerate(extend_with_halo(mag_row, halo)):
        lo, hi = _active(halo, r, mag_row, int(rt2.active_range))
        with _on(ext.device):
            out = cfar_2d_op(ext, rt2, cfg2d, active_lo=lo, active_hi=hi)
        outs.append(CfarOutput(out.threshold[..., halo:halo + n_loc],
                               out.peaks[..., halo:halo + n_loc]))
    return outs


def _fused_tail_local(cfg: ChainConfig, n_loc: int):
    """The kernel mag + CFAR tail for the spectrum blocks of one range row,
    or None where the elaboration or shapes need the plain tail: JAX's gates
    (``sharded.py:133-143``). The halo is one kernel margin (128 cells, at
    least the window reach), and Kernel B's / C's ``active_lo`` /
    ``active_hi`` mask the halo cells beyond the true frame edges as
    ``cfar_halo_shard`` does. With ``CfarConfig.use_rdma_halo``, Kernel L
    (``mag_extend``) computes the extended magnitude rows and the CFAR
    kernel takes them as given; otherwise the spectra are extended by
    ``extend_with_halo`` and the CFAR kernel computes the magnitude."""
    from ..kernels.cfar import (
        GOS_TILE, PAD, fused_mag_gos_dispatch, fused_tail_kind, mag_cfar,
    )
    from ..kernels.halo import mag_extend

    kind = fused_tail_kind(cfg)
    if kind is None:
        return None
    halo = PAD
    if n_loc < halo or n_loc % 128 != 0:
        return None
    if cfg.cfar.max_ref_window + cfg.cfar.max_guard_window + 1 > halo:
        return None
    n_ext = n_loc + 2 * halo
    if kind == "gos" and n_ext % GOS_TILE != 0:
        return None
    fn = mag_cfar if kind == "ca" else fused_mag_gos_dispatch

    def tail(row: list, rt: RuntimeConfig) -> list:
        given = cfg.cfar.use_rdma_halo
        if given:
            exts = mag_extend(row, halo, rt.mag_mode)
        else:
            exts = [C(re, im) for re, im in zip(
                extend_with_halo([b.re for b in row], halo),
                extend_with_halo([b.im for b in row], halo))]
        outs = []
        for r, ext in enumerate(exts):
            lo, hi = _active(halo, r, row, int(rt.cfar_fft_size))
            with _on(_leaf(ext).device):
                out = fn(ext, rt, cfg.cfar, active_lo=lo, active_hi=hi,
                         mag_given=given)
            outs.append(_slice_out(out, halo, n_loc))
        return outs

    return tail


def _spectrum_tail_local(cfg: ChainConfig, n_loc: int):
    """The mag + CFAR tail over the spectrum blocks of one range row: the
    kernels where the elaboration allows, else ``logmag`` and
    ``cfar_halo_shard``."""
    fused = _fused_tail_local(cfg, n_loc)
    if fused is not None:
        return fused

    def tail(row: list, rt: RuntimeConfig) -> list:
        mags = []
        for b in row:
            with _on(b.device):
                mags.append(logmag(b, rt.mag_mode, cfg.mag))
        return cfar_halo_shard(mags, rt, cfg.cfar)

    return tail


def _tail_over_rows(cfg: ChainConfig, grid: list, rt: RuntimeConfig):
    """The spectrum tail over every range row of a grid, gathered."""
    n_loc = grid[0][0].shape[-1]
    tail = _spectrum_tail_local(cfg, n_loc)
    return gather([tail(row, rt) for row in grid])


def _channel_blocks(x, mesh: Mesh) -> list:
    """Frames ``[C, ...]`` as a one-column grid over ``ch``, or the grid
    the caller placed."""
    return x if _is_grid(x) else scatter(as_pair(x), mesh, channels=True,
                                         ranges=False)


def _front_then_tail(cfg: ChainConfig, mesh: Mesh, front: Callable):
    """The step that runs ``front(block, rt)`` on each channel shard with
    no exchange, scatters the result's range axis over ``rng`` and runs the
    tail with the halo exchange."""
    def step(x, rt: RuntimeConfig) -> CfarOutput:
        spec = _map_blocks(lambda b: front(b, rt), _channel_blocks(x, mesh))
        return _tail_over_rows(cfg, _scatter_ranges(spec, mesh), rt)

    return step


def range_sharded_mag_cfar(cfg: ChainConfig, mesh: Mesh):
    """mag + CFAR over a spectrum ``[..., N]`` sharded on the range axis:
    ``f(spectrum, rt) -> CfarOutput``."""
    def step(spectrum, rt: RuntimeConfig) -> CfarOutput:
        grid = spectrum if _is_grid(spectrum) else scatter(
            as_pair(spectrum), mesh, channels=False, ranges=True)
        return _tail_over_rows(cfg, grid, rt)

    return step


def range_sharded_fir(taps, mesh: Mesh, block_size: Optional[int] = None):
    """Overlap-save FIR over a range-sharded time axis: each shard pulls a
    (num_taps - 1)-sample left halo from its neighbour, then runs the local
    overlap-save convolution. ``f(x) -> y``, ``x`` ``[..., T]``, ``y`` in
    the caller's representation."""
    from ..ops.matched_filter import overlap_save_fir

    m = np.asarray(taps).shape[-1]

    def local(row: list) -> list:
        lefts_re = exchange_halo([b.re for b in row], m - 1)
        lefts_im = exchange_halo([b.im for b in row], m - 1)
        out = []
        for b, (lre, _), (lim, _) in zip(row, lefts_re, lefts_im):
            with _on(b.device):
                ext = C(torch.cat([lre, b.re], -1), torch.cat([lim, b.im], -1))
                y = overlap_save_fir(ext, taps, block_size)
                out.append(C(y.re[..., m - 1:], y.im[..., m - 1:]))
        return out

    def step(x):
        grid = x if _is_grid(x) else scatter(as_pair(x), mesh, channels=False,
                                             ranges=True)
        y = gather([local(row) for row in grid])
        return y if _is_grid(x) else like(x, y)

    return step


def make_sharded_pipeline(cfg: ChainConfig, mesh: Mesh):
    """The fft -> mag -> cfar pipeline over a ``(ch, rng)`` mesh:
    ``f(x, rt) -> CfarOutput``, ``x`` ``[C, ..., N]`` complex frames sharded
    over ``ch``. On a channel-only mesh with a chain-fusable elaboration
    every shard runs the whole-chain kernel (``fused_chain_ca_op`` /
    ``fused_chain_gos_op``), the single-card datapath. Otherwise the FFT
    runs per channel shard, the spectrum's range axis is scattered over
    ``rng`` and the tail runs with the halo exchange."""
    from ..kernels.cfar import fused_tail_kind
    from ..presets import _fusable_fft

    kind = fused_tail_kind(cfg)
    if (mesh.shape[RANGE_AXIS] == 1 and kind in ("ca", "gos")
            and _fusable_fft(cfg)):
        from ..kernels.chain import fused_chain_ca_op, fused_chain_gos_op

        chain_op = fused_chain_ca_op if kind == "ca" else fused_chain_gos_op

        def step_fused(x, rt: RuntimeConfig) -> CfarOutput:
            return gather(_map_blocks(
                lambda b: chain_op(b, rt, cfg.fft, cfg.cfar),
                _channel_blocks(x, mesh)))

        return step_fused
    return _front_then_tail(
        cfg, mesh, lambda b, rt: fft_op(b, rt.log2_fft_size, cfg.fft))


def make_sharded_rd_pipeline(cfg: ChainConfig, mesh: Mesh, taps):
    """The range-Doppler chain over a ``(ch, rng)`` mesh: ``f(x, rt) ->
    CfarOutput``, ``x`` ``[C, P, N]`` CPI blocks sharded over ``ch``. The
    per-channel front runs with no exchange: where the elaboration fuses
    (``fused_tail_kind`` and ``rd_fusable``) the map kernel
    (``fused_rd_chain(emit='map')``, Kernel H's map), else the matched
    filter (honouring its ``method``) and the Doppler transform. The range
    axis is then scattered over ``rng`` and the tail runs with the halo
    exchange."""
    from ..kernels.cfar import fused_tail_kind
    from ..kernels.rd import fused_rd_chain, rd_fusable
    from ..ops.doppler import doppler_fft
    from ..ops.matched_filter import matched_filter, matched_filter_os

    taps = np.asarray(taps)
    mf_cfg, dop_cfg = cfg.matched_filter, cfg.doppler
    fused_front = fused_tail_kind(cfg) is not None and rd_fusable(cfg, taps)

    def front(xl: C, rt: RuntimeConfig) -> C:
        if fused_front:
            return fused_rd_chain(xl, rt, taps, cfg, emit="map")
        y = xl
        if mf_cfg is not None:
            # the method register as the single-device preset reads it: the
            # circular filter's wraparound edges differ from overlap-save's
            y = (matched_filter_os(y, taps, mf_cfg)
                 if mf_cfg.method == "overlap_save"
                 else matched_filter(y, taps, mf_cfg))
        return doppler_fft(y, dop_cfg) if dop_cfg is not None else y

    return _front_then_tail(cfg, mesh, front)
