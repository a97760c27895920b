"""Multi-process execution, the port of ``rsp_chains_tpu.parallel.multihost``
(BASELINE config 5: continuous multi-CPI streaming on N >= 2 hosts).

Every process runs the same program. ``initialize_cluster`` joins the
``torch.distributed`` process group, ``global_devices`` gathers every
process's devices, and ``make_pod_mesh`` lays them out as a ``(cpi, ch,
rng)`` grid in which each ``(ch, rng)`` time block lies inside one process:
only the CPI axis spans processes. CPIs are independent work units, so no
bulk sample crosses between processes; the CFAR halos stay inside a process,
on the sharded paths of ``parallel.sharded``.

The process group is gloo, not NCCL. What crosses processes is the
rendezvous, the device lists and one detection count a CPI: host scalars and
small objects, which gloo moves on the CPU. And gloo works where two
processes share one card, which NCCL refuses (two ranks on one GPU).

JAX's partitioner splits any global function over the mesh. The port runs
each of this process's time blocks itself (``shard_cpi_stream``): a block of
one device calls the function on that device; a larger block runs
``make_sharded_pipeline`` of an ``fft_mag_cfar_chain``, built once a block.
A block spread over several cards runs on each card's current stream and is
gathered on the block's first device: the gather's cross-device copies make
that device's current stream wait for the other cards' work, and the step
makes the caller's current stream wait for every block's first device, so an
event recorded after the step covers every card of every block.

With one process every function degrades to the local devices, as in JAX.
"""

from __future__ import annotations

import datetime
from dataclasses import dataclass
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

from ..chain import Chain, _host_to_device
from ..cplx import C
from ..io.stream import StreamingPipeline, cpi_count
from .mesh import CHANNEL_AXIS, RANGE_AXIS, Mesh, _cuda_devices
from .sharded import _leaf, _on, _tmap, make_sharded_pipeline

TIME_AXIS = "cpi"  # the CPI / time-block axis, the only one across processes
# the collectives' timeout that initialize_cluster set (None: torch's default,
# for a group that the caller made itself)
_group_timeout: Optional[datetime.timedelta] = None


class PodDevice(NamedTuple):
    """One device of the pod (``jax.Device``'s ``process_index`` and
    ``id``): ids number every process's devices in process order."""

    process_index: int
    id: int
    device: torch.device


class Shard(NamedTuple):
    """A time block of a pod array (``jax.Shard``): its ``index`` into the
    global ``[T, C, ..., N]`` array, a slice an axis, and its ``data``."""

    index: tuple
    data: Any


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def initialize_cluster(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    init_method: Optional[str] = None,
    timeout_s: float = 300.0,
) -> int:
    """Join the process group (a no-op for one process). Returns the process
    index.

    The group meets at ``init_method`` (a ``file://`` path the processes
    share, say), else at rank 0's TCP store on ``coordinator_address``
    (``host:port``). ``timeout_s`` bounds every collective, the pod
    pipelines' own groups' too: a process that stops taking part makes the
    others raise after it, not hang."""
    global _group_timeout
    if num_processes is not None and num_processes > 1:
        if init_method is None:
            if coordinator_address is None:
                raise ValueError("a cluster of several processes needs a "
                                 "coordinator_address or an init_method")
            init_method = f"tcp://{coordinator_address}"
        _group_timeout = datetime.timedelta(seconds=timeout_s)
        dist.init_process_group(
            "gloo", init_method=init_method, world_size=num_processes,
            rank=process_id, timeout=_group_timeout)
    return process_index()


def global_devices(local: Optional[Sequence] = None) -> list[PodDevice]:
    """Every device of the pod (``jax.devices()``): each process's ``local``
    devices, by default its visible CUDA cards (repeats allowed, as in a
    mesh), gathered from every process in process order."""
    mine = [str(torch.device(d))
            for d in (local if local is not None else _cuda_devices())]
    lists = [mine]
    if process_count() > 1:
        lists = [None] * process_count()
        dist.all_gather_object(lists, mine)
    out = []
    for p, names in enumerate(lists):
        for name in names:
            out.append(PodDevice(p, len(out), torch.device(name)))
    return out


@dataclass(frozen=True)
class PodMesh:
    """A ``(cpi, ch, rng)`` grid of ``PodDevice``s: ``devices[t][c][r]``
    holds time block ``t``, channel shard ``c``, range shard ``r``."""

    devices: tuple
    axis_names: tuple = (TIME_AXIS, CHANNEL_AXIS, RANGE_AXIS)

    @property
    def shape(self) -> dict[str, int]:
        return {TIME_AXIS: len(self.devices),
                CHANNEL_AXIS: len(self.devices[0]),
                RANGE_AXIS: len(self.devices[0][0])}

    def local_blocks(self) -> list[tuple[int, Mesh]]:
        """This process's time blocks: each block's index with its ``(ch,
        rng)`` ``Mesh`` of devices."""
        me = process_index()
        return [(t, Mesh(tuple(tuple(d.device for d in row) for row in blk)))
                for t, blk in enumerate(self.devices)
                if blk[0][0].process_index == me]


def make_pod_mesh(
    time_blocks: Optional[int] = None,
    channels: Optional[int] = None,
    range_shards: int = 1,
    devices: Optional[Sequence[PodDevice]] = None,
) -> PodMesh:
    """A ``(cpi, ch, rng)`` mesh over ``devices`` (default
    ``global_devices()``).

    Layout rule: ``rng`` (the halo exchange) and ``ch`` stay inside a
    process; ``cpi`` (independent CPI blocks, no exchange) spans processes.
    Default: one time block a process."""
    # a stable sort by (process_index, id) keeps each process's devices
    # contiguous along the leading cpi axis, whatever order they came in: a
    # raw reshape of an interleaved list would put devices of two processes
    # in one (ch, rng) block, and the halos would cross processes every CPI
    devs = sorted(devices if devices is not None else global_devices(),
                  key=lambda d: (d.process_index, d.id))
    n = len(devs)
    procs = max(len({d.process_index for d in devs}), 1)
    if time_blocks is None:
        time_blocks = procs
    if channels is None:
        channels = n // (time_blocks * range_shards)
    need = time_blocks * channels * range_shards
    if need != n or n == 0:
        raise ValueError(
            f"mesh {time_blocks}x{channels}x{range_shards} != {n} devices")
    per_block = channels * range_shards
    grid = tuple(tuple(tuple(devs[(t * channels + c) * range_shards + r]
                             for r in range(range_shards))
                       for c in range(channels))
                 for t in range(time_blocks))
    if (n // procs) % per_block != 0 or any(
            len({d.process_index for row in blk for d in row}) > 1
            for blk in grid):
        # each [C, R] time block takes C·R consecutive devices of one
        # process: a process's device count must hold whole blocks
        raise ValueError(
            f"layout {time_blocks}x{channels}x{range_shards} cannot keep "
            f"(ch, rng) intra-host with {n // procs} devices/host — pick "
            "channels*range_shards dividing the per-host device count")
    return PodMesh(grid)


def pod_spec(batch_axes: int = 1) -> tuple:
    """How ``[cpi_blocks, channels, ..., range]`` arrays lie on a pod mesh:
    the mesh axis of each dimension, None for an unsharded one (the port's
    form of a ``PartitionSpec``)."""
    return (TIME_AXIS, CHANNEL_AXIS, *([None] * (batch_axes - 1)), RANGE_AXIS)


def _rows(x, lo: int, hi: int):
    """Rows ``lo:hi`` of the leading axis of an array, a tensor or a ``C``."""
    if isinstance(x, C):
        return C(x.re[lo:hi], x.im[lo:hi])
    return x[lo:hi]


def _to(x, device: torch.device):
    if not isinstance(x, (torch.Tensor, C)):
        return _host_to_device(x, device)
    return _tmap(lambda t: t.to(device), x)


def _shardable(fn) -> bool:
    """Whether ``make_sharded_pipeline(fn.cfg)`` computes ``fn``: a float
    ``fft_mag_cfar_chain``."""
    from ..presets import fft_mag_cfar_chain

    return (isinstance(fn, Chain) and not fn.cfg.fixed_point.enabled
            and fn.stage_names == fft_mag_cfar_chain(
                fn.cfg, device=fn.device).stage_names)


def _block_runner(fn: Callable, sub: Mesh) -> Callable:
    """``f(block, rt)`` of one time block on its ``(ch, rng)`` mesh ``sub``;
    a block is ``[T_block, C, ..., N]``."""
    dev = sub.devices[0][0]
    if sub.shape == {CHANNEL_AXIS: 1, RANGE_AXIS: 1}:
        def run_one(x, rt):
            with _on(dev):
                return fn(_to(x, dev), rt)

        return run_one
    if not _shardable(fn):
        raise ValueError(
            f"a time block of {sub.shape} shards runs make_sharded_pipeline, "
            "which computes a float fft_mag_cfar_chain: pass such a chain, "
            "or a mesh of one device a time block")
    step = make_sharded_pipeline(fn.cfg, sub)

    def run_sharded(x, rt):
        x = _to(x, dev)
        outs = [step(_tmap(lambda t: t[i], x), rt)
                for i in range(_leaf(x).shape[0])]
        return _tmap(lambda *ts: ts[0].unsqueeze(0) if len(ts) == 1
                     else torch.stack(ts), *outs)

    return run_sharded


def _wait_on_current(out: list) -> None:
    """Make the caller's current stream wait for the current stream of each
    CUDA device that holds a block's output."""
    devs = {_leaf(s.data).device for s in out}
    devs = {d for d in devs if d.type == "cuda"}
    if not devs:
        return
    here = torch.cuda.current_stream()
    for d in devs - {here.device}:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(d))
        here.wait_event(ev)


class PodStep:
    """``shard_cpi_stream``'s step, ``f(x, rt) -> [Shard]``: ``x`` is a
    global ``[T, C, ..., N]`` batch (an array, a tensor or a ``C``), or this
    process's blocks already placed (``[Shard]``, as ``shards`` gives them).
    Each of this process's time blocks runs on its devices; the result holds
    one ``Shard`` a local block, its ``CfarOutput`` on the block's first
    device (``jax.Array.addressable_shards``)."""

    def __init__(self, fn: Callable, mesh: PodMesh):
        self.mesh = mesh
        blocks = mesh.local_blocks()
        if not blocks:
            raise ValueError(f"process {process_index()} holds no time block "
                             f"of the {mesh.shape} mesh")
        self._runs = {t: _block_runner(fn, sub) for t, sub in blocks}
        self.device = blocks[0][1].devices[0][0]

    def local_rows(self, total: int) -> tuple[int, int]:
        """The rows ``[lo, hi)`` of a ``total``-row batch that this process's
        time blocks hold (they are consecutive)."""
        tb = self.mesh.shape[TIME_AXIS]
        if total % tb:
            raise ValueError(f"{total} CPI blocks do not split over {tb} "
                             "time blocks")
        per = total // tb
        return min(self._runs) * per, (max(self._runs) + 1) * per

    def shards(self, x, total: Optional[int] = None) -> list[Shard]:
        """This process's time blocks of ``x``: a whole batch, or only its
        ``local_rows(total)`` of a batch of ``total`` rows."""
        shape = tuple(x.shape)
        total = shape[0] if total is None else total
        lo, hi = self.local_rows(total)
        off = 0 if shape[0] == total else lo
        if shape[0] not in (total, hi - lo):
            raise ValueError(f"{shape[0]} rows are neither the batch's "
                             f"{total} nor this process's {hi - lo}")
        per = total // self.mesh.shape[TIME_AXIS]
        rest = tuple(slice(0, d) for d in shape[1:])
        return [Shard((slice(t * per, (t + 1) * per), *rest),
                      _rows(x, t * per - off, (t + 1) * per - off))
                for t in sorted(self._runs)]

    def __call__(self, x, rt) -> list[Shard]:
        placed = x if isinstance(x, list) else self.shards(x)
        out = []
        for s in placed:
            rows = s.index[0]
            t = rows.start // (rows.stop - rows.start)
            out.append(Shard(s.index, self._runs[t](s.data, rt)))
        _wait_on_current(out)
        return out


def shard_cpi_stream(pipeline_fn: Callable, mesh: PodMesh) -> PodStep:
    """Wrap a per-CPI pipeline ``f(x, rt)`` for pod execution: input ``[T,
    C, P, N]`` (T CPI blocks x C channels x P pulses x N range) laid out over
    ``(cpi, ch, -, rng)``. CPI blocks run independently; the pipeline's
    range halos stay inside a process. A block of several devices needs a
    float ``fft_mag_cfar_chain`` (``make_sharded_pipeline``); any other
    ``pipeline_fn`` raises there."""
    return PodStep(pipeline_fn, mesh)


class PodStreamingPipeline(StreamingPipeline):
    """Continuous multi-CPI streaming over a pod mesh (BASELINE config 5):
    the multi-process ``io.stream.StreamingPipeline``.

    Every process runs the same program: each submitted CPI batch ``[T, C,
    ..., N]`` (the same host content on every process, the usual replicated
    ingest) has only this process's time blocks copied to its device, then
    one pod step (``shard_cpi_stream``) runs them. The detection counts of
    the metrics (``CpiMetrics.detections``, ``detections_total``) are
    GLOBAL: each process's count, summed on its device and fetched at the
    ``detections_every`` cadence, is summed over the processes. Checkpoint
    and restore are the inherited ``checkpoint`` and ``io.cpi.load_state``
    (register file and stream cursor; every process writes and reads its own
    identical copy).

    SPMD ordering contract: every process builds its pipelines in the same
    order with the same arguments and submits the same sequence, so the one
    drain thread of each runs the reductions at the same CPIs in the same
    order. The reductions run on a process group of the pipeline's own,
    which no collective of the caller's thread can interleave with. A CPI
    that fails on one process still takes part, adding 0, and so does a
    count whose fetch fails; ``drop_on_full`` is refused, since a dropped
    CPI would take no part; ``flush_detections()`` reduces too: call it on
    every process, after ``stop()``."""

    def __init__(self, chain_fn: Callable, rt, mesh: PodMesh, **kw):
        if kw.get("drop_on_full"):
            raise ValueError("a pod pipeline drops no CPI: every process "
                             "must take part in every CPI's reduction")
        super().__init__(shard_cpi_stream(chain_fn, mesh), rt, **kw)
        self._group = None
        if process_count() > 1:
            self._group = dist.new_group(backend="gloo",
                                         timeout=_group_timeout)

    def _place(self, cpi):
        """Only this process's rows of the batch cross to the device,
        through the pinned ring (a process materializes only its addressable
        shards); the other rows are not read."""
        total = cpi.shape[0]
        lo, hi = self._fn.local_rows(total)
        return self._fn.shards(super()._place(_rows(cpi, lo, hi)), total)

    def _count_of(self, out) -> tuple:
        # every CPI counts (0 without peaks): the processes must reduce at
        # the same CPIs. The kernels counted the CPI where they counted each
        # shard's peaks (``cpi_count``).
        counts = [c for c in map(cpi_count, (s.data for s in out))
                  if c[0] is not None]
        zero = torch.zeros((), dtype=torch.int64, device=self.device)
        return (sum((c.to(self.device) for c, _ in counts), zero),
                bool(counts) and all(k for _, k in counts))

    def _failed_counts(self):
        # a failed CPI still takes part in the reduction, adding 0
        return 0, self._det_acc if self._det_acc is not None else 0

    def _all_sum(self, fetch: Callable[[], list]) -> list:
        """The two local counts that ``fetch()`` gives (a CPI's count and
        the running total), summed over the processes in one reduction
        (gloo, on the CPU). A ``fetch`` that raises adds zeros, and the error
        is raised after the reduction: every process takes part in every
        reduction, whatever fails."""
        try:
            mine, err = fetch(), None
        except Exception as e:  # noqa: BLE001 — re-raised after the reduction
            mine, err = [0, 0], e
        if self._group is not None:
            t = torch.tensor(mine, dtype=torch.int64)
            dist.all_reduce(t, group=self._group)
            mine = t.tolist()
        if err is not None:
            raise err
        return mine

    def _count(self, counts, ev) -> int:
        part, total = counts
        self._det_last = (total, ev)
        self._det_n += 1
        k = self._detections_every
        if not (k == 1 or (k > 1 and self._det_n % k == 0)):
            return -1   # deferred: no fetch and no reduction this CPI
        # the CPI's own count only feeds CpiMetrics, at the cadence of 1
        per_cpi = k == 1 and self._on_result is not None
        det, self.detections_total = self._all_sum(lambda: [
            self._fetch(part, ev) if per_cpi else 0, self._fetch(total, ev)])
        return det if per_cpi else -1

    def flush_detections(self) -> int:
        _, self.detections_total = self._all_sum(lambda: [
            0, self._fetch(*self._det_last) if self._det_last is not None
            else 0])
        return self.detections_total
