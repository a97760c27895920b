"""Streaming/serving harness, the port of ``rsp_chains_tpu.io.stream`` — the
deployment analog of ``RxFftMagCfarTxChain`` (SURVEY §2.11/§3.5): host ingest ->
bounded queue -> chain per CPI -> host drain, with watermark callbacks (the
UART FIFO watermark-interrupt analog, ``DSPBlockUART.scala:168-173``) and
per-CPI metrics (SURVEY §5.5).

The pipeline runs on one device: the chain's (``fn.device``), or the
``device`` given, CUDA by default; without a card it raises. On CUDA:

* the worker thread sets the device and runs ``fn`` under its own compute
  stream (the kernel wrappers launch on the current stream);
* ``_place`` copies a host CPI into a small ring of pinned host buffers
  (complex input as a pair of float32 planes, uint32 words as an int32 view)
  and issues the host-to-device copy on a copy stream; the compute stream
  waits on that copy's event, so the copy of CPI k+1 overlaps the compute of
  CPI k. A pinned slot is written again only after the event of the compute
  that read it has completed;
* after the dispatch the worker records an event on the compute stream and
  hands the output with its event to the drain thread, which waits on the
  event (``jax.block_until_ready`` in the JAX package). ``block_every`` = K
  waits on every K-th: one stream, so its completion implies the ones before
  it; the owed completion is paid at ``stop()``;
* a CPI's detections are the count its kernel made, where it made one
  (``CfarOutput.detections``: Kernels D and G), else summed on the compute
  stream (``peaks.sum``, int64) (``cpi_count``); they cross to the host only
  where ``detections_every`` says so.

On the CPU (``device="cpu"``, as the tests run it) the same threads run the
plain versions with no streams or events.

Tracing: ``StreamStats`` keeps cumulative seconds and counts of each phase,
always on (``phase_totals``). Where the port's spans are on
(``utils.profiling.spans``, or inside ``utils.profiling.trace``), each
thread enters ``record_function`` ranges at the phases' edges: ``rsp.stream.
submit`` on the caller; ``rsp.stream.queue_wait``, ``rsp.stream.place`` and
``rsp.chain.dispatch`` (holding the chain's stage ranges, its
``rsp.launch.<kernel>`` ranges and ``rsp.stream.count``) on the worker;
``rsp.stream.drain_wait``, ``rsp.stream.fetch`` and ``rsp.stream.deliver`` on
the drainer. The worker marks the start of each CPI's dispatch, and the
drainer its delivery, with ``rsp.cpi.<seq>``; no other name holds the seq,
so a trace sums by name. Each thread reads the switch once a CPI.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from ..chain import _host_to_device, _require_card
from ..cplx import C
from ..kernels import _build
from ..utils import profiling
from ..utils.profiling import span


@dataclass
class CpiMetrics:
    """Per-CPI observability record (samples, detections, latency from
    ``submit`` — SURVEY §5.5)."""

    seq: int
    samples: int
    detections: int
    latency_s: float


PHASES = ("t_queue_wait", "t_place", "t_dispatch", "t_block", "t_result")
# the counters inside and beside the phases (``phase_totals``)
COUNTERS = ("t_submit_wait", "t_cpu_dispatch", "t_launch", "n_launches",
            "t_fetch", "n_kernel_counts")
# the pinned host buffers of the CUDA ring: the copy of one CPI overlaps the
# compute of the one before
PINNED_SLOTS = 2


@dataclass
class StreamStats:
    frames_in: int = 0
    frames_out: int = 0
    frames_dropped: int = 0
    frames_failed: int = 0
    total_samples: int = 0
    total_time_s: float = 0.0
    # per-phase serving-cost attribution: cumulative seconds spent in each
    # pipeline phase. ``place``/``dispatch`` are host issue times (the copy
    # and the kernels run asynchronously, so they under-report them);
    # ``block`` on the drain thread, the wait on the CPI's event, absorbs
    # whatever had not completed — the sum of the phases bounds the
    # serialized serving cost per CPI.
    t_queue_wait: float = 0.0   # worker idle, waiting for submit
    t_place: float = 0.0        # host CPI -> pinned slot -> copy issued
    t_dispatch: float = 0.0     # the chain's launches issued
    t_block: float = 0.0        # drain wait on the CPI's event (residual
    #                             compute + copy not overlapped by issue)
    t_result: float = 0.0       # count fetch, metrics + on_result callback
    # inside and beside the phases:
    t_submit_wait: float = 0.0  # callers in ``submit``'s put (blocked on a
    #                             full queue)
    t_cpu_dispatch: float = 0.0  # the worker's CPU time over t_dispatch; the
    #                              rest it could have run and did not (the
    #                              GIL, the OS)
    t_launch: float = 0.0       # host time inside the kernels' C entry
    #                             calls during t_dispatch
    n_launches: int = 0         # C entry launches during t_dispatch, added
    #                             when the CPI is delivered
    t_fetch: float = 0.0        # the count's fetch to the host, in t_result
    n_kernel_counts: int = 0    # delivered CPIs whose count their kernel
    #                             made (``cpi_count``), added as n_launches

    def __post_init__(self):
        # counters are mutated from the submit caller, the worker, and the
        # drainer concurrently; unlocked += loses updates
        self._lock = threading.Lock()

    def bump(self, **deltas):
        with self._lock:
            for k, v in deltas.items():
                setattr(self, k, getattr(self, k) + v)

    def set_time(self, t: float):
        with self._lock:
            self.total_time_s = t

    @property
    def samples_per_s(self) -> float:
        return self.total_samples / self.total_time_s if self.total_time_s else 0.0

    def phase_ms_per_cpi(self) -> dict:
        """Per-CPI phase table in ms (over completed CPIs)."""
        n = max(self.frames_out, 1)
        with self._lock:
            return {k: round(getattr(self, k) / n * 1e3, 2) for k in PHASES}

    def phase_totals(self) -> dict:
        """Raw cumulative phase seconds and the counters beside them
        (``COUNTERS``) — lets a caller snapshot before a measurement window
        and diff after, excluding warm-up CPIs from the per-CPI
        attribution."""
        with self._lock:
            return {k: getattr(self, k) for k in PHASES + COUNTERS}


def _device_error(e: BaseException) -> bool:
    """A CUDA error, sticky for the process: every later call fails too."""
    acc = getattr(torch, "AcceleratorError", None)
    return (acc is not None and isinstance(e, acc)) or "CUDA error" in str(e)


class StreamingPipeline:
    """Continuous multi-CPI execution of a chain.

    Args:
      fn: ``(x, rt) -> CfarOutput`` chain.
      rt: RuntimeConfig applied per CPI (swap with ``reconfigure`` between CPIs —
          config applies at CPI boundaries, mirroring the reference's
          config-before-enable ordering, SURVEY §3.3).
      on_result: callback(seq, output, CpiMetrics) on the drain thread, run
          under the pipeline's compute stream, so device work it issues on
          the output is ordered after the output.
      depth: ingest queue depth (the RX FIFO nEntries analog).
      watermark: (low, high) queue depths; ``on_watermark(level)`` fires on
          crossings (the txwm/rxwm interrupt analog).
      drop_on_full: if True, overflow drops newest frame (real-time radar
          semantics); else ``submit`` blocks.
      on_error: callback(seq, exception) for per-CPI failures. The pipeline is
          elastic (SURVEY §5.3): a Python exception in ``fn`` or in
          ``on_result`` is counted and the CPI skipped, the stream keeps
          running. A CUDA error is sticky: it is counted and reported the
          same way, kept in ``device_error``, and raised again by ``stop()``.
      detections_every, block_every: the fetch and wait cadences (see
          ``__init__``).
      device: the pipeline's device; default the chain's (``fn.device``),
          else CUDA.
    """

    def __init__(
        self,
        fn: Callable,
        rt,
        on_result: Optional[Callable[[int, Any, CpiMetrics], None]] = None,
        depth: int = 8,
        watermark: tuple[int, int] = (1, 6),
        on_watermark: Optional[Callable[[str], None]] = None,
        drop_on_full: bool = False,
        on_error: Optional[Callable[[int, Exception], None]] = None,
        detections_every: int = 1,
        block_every: int = 1,
        device=None,
    ):
        fn_dev = getattr(fn, "device", None)
        self.device = torch.device(device if device is not None
                                   else fn_dev or "cuda")
        if fn_dev is not None and torch.device(fn_dev).type != self.device.type:
            raise ValueError(f"the chain runs on {fn_dev}, the pipeline on "
                             f"{self.device}")
        _require_card(self.device, "a StreamingPipeline runs on")
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._fn = fn
        self._rt = rt
        # drain wait cadence: 1 = wait on every CPI's event (exact per-CPI
        # latency + error attribution). K>1 = wait only on every K-th result
        # — sound on one compute stream (work completes in issue order, so
        # the K-th done implies the K-1 before it are done); per-CPI latency
        # then measures drain-pop time and a deferred device error surfaces
        # at the next waited CPI.
        self._block_every = max(block_every, 1)
        self._drained_n = 0
        self._pending_block = None
        # detection-count fetch cadence: 1 = per-CPI scalar fetch (exact
        # CpiMetrics.detections). K>1 = accumulate on the device and refresh
        # ``detections_total`` every K CPIs; CpiMetrics.detections is ALWAYS
        # -1 in this mode (read the running total from ``detections_total``
        # or ``flush_detections()``). 0 = accumulate, fetch only on
        # ``flush_detections()``. Accumulation runs with or without an
        # on_result consumer.
        self._detections_every = detections_every
        self.detections_total = 0
        self._det_acc = None      # the worker's running device total
        self._det_last = None     # (total, event) of the last drained CPI
        self._last_ev = None      # the worker's event of its last CPI
        self._det_n = 0
        self._fetch_s = 0.0       # the drainer's seconds in ``_fetch``
        self._drain_spans = False  # the switch as the drainer last read it
        self.device_error: Optional[BaseException] = None
        self._rt_lock = threading.Lock()
        self._on_result = on_result
        self._on_watermark = on_watermark
        self._on_error = on_error
        self._wm_low, self._wm_high = watermark
        self._drop_on_full = drop_on_full
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._outq: queue.Queue = queue.Queue()
        self.stats = StreamStats()
        self._stop = threading.Event()
        self._worker_done = threading.Event()
        self._wm_level: Optional[str] = None   # edge-trigger state
        self._wm_lock = threading.Lock()
        # the CUDA streams and the pinned ring (slot -> (key, host tensors),
        # and the event after which the slot may be written again)
        self._stream = self._copy_stream = None
        if self._cuda:
            self._stream = torch.cuda.Stream(self.device)
            self._copy_stream = torch.cuda.Stream(self.device)
        self._slots: list = [None] * PINNED_SLOTS
        self._slot_free: list = [None] * PINNED_SLOTS
        self._n_placed = 0
        self._last_slot = None
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._drainer = threading.Thread(target=self._drain, daemon=True)
        self._started = False

    # -- control plane ------------------------------------------------------

    def start(self):
        if not self._started:
            self._worker.start()
            self._drainer.start()
            self._started = True
        return self

    def reconfigure(self, rt):
        """Swap the runtime register file; applies from the next CPI."""
        with self._rt_lock:
            self._rt = rt

    def update_runtime(self, fn):
        """Atomically transform the register file: ``fn(current) -> new`` runs
        under the same lock ``reconfigure``/``runtime`` take, so a concurrent
        config write cannot interleave between a debug master's read and its
        merged write (which would silently revert it wholesale). Returns the
        new register file."""
        with self._rt_lock:
            self._rt = fn(self._rt)
            return self._rt

    @property
    def runtime(self):
        """The live runtime register file (debug-master read channel)."""
        with self._rt_lock:
            return self._rt

    def stop(self, wait: bool = True):
        """Stop after the queued CPIs; with ``wait``, join both threads (30 s
        each) and raise the sticky device error if one occurred."""
        self._stop.set()
        if wait and self._started:
            self._worker.join(timeout=30)
            self._drainer.join(timeout=30)
        if wait and self.device_error is not None:
            raise RuntimeError("the stream hit a CUDA error; the device is "
                               "unusable in this process") from self.device_error

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- data plane ---------------------------------------------------------

    def _update_watermark(self):
        """Edge-triggered watermark interrupts: ``on_watermark(level)`` fires
        once per CROSSING into the high/low band (the reference's txwm/rxwm
        interrupts are level comparators feeding edge-latched pending bits,
        ``DSPBlockUART.scala:168-173``) — not once per frame while the queue
        sits at a level, which would be an interrupt storm for any handler
        that treats each call as an event."""
        if self._on_watermark is None:
            return
        q = self._q.qsize()
        level = ("high" if q >= self._wm_high
                 else "low" if q <= self._wm_low else None)
        with self._wm_lock:
            fire = level is not None and level != self._wm_level
            self._wm_level = level
        if fire:
            self._on_watermark(level)

    def submit(self, seq: int, cpi) -> bool:
        """Enqueue one CPI block (a numpy array, a tensor or a ``C`` pair, on
        the host or already on the device). Returns False if dropped
        (drop_on_full)."""
        with span("rsp.stream.submit", profiling.SPANS):
            ready = None
            if self._cuda and _on_device(cpi, self.device):
                # a CPI already on the device: the compute stream waits for
                # the work the caller's stream issued to make it
                ready = torch.cuda.Event()
                ready.record(torch.cuda.current_stream(self.device))
            t_in = time.perf_counter()
            try:
                self._q.put((seq, cpi, ready, t_in),
                            block=not self._drop_on_full)
            except queue.Full:
                self.stats.bump(frames_dropped=1, t_submit_wait=(
                    time.perf_counter() - t_in))
                return False
            self.stats.bump(frames_in=1,
                            t_submit_wait=time.perf_counter() - t_in)
            self._update_watermark()
            return True

    def _fail(self, seq: int, e: Exception, count: bool = True) -> None:
        if count:
            self.stats.bump(frames_failed=1)
        if self.device_error is None and _device_error(e):
            self.device_error = e
        if self._on_error:
            self._on_error(seq, e)

    def _run(self):
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)
                with torch.cuda.stream(self._stream):
                    self._run_loop()
            else:
                self._run_loop()
        finally:
            self._worker_done.set()

    def _run_loop(self):
        t_start = None
        on = profiling.SPANS
        while not self._stop.is_set() or not self._q.empty():
            t_w = time.perf_counter()
            try:
                # the wait for a CPI keeps the switch as the last CPI read it
                with span("rsp.stream.queue_wait", on):
                    seq, cpi, ready, t_in = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            on = profiling.SPANS
            self.stats.bump(t_queue_wait=time.perf_counter() - t_w)
            self._update_watermark()
            with self._rt_lock:
                rt = self._rt
            try:
                with span("rsp.stream.place", on):
                    t_p = time.perf_counter()
                    self._last_slot = None
                    if ready is not None:
                        self._stream.wait_event(ready)
                    x = self._place(cpi)
                with span("rsp.chain.dispatch", on):
                    t_d = time.perf_counter()
                    c_d = time.thread_time()
                    n_d, s_d = _build.launch_totals()
                    if on:
                        profiling.mark(f"rsp.cpi.{seq}")
                    out = self._fn(x, rt)  # the launches queue on the stream
                    counts = None
                    with span("rsp.stream.count", on):
                        part, counted = self._count_of(out)
                        if part is not None:
                            total = part if self._det_acc is None \
                                else self._det_acc + part
                            self._det_acc = total
                            counts = (part, total)
                    ev = None
                    if self._cuda:
                        ev = torch.cuda.Event()
                        ev.record(self._stream)
                        self._last_ev = ev
                        if self._last_slot is not None:
                            self._slot_free[self._last_slot] = ev
                    n_e, s_e = _build.launch_totals()
                    c_e = time.thread_time()
                    t_e = time.perf_counter()
                self.stats.bump(t_place=t_d - t_p, t_dispatch=t_e - t_d,
                                t_cpu_dispatch=c_e - c_d, t_launch=s_e - s_d)
            except Exception as e:         # noqa: BLE001 — elastic: skip the CPI
                self._fail(seq, e)
                self._outq.put((seq, None, self._last_ev,
                                self._failed_counts(), t_in, 0, 0, 0))
                continue
            # the launches, and whether the kernel counted the CPI, are added
            # at its delivery, so that a window's n_launches over its
            # frames_out is a delivered CPI's launches
            self._outq.put((seq, out, ev, counts, t_in,
                            int(np.prod(cpi.shape)), n_e - n_d, int(counted)))
            if t_start is None:
                t_start = time.perf_counter()
            self.stats.set_time(time.perf_counter() - t_start)

    def _count_of(self, out) -> tuple:
        """The CPI's detections and whether its kernel counted them
        (``cpi_count``)."""
        return cpi_count(out)

    def _failed_counts(self):
        """The ``(part, total)`` counts that a failed CPI passes to the
        drain, or None: here it passes none, and the drain only takes it off
        the queue. ``PodStreamingPipeline`` passes a part of 0, so that its
        processes reduce their counts at the same CPIs."""
        return None

    def _place(self, cpi):
        """Host CPI -> device operand (``jax.device_put`` in the JAX
        package); called on the worker under the compute stream. On CUDA a
        host array goes through the pinned ring and the copy stream, and the
        compute stream waits on the copy; a tensor or pair already on the
        device passes through."""
        if not self._cuda:
            return _host_to_device(cpi, self.device)
        if _on_device(cpi, self.device):
            compute = torch.cuda.current_stream(self.device)
            for t in (cpi if isinstance(cpi, C) else (cpi,)):
                # made on the caller's stream, read on the compute stream
                t.record_stream(compute)
            return cpi
        planes = _host_planes(cpi)
        slot = self._last_slot = self._n_placed % len(self._slots)
        self._n_placed += 1
        free = self._slot_free[slot]
        if free is not None:
            free.synchronize()     # the compute that read this slot is done
        key = tuple((a.shape, dtype) for a, dtype in planes)
        if self._slots[slot] is None or self._slots[slot][0] != key:
            self._slots[slot] = (key, [
                torch.empty(a.shape, dtype=dtype, pin_memory=True)
                for a, dtype in planes])
        pinned = self._slots[slot][1]
        with warnings.catch_warnings():
            # a read-only array (a view of received bytes) is only read here
            warnings.simplefilter("ignore", UserWarning)
            for dst, (src, _) in zip(pinned, planes):
                # torch's CPU copy runs on the intra-op threads
                dst.copy_(torch.from_numpy(src))
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            dev = [h.to(self.device, non_blocking=True) for h in pinned]
            copied = torch.cuda.Event()
            copied.record(self._copy_stream)
        self._slot_free[slot] = copied   # until the compute's event replaces it
        compute.wait_event(copied)
        for t in dev:
            # allocated on the copy stream, read on the compute stream: the
            # allocator must not hand the memory out again before the
            # compute is done with it
            t.record_stream(compute)
        return C(*dev) if len(dev) == 2 else dev[0]

    def checkpoint(self, path, cpi_buffer=None, **extra):
        """Write the pipeline's restartable state — the live register file
        (+ optional CPI corner-turn buffer, + caller extras such as the
        stream cursor) — via ``io.cpi.save_state`` (SURVEY §5.4)."""
        from .cpi import save_state

        save_state(path, self.runtime, cpi=cpi_buffer, **extra)

    def _drain(self):
        if self._cuda:
            torch.cuda.set_device(self.device)
        # terminal only when the WORKER is also done: on stop() the worker may
        # hold a popped frame it has not yet pushed to _outq — an empty _outq
        # alone must not end the drain or that in-flight result is dropped
        while not (self._stop.is_set() and self._worker_done.is_set()
                   and self._outq.empty()):
            try:
                (seq, out, ev, counts, t_in, n_samples, n_launches,
                 n_counted) = self._outq.get(timeout=0.05)
            except queue.Empty:
                continue
            on = self._drain_spans = profiling.SPANS
            if out is not None:
                try:
                    self._drained_n += 1
                    blocked = (self._block_every == 1
                               or self._drained_n % self._block_every == 0)
                    if blocked:
                        with span("rsp.stream.drain_wait", on):
                            t_b = time.perf_counter()
                            if ev is not None:
                                ev.synchronize()
                            t_b = time.perf_counter() - t_b
                        self.stats.bump(t_block=t_b)
                        # one compute stream: this completion implies every
                        # earlier dispatch completed — the owed wait is paid
                        self._pending_block = None
                    else:
                        self._pending_block = ev   # completion owed at stop
                except Exception as e:  # noqa: BLE001 — deferred device error
                    self._fail(seq, e)
                    out, counts = None, self._failed_counts()
            if out is None:
                # a failed CPI, already counted: only its counts, if it
                # passes any, go on
                if counts is not None:
                    try:
                        self._count(counts, ev)
                    except Exception as e:  # noqa: BLE001 — as _deliver's
                        self._fail(seq, e, count=False)
                continue
            lat = time.perf_counter() - t_in
            self.stats.bump(frames_out=1, total_samples=n_samples,
                            n_launches=n_launches, n_kernel_counts=n_counted)
            try:
                self._deliver(seq, out, ev, counts, lat, n_samples)
            except Exception as e:  # noqa: BLE001 — a metrics/callback error
                # must never kill the drain thread (the CPI is already out)
                self._fail(seq, e, count=False)
        # block_every > 1 leaves the tail CPIs' completion owed: pay it so
        # stop() means "all submitted work finished on the device"
        if self._pending_block is not None:
            try:
                t_b = time.perf_counter()
                self._pending_block.synchronize()
                self.stats.bump(t_block=time.perf_counter() - t_b)
            except Exception as e:  # noqa: BLE001 — deferred device error
                self._fail(-1, e)
            self._pending_block = None

    def _deliver(self, seq, out, ev, counts, lat, n_samples):
        """Metrics + on_result delivery for one drained CPI (split out of the
        drain loop so its failures are contained per CPI). Detection
        accumulation happens here even with no on_result consumer — a
        callback-less serving deployment still gets ``detections_total`` /
        ``flush_detections()``."""
        t_r = time.perf_counter()
        f_r = self._fetch_s
        if self._drain_spans:
            profiling.mark(f"rsp.cpi.{seq}")
        det = self._count(counts, ev) if counts is not None else 0
        if self._on_result is not None:
            metrics = CpiMetrics(seq=seq, samples=n_samples, detections=det,
                                 latency_s=lat)
            with span("rsp.stream.deliver", self._drain_spans):
                if self._cuda:
                    with torch.cuda.stream(self._stream):
                        self._on_result(seq, out, metrics)
                else:
                    self._on_result(seq, out, metrics)
        self.stats.bump(t_result=time.perf_counter() - t_r,
                        t_fetch=self._fetch_s - f_r)

    def _count(self, counts, ev) -> int:
        """Account one CPI's ``(part, total)`` counts; returns its
        ``CpiMetrics.detections``. The worker summed them on the device;
        they cross to the host (one scalar, after the CPI's event) only every
        ``detections_every``-th CPI; in between ``CpiMetrics.detections =
        -1`` ("not fetched yet")."""
        part, total = counts
        self._det_last = (total, ev)
        self._det_n += 1
        k = self._detections_every
        if k == 1:
            # the per-CPI exact count only feeds CpiMetrics — skip its
            # fetch when nobody consumes metrics
            det = self._fetch(part, ev) if self._on_result is not None else -1
            self.detections_total = self._fetch(total, ev)
            return det
        if k > 1 and self._det_n % k == 0:
            self.detections_total = self._fetch(total, ev)
        return -1   # deferred: no fetch this CPI

    def _fetch(self, count, ev) -> int:
        """A count on the host: a tensor after ``ev``, an int as it is."""
        if not isinstance(count, torch.Tensor):
            return int(count)
        with span("rsp.stream.fetch", self._drain_spans):
            t0 = time.perf_counter()
            if ev is not None:
                ev.synchronize()
            n = int(count.item())
            self._fetch_s += time.perf_counter() - t0
        return n

    def flush_detections(self) -> int:
        """Force-fetch the accumulated device detection count of the CPIs
        drained so far (one scalar); updates and returns
        ``detections_total``."""
        if self._det_last is not None:
            self.detections_total = self._fetch(*self._det_last)
        return self.detections_total


def cpi_count(out) -> tuple:
    """``(detections, counted)`` of a CPI's output: the count its kernel made
    (``CfarOutput.detections``, an int64 tensor) and True, else its peaks
    summed on the current stream (``peaks.sum``, int64) and False; ``(None,
    False)`` for an output without peaks (wire words)."""
    if not hasattr(out, "peaks"):
        return None, False
    det = getattr(out, "detections", None)
    if det is not None:
        return det, True
    return out.peaks.sum(dtype=torch.int64), False


def _on_device(cpi, device: torch.device) -> bool:
    t = cpi.re if isinstance(cpi, C) else cpi
    return isinstance(t, torch.Tensor) and t.device == device


def _host_planes(cpi) -> list:
    """A host CPI as the ``(array, dtype)`` planes the device operand is made
    of: complex input as its real and imaginary planes in float32, uint32
    words as their int32 view, any other array as it is."""
    if isinstance(cpi, C):
        return [(p.numpy(), torch.float32) for p in cpi]
    if isinstance(cpi, torch.Tensor):
        cpi = cpi.numpy()
    cpi = np.asarray(cpi)
    if np.iscomplexobj(cpi):
        return [(cpi.real, torch.float32), (cpi.imag, torch.float32)]
    if cpi.dtype == np.uint32:
        cpi = cpi.view(np.int32)
    return [(cpi, torch.from_numpy(cpi.reshape(-1)[:0]).dtype)]
