"""The traffic: one general generator that drives a ``StreamingPipeline``
from the parameters of a traffic file, and the recorder that its results
reach.

* ``loop: "closed"``: the driving thread submits CPIs back to back, and
  ``submit`` blocks while the pipeline's own queue (``depth``) is full:
  the pipeline's backpressure sets the pace.
* ``loop: "open"``: CPI k is due at ``t0 + k / rate_cpi_per_s``, whatever
  the pipeline does; the generator sleeps until a CPI is due, submits it, and
  never waits for results. A CPI that the full queue refuses is dropped.

CPIs are submitted in turn from the ring, so CPI ``seq`` carries ring slot
``seq % len(ring)``. The recorder stamps each delivery on the host clock,
keeps its detection count, and holds on to the outputs of the CPIs
delivered first after each of a few sampling times drawn from the seed (a
reference, not a copy: the program allocates each CPI's outputs anew, so a
held output is never written again, and the callback stays cheap).
"""

from __future__ import annotations

import time

import numpy as np


class Recorder:
    """The ``on_result`` of the pipeline (it runs on the drain thread; the
    held outputs are read only after ``stop()``, once every CPI's work has
    completed)."""

    def __init__(self, sample_times=()):
        self.delivered: dict = {}     # seq -> host time of delivery
        self.count: dict = {}         # seq -> detections, on the host
        self.samples: list = []       # (seq, threshold, peaks)
        self._times = sorted(sample_times)
        self._next = 0
        self.window = None            # (first seq, t0) once the window opens

    def open_window(self, first_seq: int, t0: float) -> None:
        self.window = (first_seq, t0)

    def on_result(self, seq, out, metrics) -> None:
        t = time.perf_counter()
        self.delivered[seq] = t
        self.count[seq] = metrics.detections
        if self.window is None or seq < self.window[0]:
            return
        if (self._next < len(self._times)
                and t - self.window[1] >= self._times[self._next]):
            self.samples.append((seq, out.threshold, out.peaks))
            self._next += 1


class Traffic:
    """Submits the ring's CPIs to ``pipe`` under the traffic ``mix``; keeps
    the submit time of every CPI (closed loop) or its due time (open loop)
    and the CPIs dropped."""

    def __init__(self, pipe, ring: list, mix: dict):
        self.pipe = pipe
        self.ring = ring
        self.open = mix["loop"] == "open"
        if mix["loop"] not in ("open", "closed"):
            raise ValueError(f"unknown loop {mix['loop']!r}")
        self.rate = float(mix["rate_cpi_per_s"]) if self.open else None
        self.seq = 0
        self.stamp: dict = {}     # seq -> submit time (closed) / due (open)
        self.dropped: set = set()
        self._t0 = None
        self._k = 0

    def warm(self, n: int) -> None:
        """Push ``n`` CPIs through (set-up): back to back, and where the
        pipeline drops on a full queue, each again until it is taken."""
        for _ in range(n):
            seq = self.seq
            while not self.pipe.submit(seq, self.ring[seq % len(self.ring)]):
                time.sleep(1e-4)
            self.stamp[seq] = time.perf_counter()
            self.seq += 1

    def _submit(self, stamp: float) -> None:
        seq = self.seq
        self.seq += 1
        self.stamp[seq] = stamp
        if not self.pipe.submit(seq, self.ring[seq % len(self.ring)]):
            self.dropped.add(seq)

    def start(self, t0: float) -> None:
        """Open the schedule at ``t0``: the open loop's CPI k is due at
        ``t0 + k / rate``."""
        self._t0 = t0
        self._k = 0

    def run(self, until: float) -> None:
        """Drive the traffic until host time ``until``."""
        if not self.open:
            while time.perf_counter() < until:
                self._submit(time.perf_counter())
            return
        while True:
            due = self._t0 + self._k / self.rate
            if due >= until:
                return
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self._submit(due)
            self._k += 1


def sample_times(seed: int, seconds: float, n: int) -> np.ndarray:
    """``n`` sampling times in ``[0, seconds)`` drawn from the seed."""
    rng = np.random.default_rng([int(seed), 0x5A4D])
    return np.sort(rng.uniform(0.0, seconds, n))


def percentile(values, q: float) -> float:
    """The nearest-rank ``q``-th percentile of all ``values``."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        raise ValueError("no values")
    rank = int(np.ceil(q / 100.0 * v.size))
    return float(v[min(max(rank, 1), v.size) - 1])
