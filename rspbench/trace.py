"""The device trace of a slice of a run: ``torch.profiler`` over the slice,
its Chrome trace read back, and from it the device's busy time (the union of
kernel, copy and set intervals), the heaviest device operations and the idle
gaps by what the host was doing.

The slice is marked by a ``record_function`` span on the thread that drives
the traffic; device intervals are clipped to it. The trace file goes to a
temporary directory (under ``TMPDIR``) and is deleted once read.

``DeviceWindow`` traces a whole measured window with the card's activity
alone (no host operations, no trace file): the device's busy time over every
CPI submitted in the window, which ``card_ms_per_cpi`` reads.
"""

from __future__ import annotations

import json
import os
import tempfile
from collections import defaultdict
from dataclasses import dataclass, field

import torch

WINDOW_SPAN = "rspbench.trace_window"
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cuda_runtime", "cuda_driver", "cpu_op", "user_annotation"}


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: list = field(default_factory=list)   # [[name, seconds]]
    idle_gaps: list = field(default_factory=list)    # [[host activity, s]]
    kernels: int = 0                                 # kernel events in it


def union(intervals: list) -> list:
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def summarize(events: list, top: int = 10) -> TraceSummary:
    """Reduce Chrome-trace events (``ph`` "X", microseconds) to the slice's
    busy time, device operations and idle gaps."""
    span = [e for e in events if e.get("name") == WINDOW_SPAN
            and e.get("cat") == "user_annotation"]
    if not span:
        raise ValueError(f"the trace holds no {WINDOW_SPAN} span")
    w0 = float(span[0]["ts"])
    w1 = w0 + float(span[0]["dur"])
    dev, ops = [], defaultdict(float)
    host = []
    kernels = 0
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s = float(e["ts"])
        t = s + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            s, t = max(s, w0), min(t, w1)
            if t > s:
                dev.append((s, t))
                ops[e["name"][:160]] += (t - s) * 1e-6
                kernels += cat == "kernel"
        elif cat in HOST_CATS and e["name"] != WINDOW_SPAN:
            host.append((s, t, e["name"][:160]))
    busy = union(dev)
    busy_s = sum(t - s for s, t in busy) * 1e-6
    gaps = []
    edge = w0
    for s, t in busy + [[w1, w1]]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, t)
    idle = defaultdict(float)
    names = _host_at(sorted(host), [(g0 + g1) / 2 for g0, g1 in gaps])
    for (g0, g1), name in zip(gaps, names):
        idle[name] += (g1 - g0) * 1e-6
    rank = (lambda d: sorted(([k, v] for k, v in d.items()),
                             key=lambda kv: -kv[1])[:top])
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_s,
                        device_ops=rank(ops), idle_gaps=rank(idle),
                        kernels=kernels)


def _host_at(host: list, times: list) -> list:
    """For each of the ascending ``times`` (the idle gaps' midpoints), the
    shortest host event ``(start, end, name)`` of ``host`` (sorted by start)
    that covers it: what the host was doing while the device was idle."""
    out, active, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            active.append(host[i])
            i += 1
        active = [h for h in active if h[1] >= t]
        best = min(active, key=lambda h: h[1] - h[0], default=None)
        out.append(best[2] if best else "host: no CUDA call in flight")
    return out


class Slice:
    """A profiled slice of the traffic: ``with Slice() as sl: drive()``,
    then ``sl.summary``."""

    def __init__(self):
        self.summary = None
        self._prof = None
        self._span = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._span = torch.profiler.record_function(WINDOW_SPAN)
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        self._span.__exit__(*exc)
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        self.summary = summarize(events)
        return False


def busy_ns(spans) -> int:
    """The length of the union of ``(start_ns, duration_ns)`` spans."""
    return sum(t - s for s, t in union([(s, s + d) for s, d in spans]))


class DeviceWindow:
    """The card's activity over a window: ``with DeviceWindow() as dw:
    drive(); drain()``, then ``dw.busy_s``, the union of every kernel, copy
    and set interval that ran on the card while it was open. The caller
    opens it with nothing in flight and closes it once every CPI it counts
    has completed, so that the busy time is all of those CPIs' work."""

    def __init__(self):
        self.busy_s = None
        self.device_ops = 0
        self._prof = None

    def __enter__(self):
        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        cuda = torch.autograd.DeviceType.CUDA
        spans = [(e.start_ns(), e.duration_ns())
                 for e in self._prof.profiler.kineto_results.events()
                 if e.device_type() == cuda]
        self.device_ops = len(spans)
        self.busy_s = busy_ns(spans) * 1e-9
        return False


def warm_profiler(cpu: bool = True) -> None:
    """Start and stop the profiler once, so that the traced slice or window
    does not pay the profiler's first start (``cpu`` False: the card's
    activity alone, as ``DeviceWindow`` traces it)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if cpu:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    with torch.profiler.profile(activities=acts):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
