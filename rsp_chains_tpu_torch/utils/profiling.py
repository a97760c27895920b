"""Tracing / profiling (SURVEY §5.1), the port of
``rsp_chains_tpu.utils.profiling``.

The reference's observability is Verilator waveform dumps; here it is a
``torch.profiler`` trace (every chain stage already runs under a
``record_function`` range named after it, so stages appear in the timeline)
and per-stage timing sweeps: CUDA events on the card, the host clock on the
CPU."""

from __future__ import annotations

import contextlib
import os
import statistics
import tempfile
import time
from typing import Callable, Dict

import torch

from ..cplx import C


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Profile the enclosed block (the CPU, and the card where there is one)
    and write a Chrome trace, ``trace.json``, into ``log_dir`` (default
    ``rsp_trace`` in the temporary directory); open it in Perfetto or
    ``chrome://tracing``. Yields the directory."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "rsp_trace")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _device(chain, x) -> torch.device:
    t = x.re if isinstance(x, C) else x
    return t.device if isinstance(t, torch.Tensor) else chain.device


def _timeit(fn: Callable, device: torch.device, iters: int = 20,
            warmup: int = 3) -> float:
    """Median seconds a call of ``fn``: on CUDA by events around each call
    after warm-up, on the CPU by the host clock."""
    for _ in range(warmup):
        fn()
    times = []
    if device.type == "cuda":
        stream = torch.cuda.current_stream(device)
        for _ in range(iters):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record(stream)
            fn()
            end.record(stream)
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
    else:
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
    return statistics.median(times)


def stage_timings(chain, x, rt, iters: int = 20) -> Dict[str, float]:
    """Seconds per cumulative stage prefix of a chain, keyed by the name of
    the prefix's last stage. The marginal cost of stage k is t[k] - t[k-1]
    (a fused stage is not timeable apart — the prefix deltas are the honest
    number)."""
    from ..chain import Chain

    device = _device(chain, x)
    out: Dict[str, float] = {}
    for k in range(1, len(chain.stages) + 1):
        prefix = Chain(chain.cfg, chain.stages[:k], chain.device)
        out[chain.stages[k - 1].name] = _timeit(lambda: prefix(x, rt),
                                                device, iters=iters)
    return out
