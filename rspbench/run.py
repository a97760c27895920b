"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m rspbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. The run:

1. set-up: loads the cell's configuration and traffic files, builds the
   program under test by the configuration's chain file
   (``rspbench/chains/<chain>.py``, ``cells.chain``; the port's kernel
   library is built on its first use in a checkout, into the package's
   ``_build`` directory), makes the ring of CPIs on the card from the seed
   by its scene file (``rspbench/scenes/<kind>.py``, ``inputs.make_ring``),
   starts a ``StreamingPipeline`` and pushes the warm-up CPIs through it;
2. the window: drives the traffic for ``--seconds`` and records every
   delivery. With ``--trace 0`` the card's activity is traced over the whole
   window (``trace.DeviceWindow``), which stays open until every CPI
   submitted in the window has been delivered; with ``--trace 1`` the window
   runs untraced, and the traffic goes on for the mix's ``trace_seconds``
   under ``torch.profiler``;
3. after the window: stops the pipeline, reads the peak memory, frees the
   program's state, runs the plain reference over the ring and judges the
   sampled outputs and every delivered count (``judge.py``);
4. prints each number compared beside its limit on standard error, and as
   the last line of standard output one JSON object: ``correct``,
   ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
   with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
   ``breakdown``, and last ``checks``.

Without the cards it asks for, the run prints no result and exits with 2; if
``jax``, ``jaxlib``, ``flax`` or the JAX package ``rsp_chains_tpu`` is
loaded once the window has closed, with 3.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Optional  # noqa: E402

from . import cells, judge, loadgen, roofline  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "rsp_chains_tpu")


@dataclass
class Run:
    """What a metric reader reads: the run's clocks, deliveries, the
    pipeline's counters over the window and the traced slice."""

    setup_s: float
    window_s: float
    samples_per_cpi: int
    least_s_per_cpi: float
    delivered_in_window: int = 0
    latencies_s: Optional[list] = None     # open loop: all CPIs due
    stats_delta: dict = field(default_factory=dict)
    trace: object = None                   # trace.TraceSummary
    cpis_in_trace: int = 0
    card_busy_s: Optional[float] = None    # --trace 0: the whole window
    cpis_on_card: int = 0                  # CPIs the window's queue took

    def latency_ms(self, q: float) -> float:
        """The ``q``-th percentile of all the window's latencies, in ms."""
        return loadgen.percentile(self.latencies_s, q) * 1e3


def forbidden_modules() -> list:
    """Top-level names of ``sys.modules`` that this process must not hold,
    each compared whole (``rsp_chains_tpu_torch`` is not
    ``rsp_chains_tpu``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def build(config: dict, mix: dict, device, root=cells.REPO):
    """The program under test and its register file, as the configuration's
    chain file builds them."""
    return cells.chain(config, root).build(config, mix, device)


def _traced_slice(drv, rec, seconds: float):
    """Drive the traffic for ``seconds`` more under the profiler; returns
    the slice's ``TraceSummary`` and the CPIs delivered in it. A trace that
    holds no kernel (the profiler lost the card's kernel activity, and with
    it nearly all of the busy time that ``chain_roofline`` divides by; every
    CPI launches one) is taken again, up to three slices in all, then fails
    the run."""
    from .trace import Slice

    for _ in range(3):
        n_before = len(rec.delivered)
        with Slice() as sl:
            drv.run(time.perf_counter() + seconds)
        if sl.summary.kernels > 0:
            return sl.summary, len(rec.delivered) - n_before
        print("rspbench: the traced slice holds no kernel; device "
              f"operations {sl.summary.device_ops}", file=sys.stderr)
    raise RuntimeError("the profiler's trace holds no kernel")


def _wait_delivered(rec, pipe, last_seq: int, seconds: float = 60.0) -> None:
    """Wait until CPI ``last_seq``, and so every CPI before it (the pipeline
    delivers in order), has been delivered; a failed CPI or ``seconds``
    without it end the wait (the judge then finds the CPIs undelivered)."""
    failed0 = pipe.stats.frames_failed
    deadline = time.perf_counter() + seconds
    while (last_seq not in rec.delivered
           and pipe.stats.frames_failed == failed0
           and time.perf_counter() < deadline):
        time.sleep(1e-3)


def run_cell(cell: cells.Cell, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_start: float = T_START,
             wrap_chain=None, root=cells.REPO, on_run=None) -> dict:
    """Run ``cell`` once; returns the result object (without printing).
    ``device="cpu"`` runs the plain versions at whatever CPI size the
    configuration gives (the CPU tests pass small ones); ``wrap_chain``, a
    function of the chain, stands a changed program in for the tests;
    ``on_run`` sees the ``Run`` the readers read."""
    import torch

    from rsp_chains_tpu_torch.cplx import C
    from rsp_chains_tpu_torch.io.stream import StreamingPipeline

    from . import inputs

    config, mix = cell.config, cell.traffic
    cuda = torch.device(device).type == "cuda"
    chain, rt = build(config, mix, device, root)
    if wrap_chain is not None:
        chain = wrap_chain(chain)
    n_ring = int(mix["ring"])
    planes = inputs.make_ring(config, n_ring, seed, device, root)
    ring = [C(re, im) for re, im in planes]
    rec = loadgen.Recorder(loadgen.sample_times(seed, seconds,
                                                int(mix["checked_cpis"])))
    pipe = StreamingPipeline(
        chain, rt, on_result=rec.on_result,
        depth=int(mix["depth"]),
        drop_on_full=bool(mix["drop_on_full"]),
        detections_every=int(mix["detections_every"]),
        block_every=int(mix["block_every"]), device=device)
    drv = loadgen.Traffic(pipe, ring, mix)
    work = roofline.cpi_work(config, root)
    pipe.start()
    try:
        warm = int(mix["warmup_cpis"])
        drv.warm(warm)
        while len(rec.delivered) + pipe.stats.frames_failed < warm:
            time.sleep(0.001)
        if pipe.stats.frames_failed:
            raise RuntimeError("a warm-up CPI failed") from pipe.device_error
        if cuda:
            from .trace import DeviceWindow, warm_profiler
            warm_profiler(cpu=trace)
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start

        whole = cuda and not trace
        card = DeviceWindow() if whole else contextlib.nullcontext()
        first = drv.seq
        stats0, out0 = pipe.stats.phase_totals(), pipe.stats.frames_out
        with card:
            t0 = time.perf_counter()
            rec.open_window(first, t0)
            drv.start(t0)
            drv.run(t0 + seconds)
            t1 = t0 + seconds
            stats1, out1 = pipe.stats.phase_totals(), pipe.stats.frames_out
            last = drv.seq
            taken = [s for s in range(first, last) if s not in drv.dropped]
            if whole and taken:
                _wait_delivered(rec, pipe, taken[-1])
        summary, in_trace = None, 0
        if trace and cuda:
            summary, in_trace = _traced_slice(drv, rec,
                                              float(mix["trace_seconds"]))
    finally:
        pipe.stop()
    t_end = time.perf_counter()

    window = range(first, last)
    if drv.open:
        window = [s for s in window if drv.stamp[s] < t1]
    delivered_in = sum(1 for t in rec.delivered.values() if t0 <= t < t1)
    accepted = [s for s in window if s not in drv.dropped]
    undelivered = sum(1 for s in accepted if s not in rec.delivered)
    failed = sum(1 for s in window if s not in rec.delivered)
    run = Run(setup_s=setup_s, window_s=seconds,
              samples_per_cpi=work["samples"],
              least_s_per_cpi=work["least_s"],
              delivered_in_window=delivered_in,
              stats_delta={**{k: stats1[k] - stats0[k] for k in stats1},
                           "frames_out": out1 - out0},
              trace=summary, cpis_in_trace=in_trace,
              card_busy_s=getattr(card, "busy_s", None),
              cpis_on_card=len(taken))
    if drv.open:
        # a CPI never delivered counts as delivered when the run ended
        run.latencies_s = [rec.delivered.get(s, t_end) - drv.stamp[s]
                           for s in window]
    if on_run is not None:
        on_run(run)
    metrics = cells.read_metrics(cell.per_layer if trace else cell.end_to_end,
                                 run, root)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated())
           if cuda else 0}
    if trace and summary is not None:
        dev.update(busy_s=summary.busy_s, window_s=summary.window_s)

    # the program's state goes before the reference runs
    counts = {s: rec.count[s] for s in window if s in rec.delivered}
    samples = rec.samples
    del pipe, drv, chain, rec
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    regs = cells.registers(config, mix)
    refs = judge.reference_outputs(cells.reference(config, root), config,
                                   regs, planes, range(n_ring))
    checks = judge.compare(config, refs, samples, counts, n_ring, undelivered)
    result = {"correct": judge.passed(checks), "attempted": len(window),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["card"] = {"power_limit_w": roofline.power_limit_w() if cuda
                      else None,
                      "least_ms_per_cpi": work["least_s"] * 1e3,
                      "bound_by": work["bound_by"]}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = cells.resolve(args.workload)
    import torch

    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"rspbench: {cell.name} needs {cell.chips} CUDA card(s); this "
              f"machine has {have}. No measurement taken.", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    leaked = forbidden_modules()
    if leaked:
        print(f"rspbench: the process holds {leaked} after the window; no "
              "result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
