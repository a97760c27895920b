"""The streamed path's tracing, on the CPU: the port's spans in the trace of
``utils.profiling.trace`` on every thread of a running pipeline, none
entered while the port's switch is off, the counters beside the phases of
``StreamStats``, and the benchmark's readers of them."""

import contextlib
import io
import json
import threading
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch import cli as tcli
from rsp_chains_tpu_torch.io.stream import COUNTERS, PHASES, StreamingPipeline
from rsp_chains_tpu_torch.utils import profiling

from rspbench import cells
from rspbench.run import Run

N = 256
REGS = dict(fft_size=N, ref_window_size=8, guard_window_size=2,
            threshold_scaler=3.5, div_sum=3)
WAIT_S = 60
# the spans of the streamed path that the CPU's plain path reaches (no
# kernel is launched there, so no rsp.launch.<kernel>)
CPU_SPANS = ("rsp.stream.submit", "rsp.stream.queue_wait", "rsp.stream.place",
             "rsp.chain.dispatch", "rsp.stream.count", "rsp.stream.drain_wait",
             "rsp.stream.fetch", "rsp.stream.deliver")


def _chain():
    cfg = T.ChainConfig(fft=T.FftConfig(max_size=N), cfar=T.CfarConfig(
        max_ref_window=16, variant=T.CfarVariant.CA, include_cash=False,
        use_pallas=False))
    return T.fft_mag_cfar_chain(cfg, device="cpu")


def _cpis(n, frames=4):
    rng = np.random.RandomState(0)
    x = (rng.randn(n, frames, N) + 1j * rng.randn(n, frames, N)) * 3
    x[..., 40] += 60
    return list(x.astype(np.complex64))


def _stream(pipe, cpis, first=0):
    """Submit ``cpis`` to the started ``pipe`` as CPIs ``first``, ``first``
    + 1, ... and wait for their delivery."""
    for s, x in enumerate(cpis, first):
        pipe.submit(s, x)
    t0 = time.time()
    while (pipe.stats.frames_out + pipe.stats.frames_failed
           < first + len(cpis)):
        if time.time() - t0 > WAIT_S:
            raise AssertionError("the CPIs were not delivered")
        time.sleep(0.005)
    assert pipe.stats.frames_failed == 0


def _pipeline(chain, **kw):
    return StreamingPipeline(chain, T.RuntimeConfig.make(**REGS),
                             on_result=lambda s, o, m: None, device="cpu",
                             **kw)


def test_trace_holds_every_span_of_a_running_pipelines_threads(tmp_path):
    chain = _chain()
    pipe = _pipeline(chain).start()   # the threads run before the profiler
    try:
        _stream(pipe, _cpis(1))       # warm
        assert profiling.SPANS is False
        with profiling.trace(str(tmp_path)):
            assert profiling.SPANS is True
            _stream(pipe, _cpis(3), first=1)
    finally:
        pipe.stop()
    assert profiling.SPANS is False
    events = [e for e in json.loads((tmp_path / "trace.json").read_text())
              ["traceEvents"] if e.get("ph") == "X"]
    by_name = defaultdict(list)
    for e in events:
        by_name[e["name"]].append(e)
    for name in CPU_SPANS:
        assert by_name[name], f"{name} is not in the trace"
    worker = {e["tid"] for e in by_name["rsp.chain.dispatch"]}
    drainer = {e["tid"] for e in by_name["rsp.stream.deliver"]}
    caller = {e["tid"] for e in by_name["rsp.stream.submit"]}
    assert len(worker) == len(drainer) == len(caller) == 1
    assert len(worker | drainer | caller) == 3
    for seq in (1, 2, 3):
        marks = by_name[f"rsp.cpi.{seq}"]
        assert sorted(e["tid"] for e in marks) == sorted(worker | drainer)
    assert not by_name["rsp.cpi.0"]   # delivered before the trace
    assert not [n for n in by_name if n.startswith("rsp.launch.")]
    # every stage range sits inside a dispatch span on the worker's thread
    dispatch = by_name["rsp.chain.dispatch"]
    for stage in chain.stage_names:
        assert len(by_name[stage]) == 3
        for e in by_name[stage]:
            assert any(d["tid"] == e["tid"] and d["ts"] <= e["ts"]
                       and e["ts"] + e["dur"] <= d["ts"] + d["dur"]
                       for d in dispatch), stage


@pytest.mark.parametrize("profiled", [False, True])
def test_switch_off_enters_no_record_function(monkeypatch, profiled):
    entered = []
    real = torch.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    prof = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) if profiled
        else contextlib.nullcontext())
    with prof:
        n0 = len(entered)
        with _pipeline(_chain()) as pipe:
            _stream(pipe, _cpis(3))
        assert entered[n0:] == []
        # the same run with the switch on enters the spans: the count sees
        # them
        prev = profiling.spans(True)
        try:
            with _pipeline(_chain()) as pipe:
                _stream(pipe, _cpis(1))
        finally:
            profiling.spans(prev)
        assert {"rsp.chain.dispatch", "rsp.stream.deliver"} <= set(entered)


def test_phase_totals_hold_the_counters():
    with _pipeline(_chain()) as pipe:
        _stream(pipe, _cpis(4))
    tot = pipe.stats.phase_totals()
    assert list(tot) == list(PHASES + COUNTERS)
    assert set(COUNTERS) == {"t_submit_wait", "t_cpu_dispatch", "t_launch",
                             "n_launches", "t_fetch", "n_kernel_counts"}
    assert set(pipe.stats.phase_ms_per_cpi()) == set(PHASES)
    assert 0 < tot["t_cpu_dispatch"] <= tot["t_dispatch"] + 1e-3
    assert 0 < tot["t_fetch"] <= tot["t_result"]
    assert tot["n_launches"] == 0 and tot["t_launch"] == 0   # plain path
    assert tot["t_submit_wait"] >= 0


def test_a_slow_chain_blocks_submit_and_spends_no_cpu():
    def sleepy(x, rt):
        time.sleep(0.05)
        return x

    pipe = StreamingPipeline(sleepy, None, depth=1, device="cpu")
    with pipe:
        for s in range(4):
            pipe.submit(s, torch.zeros(8))
    tot = pipe.stats.phase_totals()
    assert pipe.stats.frames_out == 4
    # submit 2 waits at least for CPI 0's dispatch to end
    assert tot["t_submit_wait"] > 0.025
    assert tot["t_dispatch"] > 0.15
    assert tot["t_cpu_dispatch"] < 0.5 * tot["t_dispatch"]   # asleep


def test_cli_stream_traces_and_prints_the_counters(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = tcli.main(["stream", "--device", "cpu", "--frames", "2",
                        "--trace", str(tmp_path)])
    assert rc == 0
    out = buf.getvalue()
    assert "dispatch" in out and "cpu_dispatch" in out and "fetch" in out
    assert "launches per CPI 0.00" in out
    text = (tmp_path / "trace.json").read_text()
    assert "rsp.chain.dispatch" in text and "rsp.cpi.1" in text


READERS = [("submit_wait_ms.sat", "t_submit_wait", 1e3),
           ("queue_wait_ms.sat", "t_queue_wait", 1e3),
           ("drain_wait_ms.sat", "t_block", 1e3),
           ("fetch_ms.sat", "t_fetch", 1e3),
           ("dispatch_cpu_ms.sat", "t_cpu_dispatch", 1e3),
           ("launch_ms.sat", "t_launch", 1e3),
           ("launches_per_cpi.sat", "n_launches", 1)]


def _run(delta):
    return Run(setup_s=1.0, window_s=10.0, samples_per_cpi=1,
               least_s_per_cpi=1e-4, stats_delta=delta)


@pytest.mark.parametrize("metric, key, scale", READERS)
def test_reader_divides_its_counter_by_the_cpis_delivered(metric, key, scale):
    read = cells.metric_reader(metric)
    assert read(_run({key: 0.75, "frames_out": 250})) == pytest.approx(
        0.75 / 250 * scale)
    assert read(_run({key: 0.75, "frames_out": 0})) is None
    # a program that keeps no such counter reads nothing, and raises
    # nothing
    assert read(_run({"frames_out": 250})) is None
    entry = [m for m in cells.load_benchmark()["per_layer"]
             if m["name"] == metric]
    assert len(entry) == 1 and entry[0]["moves"] == "card_ms_per_cpi"
    assert entry[0]["source"] == "program_span"
    assert entry[0]["workloads"] == ["int_gosca.gos_sat",
                                     "float_gosca.gos_sat"]


def test_counters_survive_concurrent_submitters():
    """Two callers submit at once, under a short switch interval: no
    counter update is lost (each is bumped under the stats' lock)."""
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with StreamingPipeline(lambda x, rt: x, None, depth=2,
                               device="cpu") as pipe:
            def submit(base):
                for s in range(200):
                    pipe.submit(base + s, torch.zeros(4))
            threads = [threading.Thread(target=submit, args=(b,))
                       for b in (0, 1000, 2000)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert pipe.stats.frames_in == pipe.stats.frames_out == 600
    assert pipe.stats.phase_totals()["n_launches"] == 0
