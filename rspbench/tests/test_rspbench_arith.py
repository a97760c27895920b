"""The shared arithmetic: the roofline's work counts, the trace's busy time
and idle gaps, the percentiles and the sampling times."""

from __future__ import annotations

import json
import math

import numpy as np
import pytest

from rspbench import cells, loadgen, roofline, trace


@pytest.mark.parametrize("config", ["rsp_vanilla_int_gosca",
                                    "fftmagcfar_float_gosca"])
def test_roofline_matches_the_kernel_table(config):
    """13 B a sample at 3.35 TB/s: 0.0651 ms at the kernel table's
    64 x 256 x 1024 (PERF.md section 6), above either chain's operation
    bound; the cells' CPI scales it."""
    bench = cells.load_benchmark()
    entry = next(c for c in bench["configs"] if c["name"] == config)
    cfg = json.loads((cells.REPO / entry["file"]).read_text())
    cell_work = roofline.cpi_work(cfg)
    cfg["cpi"]["channels"] = 64
    work = roofline.cpi_work(cfg)
    assert work["samples"] == 64 * 256 * 1024
    assert work["bytes"] == 13 * work["samples"]
    assert round(work["least_s"] * 1e3, 4) == 0.0651
    assert work["bound_by"] == "bytes"
    log2n = 10
    if config.startswith("rsp_vanilla"):
        assert work["ops"] == 8.5 * log2n * work["samples"]
        assert math.isclose(work["ops_s"], work["ops"] / 33.5e12)
    else:
        assert work["ops"] == 5 * 1024 * log2n * 64 * 256
        assert math.isclose(work["ops_s"], work["ops"] / 67e12)
    scale = cell_work["samples"] / work["samples"]
    assert math.isclose(cell_work["least_s"], scale * work["least_s"])


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_summary_clips_unions_and_names_gaps():
    events = [
        _ev(trace.WINDOW_SPAN, "user_annotation", 100, 100),
        _ev(trace.WINDOW_SPAN, "gpu_user_annotation", 90, 200),
        _ev("early", "kernel", 80, 30),            # clipped to 100..110
        _ev("k", "kernel", 120, 20),
        _ev("copy", "gpu_memcpy", 130, 20),       # overlaps k: 120..150
        _ev("cudaEventSynchronize", "cuda_runtime", 150, 40),
        _ev("k", "kernel", 190, 30),              # clipped to 190..200
    ]
    s = trace.summarize(events)
    assert s.window_s == pytest.approx(100e-6)
    assert s.busy_s == pytest.approx((10 + 30 + 10) * 1e-6)
    assert s.device_ops[0] == ["k", pytest.approx(30e-6)]
    gaps = dict((k, v) for k, v in s.idle_gaps)
    assert gaps["cudaEventSynchronize"] == pytest.approx(40e-6)
    assert gaps["host: no CUDA call in flight"] == pytest.approx(10e-6)
    assert s.kernels == 3


def test_a_slice_whose_trace_lost_its_kernels_is_taken_again(monkeypatch):
    """A trace that kept the copies and sets but no kernel reads a roofline
    share far above 100 %: the slice is taken again, and a run whose three
    slices all lose them fails."""
    from rspbench import run

    kept = [_ev(trace.WINDOW_SPAN, "user_annotation", 0, 100),
            _ev("copy", "gpu_memcpy", 10, 5)]
    traces = [kept, kept + [_ev("k", "kernel", 20, 30)]]

    class FakeSlice:
        def __enter__(self):
            return self

        def __exit__(self, *exc):
            self.summary = trace.summarize(traces.pop(0))

    class Drive:
        def run(self, until):
            rec.delivered[len(rec.delivered)] = until

    rec = loadgen.Recorder()
    monkeypatch.setattr(trace, "Slice", FakeSlice)
    summary, n = run._traced_slice(Drive(), rec, 0.0)
    assert summary.kernels == 1 and summary.busy_s == pytest.approx(35e-6)
    assert n == 1 and not traces
    traces[:] = [kept] * 3
    with pytest.raises(RuntimeError):
        run._traced_slice(Drive(), rec, 0.0)
    assert not traces


def test_union():
    assert trace.union([(5, 6), (1, 3), (2, 4), (6, 7)]) == [[1, 4], [5, 7]]


def test_percentile_is_nearest_rank_over_all_values():
    v = list(range(1, 101))
    assert loadgen.percentile(v, 95) == 95
    assert loadgen.percentile(v, 50) == 50
    assert loadgen.percentile([3.0], 95) == 3.0
    with pytest.raises(ValueError):
        loadgen.percentile([], 50)


def test_sample_times_follow_the_seed():
    a = loadgen.sample_times(2**31 + 11, 10.0, 8)
    assert np.all(np.diff(a) >= 0) and a.min() >= 0 and a.max() < 10.0
    assert np.array_equal(a, loadgen.sample_times(2**31 + 11, 10.0, 8))
    assert not np.array_equal(a, loadgen.sample_times(2**31 + 12, 10.0, 8))


def test_device_window_busy_time_is_the_union_of_spans():
    assert trace.busy_ns([(0, 10), (5, 10), (20, 5), (22, 1)]) == 20
    assert trace.busy_ns([]) == 0


def test_card_ms_per_cpi_is_busy_time_over_the_cpis_taken():
    read = cells.metric_reader("card_ms_per_cpi")

    class R:
        card_busy_s = 0.5
        cpis_on_card = 1000

    assert read(R()) == pytest.approx(0.5)
    R.card_busy_s = None
    assert read(R()) is None
