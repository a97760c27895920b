"""A CPI's detection count on the streamed path, on the CPU: the count a
kernel made (``CfarOutput.detections``, Kernels D and G) is delivered as it
is and counted in ``StreamStats.n_kernel_counts``; an output without one is
summed (``peaks.sum``) as before; a wire output gives no count; the pod's
pipeline takes the same rule over its shards; and the benchmark's reader of
the counter. The kernels' own counts are held against their peaks in
``tests/test_torch_cuda.py``."""

import time
from types import SimpleNamespace

import pytest
import torch

from rsp_chains_tpu_torch.io.stream import (
    COUNTERS, StreamingPipeline, cpi_count,
)
from rsp_chains_tpu_torch.ops.cfar import CfarOutput
from rsp_chains_tpu_torch.parallel.multihost import PodStreamingPipeline, Shard

from rspbench import cells
from rspbench.run import Run

WAIT_S = 60


def _output(peaks: int, detections=None, n: int = 64) -> CfarOutput:
    """An output with ``peaks`` peaks and, where given, a kernel's count
    ``detections`` (which the rule takes as it is, even where it differs)."""
    pk = torch.zeros(2, n, dtype=torch.bool)
    pk.view(-1)[:peaks] = True
    det = None if detections is None else torch.tensor(detections,
                                                       dtype=torch.int64)
    return CfarOutput(threshold=torch.zeros(2, n), peaks=pk, detections=det)


def _deliver(outputs: list) -> tuple:
    """Stream one CPI per element of ``outputs`` (the chain returns them in
    turn); returns the delivered ``CpiMetrics.detections`` and the
    pipeline's stats."""
    it = iter(outputs)
    got = {}
    pipe = StreamingPipeline(lambda x, rt: next(it), None, device="cpu",
                             on_result=lambda s, o, m: got.update(
                                 {s: m.detections}))
    with pipe:
        for s in range(len(outputs)):
            pipe.submit(s, torch.zeros(4))
        t0 = time.time()
        while pipe.stats.frames_out < len(outputs):
            assert time.time() - t0 < WAIT_S, "the CPIs were not delivered"
            time.sleep(0.002)
    assert pipe.stats.frames_failed == 0
    return [got[s] for s in range(len(outputs))], pipe


def test_cpi_count_takes_the_kernels_count_where_there_is_one():
    det, counted = cpi_count(_output(5, detections=9))
    assert counted and det.dtype == torch.int64 and int(det) == 9
    det, counted = cpi_count(_output(5))
    assert not counted and det.dtype == torch.int64 and int(det) == 5
    assert cpi_count(torch.zeros(3, 64, dtype=torch.int32)) == (None, False)


def test_a_kernels_count_is_delivered_as_it_is_and_counted():
    dets, pipe = _deliver([_output(3, detections=11), _output(0, detections=0),
                           _output(7, detections=7)])
    assert dets == [11, 0, 7]
    assert pipe.detections_total == 18
    tot = pipe.stats.phase_totals()
    assert tot["n_kernel_counts"] == 3 == pipe.stats.frames_out


def test_an_output_without_a_count_is_summed_as_before():
    dets, pipe = _deliver([_output(4), _output(6, detections=2), _output(1)])
    assert dets == [4, 2, 1]
    assert pipe.detections_total == 7
    assert pipe.stats.phase_totals()["n_kernel_counts"] == 1


@pytest.mark.parametrize("every", [0, 3])
def test_a_kernels_count_accumulates_on_the_device_between_fetches(every):
    outs = [_output(2, detections=5), _output(3), _output(1, detections=4)]
    it = iter(outs)
    pipe = StreamingPipeline(lambda x, rt: next(it), None, device="cpu",
                             detections_every=every)
    with pipe:
        for s in range(3):
            pipe.submit(s, torch.zeros(4))
    assert pipe.flush_detections() == 12
    assert pipe.stats.phase_totals()["n_kernel_counts"] == 2


def test_a_wire_output_gives_no_count():
    dets, pipe = _deliver([torch.zeros(2, 64, dtype=torch.int32)] * 2)
    assert dets == [0, 0]
    assert pipe.detections_total == 0
    assert pipe.stats.phase_totals()["n_kernel_counts"] == 0


def test_the_counter_is_one_of_the_phase_totals():
    assert "n_kernel_counts" in COUNTERS
    _, pipe = _deliver([_output(1)])
    assert pipe.stats.phase_totals()["n_kernel_counts"] == 0


def _pod_count(shards):
    """``PodStreamingPipeline._count_of`` over the pod step's ``shards``
    on a pipeline of the CPU."""
    pod = SimpleNamespace(device=torch.device("cpu"))
    out = [Shard((k,), d) for k, d in enumerate(shards)]
    det, counted = PodStreamingPipeline._count_of(pod, out)
    return int(det), counted


@pytest.mark.parametrize("shards, want", [
    ([_output(2, detections=2), _output(5, detections=5)], (7, True)),
    ([_output(2, detections=3), _output(5)], (8, False)),
    ([_output(2), _output(5)], (7, False)),
    ([torch.zeros(2, 64, dtype=torch.int32)], (0, False)),
    ([], (0, False)),
], ids=["every shard's kernel", "one shard summed", "summed", "wire words",
        "no shard"])
def test_the_pod_takes_the_same_rule_over_its_shards(shards, want):
    assert _pod_count(shards) == want


def _run(delta):
    return Run(setup_s=1.0, window_s=10.0, samples_per_cpi=1,
               least_s_per_cpi=1e-4, stats_delta=delta)


def test_kernel_count_share_reader():
    read = cells.metric_reader("kernel_count_share.sat")
    assert read(_run({"n_kernel_counts": 250, "frames_out": 250})) == 1.0
    assert read(_run({"n_kernel_counts": 100, "frames_out": 400})) == 0.25
    assert read(_run({"n_kernel_counts": 0, "frames_out": 0})) is None
    # a program that keeps no such counter reads nothing, and raises
    # nothing
    assert read(_run({"frames_out": 250})) is None
    entry = [m for m in cells.load_benchmark()["per_layer"]
             if m["name"] == "kernel_count_share.sat"]
    assert len(entry) == 1
    assert entry[0]["moves"] == "card_ms_per_cpi"
    assert entry[0]["layer"] == "kernels" and entry[0]["unit"] == "share"
    assert entry[0]["workloads"] == ["int_gosca.gos_sat",
                                     "float_gosca.gos_sat"]
