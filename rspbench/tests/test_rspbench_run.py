"""A run end to end on the CPU at a small size (the harness's look for a card
skipped), its result line, and that ``correct`` comes out false under the
control and under each fault the cells can have."""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from rspbench import cells, control, run
from rspbench_small import shrink, small_cell

from rsp_chains_tpu_torch.cplx import C
from rsp_chains_tpu_torch.ops.cfar import CfarOutput

SEED = 2**31 + 17
CELLS = [w["name"] for w in cells.load_benchmark()["workloads"]]
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "card",
               "checks"]


def _run(name, wrap=None, seconds=1.0):
    return run.run_cell(small_cell(name), SEED, seconds, False, device="cpu",
                        wrap_chain=wrap)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_reports_its_metrics(name):
    res = _run(name)
    assert list(res) == RESULT_KEYS
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    cell = cells.resolve(name)
    # on the CPU no device trace is taken: its metrics are left out
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end
                                   if m["source"] != "device_trace"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["device"]["platform"] == "cpu"
    json.dumps(res)


def test_open_loop_mix_reports_latencies_from_due_times():
    """The generator's open loop, kept for a later rate cell: CPIs due on a
    schedule, latencies from their due times, drops counted as failed."""
    base = cells.resolve("int_gosca.gos_sat")
    mix = {**base.traffic, "loop": "open", "drop_on_full": True,
           "rate_cpi_per_s": 10.0}
    cell = shrink(dataclasses.replace(base, traffic=mix))
    got = []
    res = run.run_cell(cell, SEED, 1.0, False, device="cpu", on_run=got.append)
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] == 10 and res["failed"] == 0
    r = got[0]
    assert len(r.latencies_s) == 10 and min(r.latencies_s) > 0
    assert r.latency_ms(50) <= r.latency_ms(95)


def test_closed_loop_blocks_on_the_pipelines_queue():
    """The closed loop takes its pace from ``submit``: nothing is dropped,
    and every CPI submitted in the window is delivered."""
    cell = small_cell("int_gosca.gos_sat")
    assert cell.traffic["loop"] == "closed"
    assert cell.traffic["drop_on_full"] is False
    got = []
    res = run.run_cell(cell, SEED, 1.0, False, device="cpu", on_run=got.append)
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["undelivered"]["value"] == 0
    assert got[0].delivered_in_window > 0


class _Stale:
    """A step that hands back the previous CPI's output."""

    def __init__(self, chain):
        self.chain, self.device, self.prev = chain, chain.device, None

    def __call__(self, x, rt):
        out = self.chain(x, rt)
        prev, self.prev = self.prev, out
        return out if prev is None else prev


class _HalfBatch:
    """Half of the channels left out: their threshold 0, no peaks."""

    def __init__(self, chain):
        self.chain, self.device = chain, chain.device

    def __call__(self, x, rt):
        h = x.shape[0] // 2
        out = self.chain(C(x.re[:h], x.im[:h]), rt)
        thr = torch.zeros(x.shape, dtype=out.threshold.dtype)
        pk = torch.zeros(x.shape, dtype=torch.bool)
        thr[:h], pk[:h] = out.threshold, out.peaks
        return CfarOutput(threshold=thr, peaks=pk)


class _Altered:
    """One answer altered where it is produced: one cell's threshold raised
    by a hundredth (at least 1) and its peak flag flipped."""

    def __init__(self, chain):
        self.chain, self.device = chain, chain.device

    def __call__(self, x, rt):
        out = self.chain(x, rt)
        thr, pk = out.threshold.clone(), out.peaks.clone()
        cell = (0, 0, 100)
        thr[cell] = thr[cell] + torch.clamp(thr[cell].abs() / 100, min=1)
        pk[cell] = ~pk[cell]
        return CfarOutput(threshold=thr, peaks=pk)


@pytest.mark.parametrize("fault", [_Stale, _HalfBatch, _Altered])
@pytest.mark.parametrize("name", ["int_gosca.gos_sat", "float_gosca.gos_sat"])
def test_a_fault_in_the_timed_path_is_not_correct(name, fault):
    res = _run(name, wrap=fault)
    assert res["correct"] is False, res["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The reference one precision lower in the program's place fails the
    configuration's limits."""
    cell = small_cell(name)
    vals = control.control_readings(cell, SEED, device="cpu")
    failed = [k for k, lim in cell.config["correct"].items()
              if not vals[k] <= lim]
    assert failed, vals


def test_without_a_card_the_run_fails_and_prints_no_result():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    p = subprocess.run(
        [sys.executable, "-m", "rspbench.run", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cells.REPO, env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_measurement_path_does_not_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                     "--trace", "0"]) == 2


def _imports(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    srcs = [p for p in cells.HERE.rglob("*.py") if "tests" not in p.parts]
    for p in srcs:
        assert not _imports(p) & set(run.FORBIDDEN), p
    code = ("import sys, importlib, pkgutil, rspbench, rspbench.reference\n"
            "for m in pkgutil.walk_packages(rspbench.__path__, 'rspbench.'):\n"
            "    if '.tests' not in m.name:\n"
            "        importlib.import_module(m.name)\n"
            "import rspbench.run as r\n"
            "r.build(r.cells.resolve('" + CELLS[0] + "').config, {}, 'cpu')\n"
            "print(r.forbidden_modules())\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=cells.REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rsp_chains_tpu_torch_x", sys)
    assert "rsp_chains_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax"]


@pytest.mark.cuda
def test_a_cell_on_the_card_prints_its_line():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "-m", "rspbench.run", "--workload", CELLS[0],
         "--seed", str(SEED), "--seconds", "2", "--trace", "1"],
        cwd=cells.REPO, capture_output=True, text=True, timeout=1200)
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(res)[-1] == "checks" and res["correct"] is True
    assert res["device"]["busy_s"] > 0
