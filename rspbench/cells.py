"""Resolve a cell of ``BENCHMARK.json`` to the files that define it.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything that belongs to one of them lives in a file of its own, found by
name, so that a later cell, mix or metric is added as files and entries:

* the configuration: the ``file`` of its ``configs`` entry
  (``rspbench/configs/<name>.json``), with its plain reference
  ``rspbench/reference/<reference>.py`` named inside it;
* the traffic mix: ``rspbench/traffic/<traffic>.json``;
* each metric: a reader ``rspbench/metrics/<base>.py``, where ``<base>`` is
  the metric's name up to its first dot (``dispatch_ms.sat`` and
  ``dispatch_ms.rate`` share ``dispatch_ms.py``; the suffix names the kind
  of traffic, ``sat`` a saturating closed loop). A reader defines
  ``read(run)`` and returns a number, or None where it finds nothing to
  read.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: tuple      # the BENCHMARK.json metric entries of this cell
    per_layer: tuple


def load_benchmark(root: Path = REPO) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _for_cell(metrics: list, cell: str) -> tuple:
    """The metric entries a cell reports: those without a ``workloads`` key,
    and those that list the cell."""
    return tuple(m for m in metrics
                 if "workloads" not in m or cell in m["workloads"])


def resolve(name: str, root: Path = REPO) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json`` with its configuration and
    traffic loaded; raises KeyError for an unknown cell."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    traffic = json.loads(
        (root / "rspbench" / "traffic" / f"{w['traffic']}.json").read_text())
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=_for_cell(bench["end_to_end"], name),
                per_layer=_for_cell(bench["per_layer"], name))


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, root: Path = REPO) -> Callable:
    """The ``read`` function of metric ``name``'s reader file."""
    base = name.split(".", 1)[0]
    path = root / "rspbench" / "metrics" / f"{base}.py"
    return _load_file(path, f"rspbench_metric_{base}").read


def reference(config: dict, root: Path = REPO):
    """The plain reference module that ``config`` names."""
    ref = config["reference"]
    return _load_file(root / "rspbench" / "reference" / f"{ref}.py",
                      f"rspbench_reference_{ref}")


def read_metrics(entries: tuple, run, root: Path = REPO) -> dict:
    """``{name: {"value", "unit"}}`` of every entry whose reader returns a
    number for ``run``; a reader that returns None is left out."""
    out = {}
    for m in entries:
        value: Optional[float] = metric_reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
