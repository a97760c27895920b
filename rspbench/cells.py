"""Resolve a cell of ``BENCHMARK.json`` to the files that define it.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Everything that belongs to one of them lives in a file of its own, found by
name, so that a later cell, mix, configuration, chain, scene or metric is
added as files and entries:

* the configuration: the ``file`` of its ``configs`` entry
  (``rspbench/configs/<name>.json``), which names inside it
  - its plain reference, ``rspbench/reference/<reference>.py``, which
    defines ``chain``;
  - its chain, ``rspbench/chains/<chain>.py`` (the top-level key
    ``chain``; ``fft_mag_cfar`` where the key is absent), which defines
    ``build(config, mix, device) -> (chain, rt)``, the program under test
    that the pipeline calls as ``chain(x, rt)`` with its register file, and
    ``work(config)``, the bytes, operations and least time of one CPI
    (``roofline.cpi_work``);
  - its scene, ``rspbench/scenes/<kind>.py`` (``scene.kind``;
    ``fmcw_beat`` where the key is absent), which defines
    ``make_cpi(config, g, device) -> (re, im)``, one CPI's float planes
    drawn from the generator ``g`` (``inputs.make_ring``);
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
DEFAULT_CHAIN = "fft_mag_cfar"
DEFAULT_SCENE = "fmcw_beat"


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


def registers(config: dict, mix: dict) -> dict:
    """The configuration's registers with the mix's writes: what the chain
    file's ``build`` reads and the reference is handed (a chain with a
    second register record keeps it here under a key of its own)."""
    return {**config["registers"], **mix.get("registers", {})}


def _load_file(path: Path, module_name: str):
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(root: Path, folder: str, name: str):
    """The module of ``rspbench/<folder>/<name>.py`` under ``root``."""
    return _load_file(root / "rspbench" / folder / f"{name}.py",
                      f"rspbench_{folder}_{name}")


def metric_reader(name: str, root: Path = REPO) -> Callable:
    """The ``read`` function of metric ``name``'s reader file."""
    return _named(root, "metrics", name.split(".", 1)[0]).read


def reference(config: dict, root: Path = REPO):
    """The plain reference module that ``config`` names."""
    return _named(root, "reference", config["reference"])


def chain(config: dict, root: Path = REPO):
    """The chain module that ``config`` names."""
    return _named(root, "chains", config.get("chain", DEFAULT_CHAIN))


def scene(config: dict, root: Path = REPO):
    """The scene module that ``config``'s scene names."""
    return _named(root, "scenes", config["scene"].get("kind", DEFAULT_SCENE))


def read_metrics(entries: tuple, run, root: Path = REPO) -> dict:
    """``{name: {"value", "unit"}}`` of every entry whose reader returns a
    number for ``run``; a reader that returns None is left out."""
    out = {}
    for m in entries:
        value: Optional[float] = metric_reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
