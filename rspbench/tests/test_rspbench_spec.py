"""BENCHMARK.json and the files it names: every cell resolves to its
configuration, traffic mix and metric readers; a cell added as files alone
is found; the limits of the contract on names, units and sizes hold."""

from __future__ import annotations

import json
import re
import shutil

import pytest

from rspbench import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = cells.load_benchmark()
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_top_level_keys_and_size():
    assert set(BENCH) == KEYS
    assert (cells.REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["rspbench"]
    assert len(BENCH["command"]) <= 32


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    c = cells.resolve(cell)
    el = c.config["elaboration"]
    assert c.config["cpi"]["samples"] == el["fft_max_size"]
    assert c.traffic["loop"] in ("open", "closed")
    if c.traffic["loop"] == "open":
        assert c.traffic["rate_cpi_per_s"] > 0
    assert cells.reference(c.config).chain
    names = [m["name"] for m in c.end_to_end + c.per_layer]
    assert "setup_s" in names
    assert len(c.end_to_end) >= 2 and c.per_layer
    for name in names:
        assert callable(cells.metric_reader(name))


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_keys(section):
    allowed = {
        "configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source",
                       "workloads"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                      "workloads"},
    }[section]
    entries = BENCH[section]
    assert len({e["name"] for e in entries}) == len(entries)
    cell_names = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for e in entries:
        assert set(e) <= allowed, set(e) - allowed
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if "workloads" in e:
            assert set(e["workloads"]) <= cell_names
        if section == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if section == "per_layer":
            moved = e2e[e["moves"]]
            assert set(e["workloads"]) <= set(moved.get("workloads",
                                                        cell_names))
        if section == "configs":
            assert (cells.REPO / e["file"]).is_file()
            assert all(NAME.match(k) for k in e["reduced"])
        if section == "workloads":
            assert e["chips"] in (1, 4)
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])


def test_new_cell_is_found_from_files_alone(tmp_path):
    """A cell, a traffic mix, a configuration and a metric added as new
    files and entries, in a copy of the benchmark, resolve with no edit of
    the harness."""
    shutil.copytree(cells.HERE, tmp_path / "rspbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    config = json.loads((cells.REPO / bench["configs"][0]["file"]).read_text())
    config["cpi"]["channels"] = 128
    (tmp_path / "rspbench/configs/wide.json").write_text(json.dumps(config))
    mix = cells.resolve("int_gosca.gos_sat").traffic
    (tmp_path / "rspbench/traffic/burst.json").write_text(
        json.dumps({**mix, "depth": 16}))
    (tmp_path / "rspbench/metrics/cpis_in_window.py").write_text(
        "def read(run):\n    return run.delivered_in_window\n")
    bench["configs"].append({"name": "wide", "source": "x", "why": "x",
                             "file": "rspbench/configs/wide.json",
                             "reduced": []})
    bench["workloads"].append({"name": "wide.burst", "config": "wide",
                               "traffic": "burst", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "cpis_in_window.sat", "unit": "CPIs",
                               "better": "higher", "source": "host_clock",
                               "layer": "stream", "moves": "card_ms_per_cpi",
                               "workloads": ["wide.burst"]})
    bench["end_to_end"][0]["workloads"].append("wide.burst")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    c = cells.resolve("wide.burst", root=tmp_path)
    assert c.config["cpi"]["channels"] == 128 and c.traffic["depth"] == 16
    assert [m["name"] for m in c.per_layer] == ["cpis_in_window.sat"]

    class R:
        delivered_in_window = 7

    got = cells.read_metrics(c.per_layer, R(), root=tmp_path)
    assert got == {"cpis_in_window.sat": {"value": 7.0, "unit": "CPIs"}}


@pytest.mark.parametrize("path", sorted(
    p.relative_to(cells.HERE).as_posix()
    for d in ("configs", "traffic") for p in (cells.HERE / d).glob("*.json")))
def test_every_config_and_traffic_file_loads(path):
    data = json.loads((cells.HERE / path).read_text())
    if path.startswith("configs/"):
        assert data["name"] == path[len("configs/"):-len(".json")]
        assert cells.reference(data).chain
        assert set(data["reduced"]) <= set(data)
    else:
        assert data["loop"] in ("open", "closed")
        assert (data["loop"] == "open") == ("rate_cpi_per_s" in data)


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        cells.resolve("no_such.cell")
