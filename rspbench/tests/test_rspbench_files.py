"""A configuration's chain, scene and roofline work found from files by name:
the shipped configurations resolve to ``fft_mag_cfar`` and ``fmcw_beat`` and
read the same work and the same rings as before, and a configuration of
another chain, with its own chain, scene and reference files, runs through
``run_cell`` to a ``correct`` result with no edit of the harness."""

from __future__ import annotations

import json
import math
import shutil

import pytest
import torch

from rspbench import cells, inputs, roofline, run

SHIPPED = {"rsp_vanilla_int_gosca": "int_gosca.gos_sat",
           "fftmagcfar_float_gosca": "float_gosca.gos_sat"}


def _shipped(name):
    entry = next(c for c in cells.load_benchmark()["configs"]
                 if c["name"] == name)
    return json.loads((cells.REPO / entry["file"]).read_text())


def _frozen_make_cpi(config, g, device):
    """The ring's CPI as the harness made it before scenes were files."""
    def uniform(n, lo, hi):
        return lo + (hi - lo) * torch.rand(n, generator=g, device=device,
                                           dtype=torch.float64)

    cpi, scene, inp = config["cpi"], config["scene"], config["input"]
    c, p, n = cpi["channels"], cpi["pulses"], cpi["samples"]
    sigma = float(scene["noise_sigma"])
    re = torch.randn((c, p, n), generator=g, device=device) * sigma
    im = torch.randn((c, p, n), generator=g, device=device) * sigma
    k = int(scene["targets"])
    guard = int(scene["guard_bins"])
    lo_db, hi_db = scene["bin_snr_db"]
    bins = uniform(k, guard, n - guard)
    doppler = uniform(k, -0.5, 0.5)
    angle = uniform(k, -0.5, 0.5)
    phase0 = uniform(k, 0.0, 1.0)
    snr_db = uniform(k, lo_db, hi_db)
    amp = torch.sqrt(2.0 * sigma * sigma * 10.0 ** (snr_db / 10.0) / n)
    ci = torch.arange(c, device=device, dtype=torch.float64)[:, None, None]
    pi = torch.arange(p, device=device, dtype=torch.float64)[None, :, None]
    ni = torch.arange(n, device=device, dtype=torch.float64)[None, None, :]
    for t in range(k):
        cyc = torch.remainder(bins[t] / n * ni + doppler[t] * pi
                              + angle[t] * ci + phase0[t], 1.0)
        ph = (2.0 * math.pi * cyc).to(torch.float32)
        a = float(amp[t])
        re += a * torch.cos(ph)
        im += a * torch.sin(ph)
    if inp["kind"] == "int16":
        scale, clip = float(inp["scale"]), float(inp["clip"])
        re = torch.round(torch.clamp(re * scale, -clip, clip)).to(torch.int32)
        im = torch.round(torch.clamp(im * scale, -clip, clip)).to(torch.int32)
    return re.contiguous(), im.contiguous()


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_shipped_configs_name_the_default_chain_and_scene(name):
    config = _shipped(name)
    assert "chain" not in config and "kind" not in config["scene"]
    assert cells.chain(config).__file__.endswith("chains/fft_mag_cfar.py")
    assert cells.scene(config).__file__.endswith("scenes/fmcw_beat.py")
    assert cells.resolve(SHIPPED[name]).config == config


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_shipped_work_is_the_kernel_tables(name):
    """13 B a sample of 64 x 256 x 1024 at 3.35 TB/s, 0.065106 ms, above
    the operations' 0.0426 ms (bit-true) and 0.0125 ms (float)."""
    w = roofline.cpi_work(_shipped(name))
    samples = 64 * 256 * 1024
    assert w["samples"] == samples and w["bytes"] == 13 * samples
    assert w["bytes_s"] == 13 * samples / 3.35e12
    if name.startswith("rsp_vanilla"):
        assert w["ops"] == 8.5 * 10 * samples
        assert w["ops_s"] == w["ops"] / 33.5e12
        assert round(w["ops_s"] * 1e3, 4) == 0.0426
    else:
        assert w["ops"] == 5.0 * 1024 * 10 * (samples // 1024)
        assert w["ops_s"] == w["ops"] / 67e12
        assert round(w["ops_s"] * 1e3, 4) == 0.0125
    assert w["least_s"] == w["bytes_s"] and w["bound_by"] == "bytes"
    assert round(w["least_s"] * 1e3, 6) == 0.065106


@pytest.mark.parametrize("samples", [64, 1024])
@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_shipped_ring_is_bit_equal_to_the_frozen_scene(name, samples):
    config = _shipped(name)
    config["cpi"] = {"channels": 2, "pulses": 8, "samples": samples}
    ring = inputs.make_ring(config, 3, 7, "cpu")
    g = torch.Generator(device="cpu")
    g.manual_seed(7)
    for re, im in ring:
        fre, fim = _frozen_make_cpi(config, g, "cpu")
        assert re.dtype == fre.dtype
        assert torch.equal(re, fre) and torch.equal(im, fim)


# A range-Doppler chain (matched filter, Doppler FFT, magnitude, CA-CFAR
# along range), added as files alone: its chain, scene and reference.
CHIRP = ("def chirp(m):\n"
         "    t = np.arange(m, dtype=np.float64)\n"
         "    return np.exp(1j * np.pi * (0.25 / m) * t * t)\n")

RD_CHAIN = '''
import math

import numpy as np

from rspbench import cells, roofline

FAULT = {fault}
''' + CHIRP + '''

def build(config, mix, device):
    import rsp_chains_tpu_torch as rsp
    from rsp_chains_tpu_torch.ops.cfar import CfarOutput

    el, cpi = config["elaboration"], config["cpi"]
    n, p = cpi["samples"], cpi["pulses"]
    cfg = rsp.ChainConfig(
        fft=rsp.FftConfig(max_size=n),
        matched_filter=rsp.MatchedFilterConfig(
            num_taps=config["waveform"]["taps"], fft_size=n),
        doppler=rsp.DopplerConfig(num_pulses=p, window=None),
        cfar=rsp.CfarConfig(variant=rsp.CfarVariant.CA, include_cash=False,
                            max_ref_window=el["max_ref_window"],
                            max_guard_window=el["max_guard_window"],
                            max_fft_size=n))
    rt = rsp.RuntimeConfig.make(**cells.registers(config, mix),
                                validate_against=cfg.cfar)
    chain = rsp.range_doppler_chain(
        cfg, taps=chirp(config["waveform"]["taps"]), device=device)
    if not FAULT:
        return chain, rt

    def altered(x, rt):
        out = chain(x, rt)
        return CfarOutput(threshold=out.threshold * 1.01, peaks=out.peaks)

    altered.device = chain.device
    return altered, rt


def work(config):
    cpi = config["cpi"]
    c, p, n = cpi["channels"], cpi["pulses"], cpi["samples"]
    samples = c * p * n
    ops = ((10 * n * math.log2(n) + 6 * n) * c * p
           + 5 * p * math.log2(p) * c * n)
    return roofline.least(samples, 13 * samples, ops, roofline.FP32_PER_S)
'''

RD_SCENE = '''
import numpy as np
import torch

from rspbench.inputs import uniform
''' + CHIRP + '''

def make_cpi(config, g, device):
    cpi, scene = config["cpi"], config["scene"]
    c, p, n = cpi["channels"], cpi["pulses"], cpi["samples"]
    m = config["waveform"]["taps"]
    sigma = float(scene["noise_sigma"])
    re = torch.randn((c, p, n), generator=g, device=device) * sigma
    im = torch.randn((c, p, n), generator=g, device=device) * sigma
    k = int(scene["targets"])
    delay = uniform(g, k, 0, n - m, device).floor()
    doppler = uniform(g, k, -0.5, 0.5, device)
    w = torch.from_numpy(chirp(m)).to(device)
    pi = torch.arange(p, device=device, dtype=torch.float64)
    for t in range(k):
        d = int(delay[t])
        sig = float(scene["amplitude"]) * w[None, :] * torch.exp(
            2j * np.pi * doppler[t] * pi)[:, None]
        re[:, :, d:d + m] += sig.real.float()
        im[:, :, d:d + m] += sig.imag.float()
    return re, im
'''

RD_REFERENCE = '''
import math

import numpy as np
import torch

from rspbench.reference.float_chain import _combine, _jpl, _windows

TAPS = 16   # the configuration's waveform: a reference is written for it
''' + CHIRP + '''

def chain(re, im, regs, dtype=torch.float64):
    c, p, n = re.shape
    x = torch.complex(re.to(torch.float64), im.to(torch.float64))
    taps = torch.from_numpy(chirp(TAPS))
    h = torch.conj(torch.fft.fft(taps, n)) / math.sqrt(
        float((taps.abs() ** 2).sum()))
    y = torch.fft.ifft(torch.fft.fft(x, dim=-1) * h, dim=-1)
    y = torch.roll(torch.fft.fft(y, dim=-2) / p, p // 2, dims=-2)
    mag = _jpl(y.real.to(dtype), y.imag.to(dtype)).reshape(-1, n)
    w, g = int(regs["ref_window_size"]), int(regs["guard_window_size"])
    lag, lead = _windows(mag, w, g, 0.0)
    div = 2.0 ** int(regs["div_sum"])
    thr = _combine(int(regs["cfar_mode"]), lag.sum(-1) / div,
                   lead.sum(-1) / div) * float(regs["threshold_scaler"])
    return thr.reshape(c, p, n), (mag > thr).reshape(c, p, n)
'''

RD_CONFIG = {
    "name": "rd_tiny", "chain": "rd_ca_tiny",
    "elaboration": {"max_ref_window": 16, "max_guard_window": 8},
    "numeric_format": "float32",
    "cpi": {"channels": 2, "pulses": 16, "samples": 64},
    "waveform": {"taps": 16},
    "registers": {"fft_size": 64, "mag_mode": 2, "cfar_mode": 0,
                  "cfar_algorithm": 0, "ref_window_size": 8,
                  "guard_window_size": 2, "threshold_scaler": 3.5,
                  "div_sum": 3, "index_lagg": 4, "index_lead": 4,
                  "log_or_linear": 1, "peak_grouping": 0},
    "input": {"kind": "float32", "scale": 1.0, "clip": None},
    "scene": {"kind": "pulsed_chirp", "targets": 3, "amplitude": 2.0,
              "noise_sigma": 1.0},
    "reference": "rd_ca_tiny",
    "correct": {"thr_rel_err": 1e-3, "peak_flip_frac": 1e-3, "count_gap": 2,
                "undelivered": 0},
}


def _rd_root(tmp_path):
    """A copy of the benchmark with the range-Doppler configuration added as
    files and entries, a sound cell and one whose chain alters its output."""
    shutil.copytree(cells.HERE, tmp_path / "rspbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    b = tmp_path / "rspbench"
    (b / "chains/rd_ca_tiny.py").write_text(RD_CHAIN.format(fault=False))
    (b / "chains/rd_ca_tiny_altered.py").write_text(
        RD_CHAIN.format(fault=True))
    (b / "scenes/pulsed_chirp.py").write_text(RD_SCENE)
    (b / "reference/rd_ca_tiny.py").write_text(RD_REFERENCE)
    bench = cells.load_benchmark()
    for name, chain in (("rd_tiny", "rd_ca_tiny"),
                        ("rd_tiny_altered", "rd_ca_tiny_altered")):
        (b / f"configs/{name}.json").write_text(
            json.dumps({**RD_CONFIG, "name": name, "chain": chain}))
        bench["configs"].append({"name": name, "source": "x", "why": "x",
                                 "file": f"rspbench/configs/{name}.json",
                                 "reduced": []})
        bench["workloads"].append({"name": f"{name}.ca_sat", "config": name,
                                   "traffic": "ca_sat", "chips": 1,
                                   "why": "x"})
    mix = cells.resolve("int_gosca.gos_sat").traffic
    (b / "traffic/ca_sat.json").write_text(json.dumps(
        {**mix, "warmup_cpis": 12, "registers": {"cfar_algorithm": 0}}))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_a_new_chain_runs_from_files_alone(tmp_path):
    root = _rd_root(tmp_path)
    cell = cells.resolve("rd_tiny.ca_sat", root=root)
    res = run.run_cell(cell, 2**31 + 23, 1.0, False, device="cpu",
                       root=root)
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["sampled"]["value"] > 0
    work = cells.chain(cell.config, root).work(cell.config)
    assert res["card"]["least_ms_per_cpi"] == work["least_s"] * 1e3
    # the range-Doppler work, not the range FFT's
    assert work["ops"] != cells.chain({}).work(
        {**cell.config, "numeric_format": "float32"})["ops"]
    assert not (cells.REPO / "rspbench/chains/rd_ca_tiny.py").exists()


def test_a_faulty_new_chain_is_not_correct(tmp_path):
    root = _rd_root(tmp_path)
    cell = cells.resolve("rd_tiny_altered.ca_sat", root=root)
    res = run.run_cell(cell, 2**31 + 29, 1.0, False, device="cpu",
                       root=root)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["thr_rel_err"]["value"] > 1e-3
