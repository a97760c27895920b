#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit, and exits non-zero when CUDA is not
   available (there is no CPU fallback);
2. builds the CUDA kernels from ``rsp_chains_tpu_torch/csrc``;
3. holds each kernel against its plain PyTorch version at the headline shape,
   one CPI batch of 64 channels x 256 pulses x 1024 samples;
4. runs ``fft_mag_cfar_chain`` over a register sweep against the plain chain,
   with the launch counters reset just before and read just after, and checks
   the three-tone detections;
5. times each kernel and its plain version with CUDA events;
6. profiles the full-size kernel path, the plain path and the shrunken-size
   kernel path: device time per call of each stage and of the busiest device
   kernels, and the device memory a call allocates beyond its inputs.

The bar is the bench's (``bench.py:404``): max|dthr| / max|thr| < 1e-4 and
peak flips <= 1e-5 of the cells. Any failed check raises. The last line is the
JSON device record; the line before it lists the kernels.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

SHAPE = (64, 256, 1024)
REL_BAR = 1e-4
FLIP_BAR = 1e-5
SEED = 0
HEADLINE = dict(fft_size=1024, ref_window_size=32, guard_window_size=4,
                threshold_scaler=3.5, div_sum=5)
# register settings of the main-path sweep, each written over HEADLINE
SWEEP = [
    ("default CA", {}),
    ("GO", dict(cfar_mode=1)),
    ("SO", dict(cfar_mode=2)),
    ("ABS", dict(mag_mode=0)),
    ("SQR", dict(mag_mode=1)),
    ("LOG2", dict(mag_mode=3, log_or_linear=0, threshold_scaler=2.0)),
    ("grouping", dict(peak_grouping=1)),
    ("w64 g8", dict(ref_window_size=64, guard_window_size=8, div_sum=6)),
    ("w2 g1", dict(ref_window_size=2, guard_window_size=1, div_sum=1)),
    ("fft_size 512", dict(fft_size=512)),
    ("cfar_fft_size 768", dict(cfar_fft_size=768)),
]


def compare(got, want, what: str) -> float:
    """Check ``got`` against the plain ``want`` at the bar; return max|dthr|."""
    import torch

    torch.cuda.synchronize()
    if got.threshold.shape != want.threshold.shape or got.peaks.dtype != torch.bool:
        raise AssertionError(f"{what}: shape {tuple(got.threshold.shape)} / "
                             f"peaks {got.peaks.dtype}")
    if not bool(torch.isfinite(got.threshold).all()):
        raise AssertionError(f"{what}: non-finite threshold")
    dthr = (got.threshold - want.threshold).abs().max().item()
    rel = dthr / max(want.threshold.abs().max().item(), 1e-30)
    flips = int((got.peaks != want.peaks).sum().item())
    cells = want.peaks.numel()
    npk = int(want.peaks.sum().item())
    print(f"{what}: rel dthr {rel:.3e} (max|dthr| {dthr:.3e}), "
          f"peak flips {flips} of {cells} cells, {npk} peaks")
    if not (rel < REL_BAR and flips <= FLIP_BAR * cells):
        raise AssertionError(f"{what}: outside the bar")
    return dthr


def time_ms(fn, calls: int = 30, warm: int = 5) -> float:
    """Median ms per call over ``calls`` back-to-back calls, each bracketed by
    CUDA events, after ``warm`` calls."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(calls):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        events.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in events)


def profile(fn, label: str, stages, calls: int = 20, top: int = 5) -> None:
    """Print the device time per call of each stage range in ``stages`` and of
    the ``top`` busiest device kernels over ``calls`` calls of ``fn`` under
    ``torch.profiler``, and the peak device memory a call allocates."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as trace

    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    extra = (torch.cuda.max_memory_allocated() - base) / 2**20
    rows = prof.key_averages()
    total = sum(e.self_device_time_total for e in rows
                if e.self_cpu_time_total == 0 and e.key not in stages)
    print(f"profile [{label}]: device {total / calls / 1e3:.4f} ms a call in "
          f"kernels, {extra:.1f} MiB allocated beyond the inputs")
    for name in stages:
        us = max((e.device_time_total for e in rows if e.key == name), default=0.0)
        print(f"  stage {name}: {us / calls / 1e3:.4f} ms")
    kernels = sorted((e for e in rows if e.self_cpu_time_total == 0
                      and e.key not in stages and e.self_device_time_total > 0),
                     key=lambda e: -e.self_device_time_total)
    for e in kernels[:top]:
        print(f"  kernel {e.key[:70]}: {e.self_device_time_total / calls / 1e3:.4f} ms, "
              f"{e.count // calls} a call")


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)

    import rsp_chains_tpu_torch as rsp
    from rsp_chains_tpu_torch.kernels import _build
    from rsp_chains_tpu_torch.kernels import cfar as kcfar
    from rsp_chains_tpu_torch.kernels import chain as kchain
    from rsp_chains_tpu_torch.ops.fft import fft_op

    dev = torch.device("cuda", 0)
    # the plain path must be true fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- build ----
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({_build.library_path().name}); compiler report:")
    print(_build.build_log().strip())

    cfg = rsp.ChainConfig(
        fft=rsp.FftConfig(max_size=SHAPE[-1]),
        cfar=rsp.CfarConfig(max_ref_window=64, variant=rsp.CfarVariant.CA,
                            include_cash=False, max_fft_size=SHAPE[-1]))
    plain_cfg = dataclasses.replace(
        cfg, cfar=dataclasses.replace(cfg.cfar, use_pallas=False))
    rng = np.random.RandomState(SEED)
    x = rsp.as_pair(rng.randn(*SHAPE).astype(np.float32)
                    + 1j * rng.randn(*SHAPE).astype(np.float32), device=dev)
    rt = rsp.RuntimeConfig.make(**HEADLINE)
    samples = x.re.numel()

    # ---- each kernel against its plain version ----
    err_a = compare(kchain.chain_ca(x, rt, cfg.fft, cfg.cfar),
                    kchain.chain_ca_reference(x, rt, cfg.fft, cfg.cfar),
                    "chain_ca vs chain_ca_reference")
    spec = fft_op(x, None, cfg.fft)
    err_b = compare(kcfar.mag_cfar(spec, rt, cfg.cfar),
                    kcfar.mag_cfar_reference(spec, rt, cfg.cfar),
                    "mag_cfar vs mag_cfar_reference")

    # ---- the main path through the public entry point ----
    chain = rsp.fft_mag_cfar_chain(cfg)
    plain = rsp.fft_mag_cfar_chain(plain_cfg)
    assert chain.stage_names == ("fft_mag_cfar_fused",), chain.stage_names
    assert plain.stage_names == ("fft", "logmag", "cfar"), plain.stage_names
    iq = rsp.as_pair(rsp.golden.three_tone_signal(SHAPE[-1],
                                                  shift_range_factor=12),
                     device=dev)
    kchain.LAUNCHES = 0
    kcfar.LAUNCHES = 0
    for name, kw in SWEEP:
        rt_s = rsp.RuntimeConfig.make(**{**HEADLINE, **kw})
        compare(chain(x, rt_s), plain(x, rt_s), f"main path [{name}]")
    det = np.flatnonzero(chain(iq, rt).peaks.cpu().numpy())
    launches = {"chain_ca": kchain.LAUNCHES, "mag_cfar": kcfar.LAUNCHES}
    print(f"main path launches: {launches}; library builds: {_build.BUILDS}")
    print(f"three-tone detections: {det.tolist()}")
    if det.tolist() != [0, 128, 256, 512]:
        raise AssertionError("three-tone detections differ from [0, 128, 256, 512]")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    if _build.BUILDS != 1:
        raise AssertionError(f"library built {_build.BUILDS} times, not once")

    # ---- timing at the headline shape ----
    moved = 13 * samples  # bytes: 8 in, 4 + 1 out per complex sample
    times = {
        "chain_ca": (time_ms(lambda: kchain.chain_ca(x, rt, cfg.fft, cfg.cfar)),
                     time_ms(lambda: kchain.chain_ca_reference(
                         x, rt, cfg.fft, cfg.cfar))),
        "mag_cfar": (time_ms(lambda: kcfar.mag_cfar(spec, rt, cfg.cfar)),
                     time_ms(lambda: kcfar.mag_cfar_reference(
                         spec, rt, cfg.cfar))),
        "fft_mag_cfar_chain": (time_ms(lambda: chain(x, rt)),
                               time_ms(lambda: plain(x, rt))),
    }
    for name, (ms, plain_ms) in times.items():
        print(f"{name} at {'x'.join(map(str, SHAPE))}: kernel path {ms:.4f} ms "
              f"= {samples / ms / 1e3:.1f} Msamples/s "
              f"({moved / ms / 1e6:.1f} GB/s of 13 B/sample); plain path "
              f"{plain_ms:.4f} ms = {samples / plain_ms / 1e3:.1f} Msamples/s; "
              f"card {card}")

    # ---- where the time goes ----
    small = rt.merge_regs(fft_size=512)
    profile(lambda: chain(x, rt), "kernel path, full size",
            chain.stage_names)
    profile(lambda: plain(x, rt), "plain path, full size", plain.stage_names)
    profile(lambda: chain(x, small), "kernel path, fft_size 512",
            chain.stage_names)

    kernels = [
        {"name": "chain_ca", "route": "cuda",
         "source": "rsp_chains_tpu_torch/csrc/chain_ca.cu",
         "replaces": "rsp_chains_tpu/kernels/chain_pallas.py:841",
         "launches": launches["chain_ca"], "max_abs_err": err_a,
         "ms": times["chain_ca"][0], "plain_ms": times["chain_ca"][1]},
        {"name": "mag_cfar", "route": "cuda",
         "source": "rsp_chains_tpu_torch/csrc/mag_cfar.cu",
         "replaces": "rsp_chains_tpu/kernels/cfar_pallas.py:489",
         "launches": launches["mag_cfar"], "max_abs_err": err_b,
         "ms": times["mag_cfar"][0], "plain_ms": times["mag_cfar"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
