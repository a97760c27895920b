#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the card's name and power limit, and exits non-zero when CUDA is not
   available (there is no CPU fallback);
2. builds the CUDA kernels from ``rsp_chains_tpu_torch/csrc``;
3. holds each of the four kernels against its plain PyTorch version at the
   headline shape, one CPI batch of 64 channels x 256 pulses x 1024 samples:
   Kernels A and B under a CA elaboration, Kernels C and D under the default
   ``ChainConfig()`` (GOSCA + CASH) with GOS registers. The plain GOS versions
   gather every cell's window (4.3 GB a side at this shape), so they run, and
   are compared and timed, over 8-channel chunks;
4. runs ``fft_mag_cfar_chain`` over a register sweep against the plain chain,
   once for the CA elaboration at the full batch and once for the default
   elaboration on an 8-channel slice, each with the launch counters reset just
   before and read just after, and checks the three-tone detections of both;
5. times each kernel and its plain version, and both chains, with CUDA events;
6. profiles the full-size kernel path, the plain path, the shrunken-size
   kernel path and the default chain's GOS path: device time per call of each
   stage and of the busiest device kernels, and the device memory a call
   allocates beyond its inputs.

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
# the JAX bench's GOS registers (bench.py:600-603) over HEADLINE
GOS_REGS = dict(HEADLINE, cfar_algorithm=1, index_lagg=16, index_lead=16)
GOS_CHUNK = 8  # channels per call of a plain GOS version
# register settings of the default elaboration's sweep, each written over
# GOS_REGS, with the kernel each must launch; the third item is written raw,
# past make()'s rules, as a register write on a running chain can
GOS_SWEEP = [
    ("GOS CA mode", {}, {}, "chain_gos"),
    ("GOS GO", dict(cfar_mode=1), {}, "chain_gos"),
    ("GOS SO", dict(cfar_mode=2), {}, "chain_gos"),
    ("ranks 8/24", dict(index_lagg=8, index_lead=24), {}, "chain_gos"),
    ("rank 0", dict(index_lagg=0, index_lead=0), {}, "chain_gos"),
    ("rank >= window", {}, dict(index_lagg=40, index_lead=64), "chain_gos"),
    ("CASH sub_w 8", dict(cfar_mode=3, sub_window_size=8), {}, "chain_gos"),
    ("CASH sub_w 2", dict(cfar_mode=3, sub_window_size=2), {}, "chain_gos"),
    ("CASH sub_w > w", dict(cfar_mode=3, mag_mode=3, log_or_linear=0,
                            threshold_scaler=2.0), dict(sub_window_size=64),
     "chain_gos"),
    ("CA algorithm", dict(cfar_algorithm=0), {}, "chain_ca"),
    ("GOS LOG2", dict(mag_mode=3, log_or_linear=0, threshold_scaler=2.0), {},
     "chain_gos"),
    ("GOS grouping", dict(peak_grouping=1), {}, "chain_gos"),
    ("GOS w64 g8", dict(ref_window_size=64, guard_window_size=8, div_sum=6,
                        index_lagg=40, index_lead=40), {}, "chain_gos"),
    ("GOS fft_size 512", dict(fft_size=512), {}, "mag_gos_cfar"),
    ("CA fft_size 512", dict(fft_size=512, cfar_algorithm=0), {}, "mag_cfar"),
    ("CASH cfar_fft_size 768", dict(cfar_mode=3, sub_window_size=4,
                                    cfar_fft_size=768), {}, "chain_gos"),
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


def chunked(fn, x, chunk: int = GOS_CHUNK):
    """``fn`` over the channel chunks of the frames ``x`` ([channels, ...]),
    outputs concatenated: the plain GOS versions at the headline shape."""
    import torch

    from rsp_chains_tpu_torch import C, CfarOutput

    outs = [fn(C(x.re[i:i + chunk], x.im[i:i + chunk]))
            for i in range(0, x.shape[0], chunk)]
    return CfarOutput(threshold=torch.cat([o.threshold for o in outs]),
                      peaks=torch.cat([o.peaks for o in outs]))


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

    launched = _build.LAUNCHES
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

    gcfg = rsp.ChainConfig()  # the default elaboration: GOSCA + CASH
    gplain_cfg = dataclasses.replace(
        gcfg, cfar=dataclasses.replace(gcfg.cfar, use_pallas=False))
    grt = rsp.RuntimeConfig.make(**GOS_REGS)
    print(f"plain GOS versions run over {GOS_CHUNK}-channel chunks of the "
          f"{SHAPE[0]} channels (their window stacks)")
    err_d = compare(kchain.chain_gos(x, grt, gcfg.fft, gcfg.cfar),
                    chunked(lambda c: kchain.chain_gos_reference(
                        c, grt, gcfg.fft, gcfg.cfar), x),
                    "chain_gos vs chain_gos_reference")
    err_c = compare(kcfar.mag_gos_cfar(spec, grt, gcfg.cfar),
                    chunked(lambda c: kcfar.mag_gos_cfar_reference(
                        c, grt, gcfg.cfar), spec),
                    "mag_gos_cfar vs mag_gos_cfar_reference")

    # ---- the main path through the public entry point ----
    chain = rsp.fft_mag_cfar_chain(cfg)
    plain = rsp.fft_mag_cfar_chain(plain_cfg)
    assert chain.stage_names == ("fft_mag_cfar_fused",), chain.stage_names
    assert plain.stage_names == ("fft", "logmag", "cfar"), plain.stage_names
    iq = rsp.as_pair(rsp.golden.three_tone_signal(SHAPE[-1],
                                                  shift_range_factor=12),
                     device=dev)
    launched.clear()
    for name, kw in SWEEP:
        rt_s = rsp.RuntimeConfig.make(**{**HEADLINE, **kw})
        compare(chain(x, rt_s), plain(x, rt_s), f"main path [{name}]")
    det = np.flatnonzero(chain(iq, rt).peaks.cpu().numpy())
    ca_launches = {k: launched[k] for k in ("chain_ca", "mag_cfar")}
    print(f"CA main path launches: {ca_launches}")
    print(f"three-tone detections (CA): {det.tolist()}")
    if det.tolist() != [0, 128, 256, 512]:
        raise AssertionError("three-tone detections differ from [0, 128, 256, 512]")
    if min(ca_launches.values()) < 1:
        raise AssertionError(f"a kernel of the CA path never launched: {ca_launches}")

    # ---- the default elaboration's main path ----
    gchain = rsp.fft_mag_cfar_chain()
    gplain = rsp.fft_mag_cfar_chain(gplain_cfg)
    pure_cfg = rsp.ChainConfig(cfar=rsp.CfarConfig(
        variant=rsp.CfarVariant.GOS, include_cash=False))
    pure = rsp.fft_mag_cfar_chain(pure_cfg)
    pure_plain = rsp.fft_mag_cfar_chain(dataclasses.replace(
        pure_cfg, cfar=dataclasses.replace(pure_cfg.cfar, use_pallas=False)))
    for c in (gchain, pure):
        assert c.stage_names == ("fft_mag_gos_cfar_fused",), c.stage_names
    xs = rsp.C(x.re[:GOS_CHUNK], x.im[:GOS_CHUNK])
    launched.clear()
    for name, kw, raw, kernel in GOS_SWEEP:
        rt_s = dataclasses.replace(rsp.RuntimeConfig.make(**{**GOS_REGS, **kw}),
                                   **raw)
        before = launched[kernel]
        compare(gchain(xs, rt_s), gplain(xs, rt_s), f"default chain [{name}]")
        if launched[kernel] != before + 1:
            raise AssertionError(f"default chain [{name}] did not launch {kernel}")
    # a pure-GOS elaboration with the algorithm register left at 0 still
    # takes order statistics (it has no CA datapath)
    rt_pure = rsp.RuntimeConfig.make(**{**GOS_REGS, "cfar_algorithm": 0})
    before = launched["chain_gos"]
    compare(pure(xs, rt_pure), pure_plain(xs, rt_pure),
            "pure-GOS chain [algorithm register 0]")
    if launched["chain_gos"] != before + 1:
        raise AssertionError("the pure-GOS chain did not launch chain_gos")
    gdet = np.flatnonzero(gchain(iq, grt).peaks.cpu().numpy())
    gos_launches = dict(launched)
    print(f"default-chain main path launches: {gos_launches}; "
          f"library builds: {_build.BUILDS}")
    print(f"three-tone detections (default chain, GOS registers): "
          f"{gdet.tolist()}")
    if gdet.tolist() != [0, 128, 256, 512]:
        raise AssertionError("default-chain three-tone detections differ from "
                             "[0, 128, 256, 512]")
    if min(gos_launches.get(k, 0) for k in ("chain_ca", "mag_cfar",
                                            "mag_gos_cfar", "chain_gos")) < 1:
        raise AssertionError(f"a kernel of the default path never launched: "
                             f"{gos_launches}")
    if _build.BUILDS != 1:
        raise AssertionError(f"library built {_build.BUILDS} times, not once")
    launches = {k: ca_launches.get(k, 0) + gos_launches.get(k, 0)
                for k in ("chain_ca", "mag_cfar", "mag_gos_cfar", "chain_gos")}

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
        "chain_gos": (time_ms(lambda: kchain.chain_gos(x, grt, gcfg.fft,
                                                        gcfg.cfar)),
                      time_ms(lambda: chunked(lambda c: kchain.chain_gos_reference(
                          c, grt, gcfg.fft, gcfg.cfar), x), calls=10, warm=1)),
        "mag_gos_cfar": (time_ms(lambda: kcfar.mag_gos_cfar(spec, grt,
                                                            gcfg.cfar)),
                         time_ms(lambda: chunked(
                             lambda c: kcfar.mag_gos_cfar_reference(
                                 c, grt, gcfg.cfar), spec), calls=10, warm=1)),
        "default fft_mag_cfar_chain, GOS registers": (
            time_ms(lambda: gchain(x, grt)),
            time_ms(lambda: chunked(lambda c: gplain(c, grt), x), calls=10,
                    warm=1)),
    }
    print(f"plain GOS times are of the {SHAPE[0]} channels in "
          f"{GOS_CHUNK}-channel chunks")
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
    profile(lambda: gchain(x, grt), "default chain, GOS registers",
            gchain.stage_names)

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
        {"name": "mag_gos_cfar", "route": "cuda",
         "source": "rsp_chains_tpu_torch/csrc/mag_gos_cfar.cu",
         "replaces": "rsp_chains_tpu/kernels/cfar_pallas.py:1593",
         "launches": launches["mag_gos_cfar"], "max_abs_err": err_c,
         "ms": times["mag_gos_cfar"][0],
         "plain_ms": times["mag_gos_cfar"][1]},
        {"name": "chain_gos", "route": "cuda",
         "source": "rsp_chains_tpu_torch/csrc/chain_gos.cu",
         "replaces": "rsp_chains_tpu/kernels/chain_pallas.py:1221",
         "launches": launches["chain_gos"], "max_abs_err": err_d,
         "ms": times["chain_gos"][0], "plain_ms": times["chain_gos"][1]},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
