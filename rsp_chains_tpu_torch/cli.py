"""CLI, the port of ``rsp_chains_tpu.cli`` — the analog of the reference's
elaboration ``App`` objects (SURVEY §L6): named presets that build and run a
chain, plus the debug register-poke role of jtag2mm (SURVEY §2.7) via --set
runtime overrides.

Every command that runs a chain takes ``--device`` (default ``cuda``; without
a card it raises, ``--device cpu`` runs the plain versions). Usage examples:

    python -m rsp_chains_tpu_torch.cli run --preset fft_mag_cfar --input iq.npy
    python -m rsp_chains_tpu_torch.cli run --preset rsp_vanilla --set nco_freq_word=32
    python -m rsp_chains_tpu_torch.cli selftest --device cpu
    python -m rsp_chains_tpu_torch.cli bench --preset fft_mag_cfar
    python -m rsp_chains_tpu_torch.cli stream --control-port 0
    python -m rsp_chains_tpu_torch.cli poke --port PORT --set cfar_mode=1
    python -m rsp_chains_tpu_torch.cli info
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import sys

PRESETS = ("fft_mag_cfar", "rsp_vanilla", "chain_with_mem", "rx_tx",
           "pulse_compression", "range_doppler", "rd_2d", "real_rx",
           "beamformed_rd", "integrated_search")
# the presets over CPIs [..., pulses, range] (the rest take frames [..., N])
CPI_PRESETS = ("range_doppler", "rd_2d", "beamformed_rd", "integrated_search")
# the samples of one headline call (bench.py:327-344): 64 channels x 256
# pulses x 1024 samples
HEADLINE_SAMPLES = 64 * 256 * 1024
BENCH_CALLS = 30


def _device(args):
    import torch

    from .chain import _require_card

    dev = torch.device(args.device)
    _require_card(dev, f"the {args.cmd} command runs on")
    return dev


class _Rd2dChain:
    """Chain-like facade over ``ops.cfar_2d.rd_2d_cfar_chain`` (whose run
    signature carries the 2-D detector's OWN register record): binds the
    ``--set2d`` register overrides so the CLI's uniform ``f(x, rt)`` call
    sites work unchanged. The 2-D registers are host values like the 1-D
    file; rebinding them rebuilds nothing."""

    def __init__(self, set2d, device):
        from .configs import (
            ChainConfig, DopplerConfig, FftConfig, MatchedFilterConfig,
        )
        from .ops.cfar_2d import Cfar2dConfig, Cfar2dRuntime, rd_2d_cfar_chain

        self.cfg = ChainConfig(
            fft=FftConfig(max_size=1024),
            matched_filter=MatchedFilterConfig(num_taps=128, fft_size=1024),
            doppler=DopplerConfig(num_pulses=256),
        )
        kw = dict(ref_range=8, guard_range=2, ref_doppler=4, guard_doppler=1,
                  threshold_scaler=6.0)
        for ov in set2d or []:
            k, _, v = ov.partition("=")
            kw[k] = _reg_value(v)
        if kw.get("algorithm") == 1:
            # the OS body runs the plain stacked sort, two orders of
            # magnitude slower than the fused CA detector; an algorithm
            # register write must not cost the user that silently
            print("warning: --set2d algorithm=1 selects the ordered-statistic "
                  "detector, which runs the plain stacked-sort route "
                  "(far slower per CPI than the fused CA detector)",
                  file=sys.stderr)
            # OS registers need an include_os elaboration, whose annulus
            # stack is capped — elaborate the small OS maxima and shrink the
            # default window to fit (explicit overrides still validate)
            self.cfg2d = Cfar2dConfig(max_ref_range=4, max_guard_range=1,
                                      max_ref_doppler=2, max_guard_doppler=1,
                                      include_os=True)
            for key, mx in (("ref_range", 4), ("guard_range", 1),
                            ("ref_doppler", 2), ("guard_doppler", 1)):
                if key not in {o.partition("=")[0] for o in set2d or []}:
                    kw[key] = min(kw[key], mx)
            # median-rank default: high ranks self-mask on compressed-pulse
            # sidelobes when the guard rectangle is this small
            kw.setdefault("os_rank", self.cfg2d.os_stack // 2)
        else:
            self.cfg2d = Cfar2dConfig()
        self.rt2 = Cfar2dRuntime.make(validate_against=self.cfg2d, **kw)
        self._run = rd_2d_cfar_chain(self.cfg, cfg2d=self.cfg2d, device=device)
        self.device = device
        self.stage_names = ("rd_2d_cfar",)

    def __call__(self, x, rt):
        return self._run(x, rt, self.rt2)


def _build_chain(preset: str, device, set2d=None, rom=None):
    from . import presets as P

    if preset == "rd_2d":
        return _Rd2dChain(set2d, device)
    if preset == "chain_with_mem":
        return P.chain_with_mem(rom=rom, device=device)
    return {
        "fft_mag_cfar": P.fft_mag_cfar_chain,
        "rsp_vanilla": P.rsp_chain_vanilla,
        "rx_tx": P.rx_fft_mag_cfar_tx_chain,
        "pulse_compression": P.pulse_compression_chain,
        "range_doppler": P.range_doppler_chain,
        "real_rx": P.real_rx_chain,
        "beamformed_rd": P.beamformed_rd_chain,
        "integrated_search": P.integrated_search_chain,
    }[preset](device=device)


def _default_cpi(preset: str, cfg):
    """Synthetic CPI fixture for the 2-D presets (no --input): one LFM target
    at range bin N/4, Doppler 0.1 cycles/pulse; beamformed_rd replicates it
    over 8 array channels with the ULA phase of a 10-degree target so exactly
    one beam lights up."""
    import numpy as np

    from .configs import MatchedFilterConfig
    from .golden import chirp_with_targets, lfm_chirp

    n = cfg.fft.max_size
    p = cfg.doppler.num_pulses if cfg.doppler is not None else 64
    n_taps = (cfg.matched_filter or MatchedFilterConfig()).num_taps
    chirp = lfm_chirp(min(n_taps, n // 4), 0.0, 0.25)
    cpi = chirp_with_targets(p, n, chirp, [(n // 4, 1.0, 0.1)], noise_db=-40)
    if preset == "beamformed_rd":
        from .ops.beamform import ula_steering

        # element-space replica: arriving wavefront of a 10-degree target
        # (beamform conjugates the steering weights internally)
        a = ula_steering(8, np.deg2rad([10.0]))[0]   # [C]
        cpi = a[:, None, None] * cpi[None]           # [C, P, N]
    return cpi


def _reg_value(v: str):
    """Parse a REG=VAL value: integer when it reads as one, float otherwise
    (so scientific notation like ``threshold_scaler=1e3`` works)."""
    try:
        return int(v)
    except ValueError:
        return float(v)


def _runtime(overrides: list[str], cfar_cfg=None):
    from .configs import RuntimeConfig

    kw = {}
    for ov in overrides:
        k, _, v = ov.partition("=")
        kw[k] = _reg_value(v)
    # validate register writes against the elaborated maxima, as the hardware's
    # require(...)s would at elaboration — out-of-range windows are rejected
    # here instead of being silently clamped on the device
    return RuntimeConfig.make(validate_against=cfar_cfg, **kw)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"
    return out.strip().splitlines()[0] if out.strip() else "no card listed"


def _numpy(t):
    return t.detach().cpu().numpy()


def _input(preset: str, chain, args):
    """The run command's input: --input, or the preset's fixture (None for
    the self-stimulus tops)."""
    import numpy as np

    from .golden import three_tone_signal

    n = chain.cfg.fft.max_size
    if args.input:
        raw = np.load(args.input)
        if preset == "rx_tx":
            return np.asarray(raw, np.uint32)
        if preset == "real_rx":
            return np.asarray(np.real(raw), np.float32)
        return raw
    if preset in ("rsp_vanilla", "chain_with_mem"):
        return None
    if preset in CPI_PRESETS:
        print("(no --input: synthetic one-target LFM CPI fixture)",
              file=sys.stderr)
        return _default_cpi(preset, chain.cfg)
    iq = three_tone_signal(n, shift_range_factor=12)
    if preset == "real_rx":
        print(f"(no --input: real part of the canonical {n}-pt three-tone "
              "fixture)", file=sys.stderr)
        return np.real(iq).astype(np.float32)
    print(f"(no --input: using canonical {n}-pt three-tone fixture)",
          file=sys.stderr)
    if preset == "rx_tx":
        from .io import native

        return native.pack_iq_c64(iq)
    return iq


def cmd_info(args):
    import torch

    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
          f"CUDA available: {torch.cuda.is_available()}; cards: "
          f"{torch.cuda.device_count()}")
    if torch.cuda.is_available():
        print(f"card: {card()}")
    from .io import native

    native._load()
    print(f"native packing: {'C++' if native.HAVE_NATIVE else 'numpy fallback'}")
    print(f"presets: {', '.join(PRESETS)}")
    return 0


def cmd_run(args):
    import numpy as np

    dev = _device(args)
    chain = _build_chain(args.preset, dev, getattr(args, "set2d", None))
    rt = _runtime(args.set or [], chain.cfg.cfar)
    out = chain(_input(args.preset, chain, args), rt)
    if args.output:
        arrs = ({"threshold": _numpy(out.threshold)}
                if hasattr(out, "threshold") else {"out": _numpy(out)})
        if hasattr(out, "peaks"):
            arrs["peaks"] = _numpy(out.peaks)
        np.savez(args.output, **arrs)
        print(f"wrote {args.output}")
    if hasattr(out, "peaks"):
        peaks = np.flatnonzero(_numpy(out.peaks).reshape(-1))
        print(f"detections ({peaks.size}): {peaks[:32].tolist()}"
              + (" ..." if peaks.size > 32 else ""))
        if getattr(args, "top_k", 0):
            # fixed-size serving egress: top-K detection list per frame
            from .ops.detect import compact_detections

            # ranked by CUT magnitude when elaborated (send_cut=True);
            # otherwise the local threshold is the only per-cell statistic
            # the chain emits — label the ordering honestly
            have_cut = getattr(out, "cut", None) is not None
            score = out.cut if have_cut else out.threshold
            kind = "mag" if have_cut else "thr"
            if not have_cut:
                print("(send_cut not elaborated: ranking by local threshold, "
                      "not target strength — elaborate "
                      "CfarConfig(send_cut=True) for magnitude ranking)")
            dl = compact_detections(score, out, max_detections=args.top_k)
            bins = _numpy(dl.bins).reshape(-1, args.top_k)
            vals = _numpy(dl.values).reshape(-1, args.top_k)
            cnt = _numpy(dl.count).reshape(-1)
            for i in range(min(4, bins.shape[0])):
                k = int(cnt[i])
                pairs = ", ".join(f"{b}:{kind}={v:.3g}"
                                  for b, v in zip(bins[i][:k], vals[i][:k]))
                print(f"top-{args.top_k} frame {i} (count {k}): {pairs}")
    return 0


def cmd_selftest(args):
    """The RspChainVanilla self-stimulus contract: tone at bin s*N/(4*tableSize)."""
    import numpy as np

    from .configs import RuntimeConfig
    from .presets import rsp_chain_vanilla

    chain = rsp_chain_vanilla(device=_device(args))
    start = 16
    rt = RuntimeConfig.make(nco_freq_word=start, ref_window_size=32,
                            guard_window_size=4, div_sum=5)
    out = chain(None, rt)
    expected = start * chain.cfg.fft.max_size // (4 * chain.cfg.nco.table_size)
    peaks = np.flatnonzero(_numpy(out.peaks))
    ok = peaks.tolist() == [expected]
    print(f"selftest: peaks={peaks.tolist()} expected=[{expected}] "
          f"{'PASS' if ok else 'FAIL'}")
    return 0 if ok else 1


def _bench_case(preset: str, args, dev):
    """(chain, input, registers, samples) of one headline call of
    ``preset``: HEADLINE_SAMPLES seeded samples on the card, as frames
    [frames / 256, 256, N], CPIs [cpis, pulses, N] (8 array channels a CPI
    for beamformed_rd), the self-stimulus tops' profile or ROM at the
    headline shape."""
    import torch

    from . import packing
    from .cplx import C

    g = torch.Generator(device=dev).manual_seed(0)

    def noise(shape):
        return C(torch.randn(shape, device=dev, generator=g),
                 torch.randn(shape, device=dev, generator=g))

    rom = None
    if preset == "chain_with_mem":
        rom = noise((64, 256, 1024))
    chain = _build_chain(preset, dev, getattr(args, "set2d", None), rom=rom)
    rt = _runtime(args.set or [], chain.cfg.cfar)
    n = chain.cfg.fft.max_size
    if preset in CPI_PRESETS:
        p = chain.cfg.doppler.num_pulses if chain.cfg.doppler else 256
        lead = (8,) if preset == "beamformed_rd" else ()
        per = p * n * (lead[0] if lead else 1)
        shape = (HEADLINE_SAMPLES // per, *lead, p, n)
    else:
        shape = (HEADLINE_SAMPLES // n // 256, 256, n)
    if preset == "rsp_vanilla":
        rt = rt.merge_regs(plfg_profile=torch.zeros(shape, device=dev))
        return chain, None, rt, HEADLINE_SAMPLES
    if preset == "chain_with_mem":
        return chain, None, rt, HEADLINE_SAMPLES
    x = noise(shape)
    if preset == "rx_tx":
        x = packing.pack_iq(C(*(torch.round(torch.clamp(v * 250, -32767,
                                                        32767)) for v in x)))
    elif preset == "real_rx":
        x = x.re
    return chain, x, rt, HEADLINE_SAMPLES


def cmd_bench(args):
    """Time the preset at the headline batch on the card: the median of
    BENCH_CALLS calls by CUDA events after warm-up. The JAX package's bench
    (``bench.py``) measures that package; this measures the port."""
    import torch

    if torch.device(args.device).type != "cuda":
        print("bench measures the card; there is no card time on "
              f"--device {args.device}", file=sys.stderr)
        return 2
    dev = _device(args)
    chain, x, rt, samples = _bench_case(args.preset, args, dev)
    stream = torch.cuda.current_stream(dev)
    for _ in range(5):
        chain(x, rt)
    times = []
    for _ in range(BENCH_CALLS):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record(stream)
        chain(x, rt)
        end.record(stream)
        end.synchronize()
        times.append(start.elapsed_time(end))
    ms = statistics.median(times)
    shape = ("none (self-stimulus)" if x is None
             else "x".join(map(str, x.shape)))
    print(f"bench {args.preset}: input {shape}, {samples} samples a call; "
          f"median {ms:.4f} ms over {BENCH_CALLS} calls (CUDA events; min "
          f"{min(times):.4f}, max {max(times):.4f}); "
          f"{samples / ms / 1e3:.1f} Msamples/s; card {card()}")
    return 0


def cmd_stream(args):
    """Continuous streaming run — the served RxFftMagCfarTxChain deployment
    (SURVEY §2.11/§3.5): framed bytes or synthetic frames -> bounded queue ->
    chain per CPI -> per-CPI metrics."""
    import time

    import numpy as np

    from .golden import three_tone_signal
    from .io import FrameDecoder, StreamingPipeline

    chain = _build_chain(args.preset, _device(args))
    rt = _runtime(args.set or [], chain.cfg.cfar)
    n = chain.cfg.fft.max_size
    metrics = []

    pipe = StreamingPipeline(
        chain, rt,
        on_result=lambda s, o, m: metrics.append(m),
        depth=args.depth,
        on_error=lambda s, e: print(f"CPI {s} failed: {e}", file=sys.stderr),
    )
    ctrl = None
    if getattr(args, "control_port", None) is not None:
        # jtag2mm analog: second control master peeking/poking the register
        # file of the running stream (SURVEY §2.7)
        from .io.control import ControlServer

        ctrl = ControlServer(lambda: pipe.runtime, pipe.reconfigure,
                             cfar_cfg=chain.cfg.cfar,
                             port=args.control_port,
                             update_rt=pipe.update_runtime).start()
        print(f"control port: {ctrl.port}", file=sys.stderr)
    n_sub = 0
    try:
        with pipe:
            if args.input:
                dec = FrameDecoder()
                with open(args.input, "rb") as fh:
                    while chunk := fh.read(1 << 16):
                        for fr in dec.feed(chunk):
                            pipe.submit(fr.seq, fr.iq.reshape(1, -1))
                            n_sub += 1
            else:
                iq = three_tone_signal(n, shift_range_factor=12).astype(
                    np.complex64)
                for s in range(args.frames):
                    pipe.submit(s, iq[None])
                    n_sub += 1
            t0 = time.time()
            while (len(metrics) + pipe.stats.frames_failed < n_sub
                   and time.time() - t0 < 120):
                time.sleep(0.01)
    finally:
        if ctrl is not None:
            ctrl.stop()
    st = pipe.stats
    print(f"CPIs: {st.frames_out} ok, {st.frames_failed} failed, "
          f"{st.frames_dropped} dropped; aggregate "
          f"{st.samples_per_s / 1e6:.1f} Msamples/s")
    if metrics:
        lat = sorted(m.latency_s for m in metrics)
        print(f"latency p50 {lat[len(lat) // 2] * 1e3:.2f} ms, "
              f"p99 {lat[int(len(lat) * 0.99)] * 1e3:.2f} ms; "
              f"detections/CPI median "
              f"{sorted(m.detections for m in metrics)[len(metrics) // 2]}")
    return 0 if st.frames_failed == 0 else 1


def cmd_poke(args):
    """Peek/poke the register file of a running local stream over its debug
    control port — the jtag2mm debug-master role (SURVEY §2.7)."""
    import json

    from .io.control import poke

    overrides = {}
    for ov in args.set or []:
        k, _, v = ov.partition("=")
        overrides[k] = _reg_value(v)
    resp = poke(args.host, args.port, overrides or None)
    print(json.dumps(resp["regs"], indent=1, sort_keys=True))
    return 0


def cmd_serve(args):
    """Run the TCP chain server (UART-host-link deployment analog)."""
    import time

    from .io.server import ChainServer

    chain = _build_chain(args.preset, _device(args))
    rt = _runtime(args.set or [], chain.cfg.cfar)
    srv = ChainServer(chain, rt, frame_len=chain.cfg.fft.max_size,
                      log2_fft_size=chain.cfg.fft.log2_max,
                      host=args.host, port=args.port, cfar_cfg=chain.cfg.cfar)
    with srv:
        print(f"serving {args.preset} on {args.host}:{srv.port} "
              f"(frame = {chain.cfg.fft.max_size} IQ samples)", flush=True)
        try:
            while True:
                time.sleep(5)
                st = srv.stats
                print(f"  frames ok={st.frames_out} failed={st.frames_failed} "
                      f"agg={st.samples_per_s / 1e6:.1f} Msps", flush=True)
        except KeyboardInterrupt:
            pass
    return 0


def cmd_plot(args):
    """Threshold-vs-spectrum plot — the analog of the reference tester's
    ``ThresholdPlot.pdf`` (``FftMagCfarChainTester.scala:177-192``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from .cplx import C, as_pair
    from .golden import three_tone_signal
    from .ops.fft import fft_op, fft_scale, rfft_op
    from .ops.logmag import logmag

    dev = _device(args)
    chain = _build_chain(args.preset, dev, getattr(args, "set2d", None))
    rt = _runtime(args.set or [], chain.cfg.cfar)
    n = chain.cfg.fft.max_size

    if args.preset in ("range_doppler", "rd_2d", "beamformed_rd"):
        # 2-D range-Doppler map with CFAR detection overlay
        from .golden import chirp_with_targets, lfm_chirp

        p = chain.cfg.doppler.num_pulses if chain.cfg.doppler else 256
        chirp = lfm_chirp(128, 0.0, 0.25)
        if args.input:
            cpi = np.load(args.input)
        elif args.preset == "beamformed_rd":
            cpi = _default_cpi(args.preset, chain.cfg)
        else:
            cpi = chirp_with_targets(
                p, n, chirp,
                [(n // 4, 1.0, 0.1), (n // 2, 0.4, -0.2), (3 * n // 5, 0.2, 0.3)],
                noise_db=-35)
        out = chain(cpi if args.preset == "beamformed_rd" else cpi[None], rt)
        # beamformed_rd emits one map per beam: plot the busiest beam
        pk_all = _numpy(out.peaks)
        sel = int(np.argmax(pk_all.reshape(pk_all.shape[0], -1).sum(axis=1)))
        thr = _numpy(out.threshold)[sel]
        pk = pk_all[sel]
        fig, ax = plt.subplots(figsize=(10, 6))
        img = 20 * np.log10(np.maximum(thr, 1e-9))
        ax.imshow(img, aspect="auto", origin="lower", cmap="viridis",
                  interpolation="nearest")
        d, r = np.nonzero(pk)
        ax.plot(r, d, "r^", ms=5, label=f"detections ({d.size})")
        ax.set_xlabel("Range bin")
        ax.set_ylabel("Doppler bin")
        title = "Range-Doppler CFAR threshold map (dB) + detections"
        if args.preset == "beamformed_rd":
            title += f" — beam {sel}"
        ax.set_title(title)
        ax.legend()
        path = args.output or "RangeDopplerPlot.pdf"
        fig.savefig(path, bbox_inches="tight")
        print(f"wrote {path}")
        return 0

    if args.preset == "integrated_search":
        # pulse-integrated 1-D detection: threshold + detections (no single
        # spectrum to overlay — the statistic is integrated over the CPI)
        cpi = np.load(args.input) if args.input \
            else _default_cpi(args.preset, chain.cfg)
        out = chain(cpi, rt)
        thr = _numpy(out.threshold).reshape(-1)
        pk = _numpy(out.peaks).reshape(-1)
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.plot(np.arange(thr.size), thr, label="integrated CFAR threshold",
                lw=0.8)
        det = np.flatnonzero(pk)
        ax.plot(det, thr[det], "rv", ms=6, label=f"detections ({det.size})")
        ax.set_xlabel("Range bin")
        ax.set_ylabel("Integrated statistic")
        ax.set_title("Integrated-search CFAR detections")
        ax.legend()
        path = args.output or "IntegratedSearchPlot.pdf"
        fig.savefig(path, bbox_inches="tight")
        print(f"wrote {path}")
        return 0

    iq = np.load(args.input) if args.input \
        else three_tone_signal(n, shift_range_factor=12)
    if args.preset == "real_rx":
        # real-ADC chain: real frames in, one-sided N/2-bin CFAR out. The
        # overlay applies the chain's FFT scaling (default DIV_N) — an
        # unscaled rfft would plot a spectrum N times the scale the plotted
        # threshold was computed against.
        import torch

        xr = torch.as_tensor(np.real(iq), dtype=torch.float32, device=dev)
        out = chain(xr, rt)
        y = rfft_op(xr, pair=True)
        s = fft_scale(n, chain.cfg.fft)
        spec = C(y.re[..., : n // 2] * s, y.im[..., : n // 2] * s)
        mag = _numpy(logmag(spec, rt.mag_mode))
    elif args.preset == "rx_tx":
        # wire-format chain: packed beat words in, packed CFAR words out —
        # unpack for plotting (the serving debug view). The overlay spectrum
        # comes from the UNPACKED words, not the raw float iq: the chain
        # processes the int16-quantized pack round trip, and the plotted
        # magnitude must reflect the same quantized input the decoded
        # (integer-truncated) wire threshold was computed against.
        from . import packing
        from .io import native

        words = native.pack_iq_c64(iq)
        out_words = _numpy(chain(words, rt)).reshape(-1).view(np.uint32)
        thr_w, _bins, pk_w = native.unpack_cfar_words(out_words,
                                                      chain.cfg.fft.log2_max)
        x = as_pair(packing.unpack_iq_pair(words), device=dev)
        mag = _numpy(logmag(fft_op(x, rt.log2_fft_size, chain.cfg.fft),
                            rt.mag_mode))
        out = None
        thr, pk = thr_w.astype(np.float64), pk_w.astype(bool)
    else:
        x = as_pair(iq, device=dev)
        out = chain(x, rt)
        mag = _numpy(logmag(fft_op(x, rt.log2_fft_size, chain.cfg.fft),
                            rt.mag_mode))
    if out is not None:
        thr = _numpy(out.threshold)
        pk = _numpy(out.peaks)

    fig, ax = plt.subplots(figsize=(10, 4))
    bins = np.arange(len(mag))
    ax.plot(bins, mag, label="FFT magnitude", lw=0.8)
    ax.plot(bins, thr, label="CFAR threshold", lw=0.8)
    det = np.flatnonzero(pk)
    ax.plot(det, mag[det], "rv", ms=6, label=f"detections ({det.size})")
    ax.set_xlabel("Frequency bin")
    ax.set_ylabel("Amplitude")
    ax.set_title("Constant False Alarm Rate")
    ax.legend()
    path = args.output or "ThresholdPlot.pdf"
    fig.savefig(path, bbox_inches="tight")
    print(f"wrote {path}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="rsp_chains_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    on = argparse.ArgumentParser(add_help=False)
    on.add_argument("--device", default="cuda",
                    help="where the chain runs: cuda (default; raises without "
                         "a card) or cpu (the plain versions)")

    pi = sub.add_parser("info", help="environment and preset info")
    pi.set_defaults(fn=cmd_info)

    pr = sub.add_parser("run", help="run a preset chain", parents=[on])
    pr.add_argument("--preset", choices=PRESETS, default="fft_mag_cfar")
    pr.add_argument("--input", help=".npy complex IQ (or uint32 words for rx_tx)")
    pr.add_argument("--output", help=".npz to write threshold/peaks")
    pr.add_argument("--top-k", type=int, default=0, metavar="K",
                    help="also print a strength-sorted top-K detection list "
                         "per frame (ops/detect.py serving egress)")
    pr.add_argument("--set", action="append", metavar="REG=VAL",
                    help="runtime register override (RuntimeConfig.make kwarg)")
    pr.add_argument("--set2d", action="append", metavar="REG=VAL",
                    help="2-D detector register override (rd_2d preset; "
                         "Cfar2dRuntime.make kwarg)")
    pr.set_defaults(fn=cmd_run)

    ps = sub.add_parser("selftest", help="self-stimulus peak-bin contract check",
                        parents=[on])
    ps.set_defaults(fn=cmd_selftest)

    pb = sub.add_parser("bench", help="time a preset at the headline batch on "
                                      "the card (CUDA events)", parents=[on])
    pb.add_argument("--preset", choices=PRESETS, default="fft_mag_cfar")
    pb.add_argument("--set", action="append", metavar="REG=VAL")
    pb.add_argument("--set2d", action="append", metavar="REG=VAL")
    pb.set_defaults(fn=cmd_bench)

    psv = sub.add_parser("serve", help="TCP chain server (framed IQ in, CFAR "
                                       "words out)", parents=[on])
    psv.add_argument("--preset", choices=PRESETS, default="fft_mag_cfar")
    psv.add_argument("--host", default="127.0.0.1")
    psv.add_argument("--port", type=int, default=7355)
    psv.add_argument("--set", action="append", metavar="REG=VAL")
    psv.set_defaults(fn=cmd_serve)

    pst = sub.add_parser("stream", help="continuous streaming run with "
                                        "per-CPI metrics", parents=[on])
    pst.add_argument("--preset", choices=PRESETS, default="fft_mag_cfar")
    pst.add_argument("--input", help="framed byte stream file (io.framing format)")
    pst.add_argument("--frames", type=int, default=32, help="synthetic frame count")
    pst.add_argument("--depth", type=int, default=8, help="ingest queue depth")
    pst.add_argument("--set", action="append", metavar="REG=VAL")
    pst.add_argument("--control-port", type=int, default=None, metavar="PORT",
                     help="open a debug peek/poke register port (jtag2mm "
                          "analog; 0 = ephemeral)")
    pst.set_defaults(fn=cmd_stream)

    ppk = sub.add_parser(
        "poke", help="peek/poke the register file of a running stream "
                     "(jtag2mm debug-master analog)")
    ppk.add_argument("--host", default="127.0.0.1")
    ppk.add_argument("--port", type=int, required=True)
    ppk.add_argument("--set", action="append", metavar="REG=VAL",
                     help="registers to write; omit to just peek")
    ppk.set_defaults(fn=cmd_poke)

    pp = sub.add_parser("plot", help="threshold-vs-spectrum plot "
                                     "(ThresholdPlot analog)", parents=[on])
    pp.add_argument("--preset", choices=PRESETS, default="fft_mag_cfar")
    pp.add_argument("--input", help=".npy complex IQ frame")
    pp.add_argument("--output", help="output figure path (default ThresholdPlot.pdf)")
    pp.add_argument("--set", action="append", metavar="REG=VAL")
    pp.add_argument("--set2d", action="append", metavar="REG=VAL",
                    help="2-D detector register override (rd_2d preset)")
    pp.set_defaults(fn=cmd_plot)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
