"""The PyTorch port's host I/O against the JAX package's: the wire framing and
the native scanner, packing and CRC, the UART register model,
``compact_detections``, checkpoints, the CLI and ``stage_timings``.

Bars: frames byte-identical, decoders and scanners equal frame for frame,
packing and CRC equal, the UART models equal word for word and bit for bit,
the detection lists equal exactly (ties in JAX's order), checkpoints equal
register for register and cell for cell in both directions."""

import io
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import rsp_chains_tpu as R
from rsp_chains_tpu import cli as jcli
from rsp_chains_tpu.io import cpi as jcpi
from rsp_chains_tpu.io import framing as jframing
from rsp_chains_tpu.io import native as jnative
from rsp_chains_tpu.io import uart as juart
from rsp_chains_tpu.ops.cfar import CfarOutput as JCfarOutput
from rsp_chains_tpu.ops.detect import compact_detections as j_compact

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch import cli as tcli
from rsp_chains_tpu_torch.io import cpi as tcpi
from rsp_chains_tpu_torch.io import framing as tframing
from rsp_chains_tpu_torch.io import native as tnative
from rsp_chains_tpu_torch.io import uart as tuart
from rsp_chains_tpu_torch.ops.cfar import CfarOutput
from rsp_chains_tpu_torch.ops.detect import compact_detections
from rsp_chains_tpu_torch.utils import profiling


def _words(seed, n):
    return np.random.RandomState(seed).randint(0, 2**32, n,
                                               dtype=np.uint64).astype(np.uint32)


# ---- frames ----

@pytest.mark.parametrize("seed,n,kw", [
    (0, 1, {}),
    (1, 64, dict(last=True)),
    (2, 1024, dict(config=True, channel=7)),
    (3, 257, dict(last=True, config=True, channel=65535)),
])
def test_encode_frame_is_byte_identical(seed, n, kw):
    w = _words(seed, n)
    seq = (seed * 0x9E3779B9) & 0xFFFFFFFF
    assert tframing.encode_frame(w, seq, **kw) == \
        jframing.encode_frame(w, seq, **kw)


def test_encode_iq_frame_is_byte_identical():
    rng = np.random.RandomState(4)
    iq = (rng.randn(300) * 9000 + 1j * rng.randn(300) * 9000).astype(np.complex64)
    iq[:4] = [40000.4 + 0.6j, -40000.0 - 2.5j, 0.5 - 0.5j, -1.5 + 1.5j]
    assert tframing.encode_iq_frame(iq, 3, last=True) == \
        jframing.encode_iq_frame(iq, 3, last=True)


def _stream(mod, corrupt: bool):
    """Frames of seeded words, with garbage, a flipped payload bit and a
    corrupted length field between them when ``corrupt``."""
    parts = []
    for i in range(6):
        f = bytearray(mod.encode_frame(_words(10 + i, 17 * i + 1), i,
                                       last=i % 2 == 1, channel=i))
        if corrupt and i == 2:
            f[20] ^= 0x10                       # CRC no longer holds
        if corrupt and i == 4:
            f[8:12] = (1 << 24).to_bytes(4, "little")   # n_words past the bound
        parts.append(bytes(f))
        if corrupt:
            parts.append(b"\x00garbage RSPC!" + b"\x43\x50\x53\x52")
    return b"".join(parts)


def _decode(mod, stream, chunk):
    dec = mod.FrameDecoder()
    out = []
    for i in range(0, len(stream), chunk):
        out.extend(dec.feed(stream[i:i + chunk]))
    return [(f.seq, f.words.tolist(), f.last, f.config, f.channel) for f in out]


@pytest.mark.parametrize("corrupt", [False, True])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_each_decoder_reads_the_others_stream(writer, reader, corrupt):
    mods = {"jax": jframing, "port": tframing}
    stream = _stream(mods[writer], corrupt)
    for chunk in (len(stream), 13):
        got = _decode(mods[reader], stream, chunk)
        assert got == _decode(mods[writer], stream, chunk)
        assert [g[0] for g in got] == ([0, 1, 3, 5] if corrupt
                                       else list(range(6)))


def test_native_scan_equals_python_decoder_and_jax():
    stream = _stream(tframing, corrupt=True)
    metas, consumed, skipped = tnative.scan_frames(stream, 1 << 20,
                                                   max_frames=2)
    assert (metas, consumed, skipped) == jnative.scan_frames(stream, 1 << 20,
                                                             max_frames=2)
    pos, frames = 0, []
    while True:
        try:
            f, n = tframing.decode_frame(stream, pos)
        except IndexError:
            break
        except tframing.FrameError:
            pos += 1
            continue
        frames.append((pos, f))
        pos += n
    assert [(m[5], m[2], m[1]) for m in metas] == \
        [(p, f.seq, f.words.size) for p, f in frames]
    for (off, n_words, *_), (_, f) in zip(metas, frames):
        np.testing.assert_array_equal(
            np.frombuffer(stream, np.uint32, n_words, off), f.words)


def test_native_builds_into_the_port_build_dir():
    tnative._load()
    assert tnative.HAVE_NATIVE
    path = tnative.library_path()
    assert path.parent.name == "_build"
    assert path.parent.parent.name == "rsp_chains_tpu_torch"
    assert path.exists()


def _native_cases():
    rng = np.random.RandomState(5)
    iq16 = rng.randint(-32768, 32768, 512).astype(np.int16)
    c64 = (rng.randn(256) * 20000 + 1j * rng.randn(256) * 20000).astype(
        np.complex64)
    c64[:3] = [40000.4 + 0.6j, -40000.0 - 2.5j, 0.5 - 0.5j]
    words = _words(6, 256)
    return {
        "pack_iq_i16": lambda m: m.pack_iq_i16(iq16),
        "pack_iq_c64": lambda m: m.pack_iq_c64(c64),
        "unpack_iq_c64": lambda m: m.unpack_iq_c64(words),
        "crc32": lambda m: np.asarray([m.crc32(words), m.crc32(b"rspc", 7)]),
        "unpack_cfar_words": lambda m: np.stack(
            [a.astype(np.int64) for a in m.unpack_cfar_words(words, 10)]),
    }


@pytest.mark.parametrize("name", sorted(_native_cases()))
def test_native_entry_points_equal_jax_and_the_numpy_fallback(name,
                                                              monkeypatch):
    fn = _native_cases()[name]
    got = fn(tnative)
    np.testing.assert_array_equal(got, fn(jnative))
    monkeypatch.setattr(tnative, "_load", lambda: False)
    np.testing.assert_array_equal(fn(tnative), got)


# ---- UART ----

def _loop(u, words):
    u.submit(*words)
    while (bits := u.transmit()) is not None:
        u.receive(bits)
    return u.collect()


def _uart_trace(mod, case):
    """Drive one UART case through package ``mod``; returns what it saw."""
    P, U, Rg = mod.UartParams, mod.DspBlockUart, mod.UartRegs
    full = P(data_bits=9, include_four_wire=True, include_parity=True)
    if case == "resets":
        u = U(full, divisor_init=868)
        return [u.peek(o) for o in (Rg.txctrl, Rg.rxctrl, Rg.ie, Rg.div,
                                    Rg.parity, Rg.wire4, Rg.either8or9)]
    u = U(full)
    u.poke(Rg.txctrl, 1)
    u.poke(Rg.rxctrl, 1)
    if case == "8N1 loopback":
        return [_loop(u, [0x00, 0x5A, 0xFF, 0x81]), u.frame_bits(0xA5)]
    if case == "9-bit":
        u.poke(Rg.either8or9, 0)
        return [_loop(u, [0x1A5, 0x0FF, 0x100]), u.frame_bits(0x1A5)]
    if case == "odd parity error":
        u.poke(Rg.parity, 0b11)
        u.submit(0x55)
        bits = u.transmit()
        bits[9] ^= 1
        u.receive(bits)
        return [bits, u.collect(), u.peek(Rg.parity), list(u.interrupts)]
    if case == "watermarks":
        u.poke(Rg.txmark, 2)
        u.poke(Rg.rxmark, 1)
        u.poke(Rg.ie, 0b10)
        u.submit(1, 2, 3)
        seen = [u.peek(Rg.ip)]
        for _ in range(3):
            u.receive(u.transmit())
        return seen + [u.peek(Rg.ip), list(u.interrupts)]
    raise ValueError(case)


@pytest.mark.parametrize("case", ["resets", "8N1 loopback", "9-bit",
                                  "odd parity error", "watermarks"])
def test_uart_models_agree(case):
    assert _uart_trace(tuart, case) == _uart_trace(juart, case)


# ---- compact_detections ----

@pytest.mark.parametrize("k", [1, 8, 64])
def test_compact_detections_equals_jax_with_ties(k):
    rng = np.random.RandomState(k)
    # integer magnitudes: many cells of equal strength among the peaks
    mag = rng.randint(0, 6, (3, 4, 64)).astype(np.float32)
    peaks = rng.rand(3, 4, 64) < 0.3
    peaks[0, 0] = False                      # a frame with no detection
    thr = rng.rand(3, 4, 64).astype(np.float32) * 10
    want = j_compact(jnp.asarray(mag), JCfarOutput(jnp.asarray(thr),
                                                   jnp.asarray(peaks)), k)
    got = compact_detections(torch.from_numpy(mag), CfarOutput(
        torch.from_numpy(thr), torch.from_numpy(peaks)), k)
    for a, b in zip(got, want):
        assert a.dtype == {np.dtype(np.int32): torch.int32,
                           np.dtype(np.float32): torch.float32}[b.dtype]
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        compact_detections(torch.from_numpy(mag), CfarOutput(
            torch.from_numpy(thr), torch.from_numpy(peaks)), 65)


# ---- checkpoints ----

_REGS = dict(fft_size=512, ref_window_size=16, guard_window_size=2,
             threshold_scaler=4.3, cfar_mode=2, phase_offset=0.1,
             mem_run_last=0, nco_freq_word=21)


def _buffer(mod, rng):
    buf = mod.CpiBuffer(num_pulses=4, n_range=8, channels=2, hop=3)
    for _ in range(5):
        buf.push(rng.randn(2, 8).astype(np.complex64))
    return buf


@pytest.mark.parametrize("profile", [False, True])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_load_in_the_other_package(tmp_path, writer, profile):
    prof = np.linspace(0, 7, 64).astype(np.float32) if profile else None
    mods = {"jax": (jcpi, R.RuntimeConfig), "port": (tcpi, T.RuntimeConfig)}
    (wmod, wcfg), (rmod, _) = mods[writer], mods["port" if writer == "jax"
                                                 else "jax"]
    rt = wcfg.make(**_REGS, plfg_profile=prof)
    src = _buffer(wmod, np.random.RandomState(2))
    wmod.save_state(tmp_path / "ck", rt, src, cursor=np.asarray(41))
    z = np.load(tmp_path / "ck.npz")
    assert z["rt_threshold_scaler"].dtype == np.float32
    assert z["rt_log2_fft_size"].dtype == np.int32
    dst = rmod.CpiBuffer(num_pulses=4, n_range=8, channels=2, hop=3)
    rt2, extras = rmod.load_state(tmp_path / "ck", dst)
    assert rt2.peek() == rt.peek()
    if profile:
        np.testing.assert_array_equal(np.asarray(rt2.plfg_profile), prof)
    else:
        assert rt2.plfg_profile is None
    assert int(extras["cursor"]) == 41
    for key in ("count", "pulses_seen"):
        assert int(dst.state()[key]) == int(src.state()[key])
    np.testing.assert_array_equal(dst.state()["buf"], src.state()["buf"])
    # both buffers go on to the same next CPI
    rng = np.random.RandomState(3)
    for _ in range(2):
        p = rng.randn(2, 8).astype(np.complex64)
        a, b = src.push(p), dst.push(p)
    np.testing.assert_array_equal(a, b)


def test_port_checkpoint_of_host_registers_has_the_jax_dtypes(tmp_path):
    rt = T.RuntimeConfig.make(**_REGS, plfg_profile=torch.arange(
        8, dtype=torch.float32))
    tcpi.save_state(tmp_path / "ck.npz", rt)
    z = np.load(tmp_path / "ck.npz")
    for name in T.RuntimeConfig.__dataclass_fields__:
        want = (np.float32 if name in ("threshold_scaler", "phase_offset",
                                       "plfg_profile") else np.int32)
        assert z[f"rt_{name}"].dtype == want, name
    rt2, extras = tcpi.load_state(tmp_path / "ck")   # no suffix given
    assert extras == {}
    assert isinstance(rt2.threshold_scaler, float)
    assert isinstance(rt2.fft_size, int) and rt2.fft_size == 512
    assert rt2.peek() == rt.peek()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_an_older_register_file_loads_with_make_defaults(tmp_path, writer):
    save = {"jax": (jcpi, R.RuntimeConfig), "port": (tcpi, T.RuntimeConfig)}
    mod, cfg = save[writer]
    mod.save_state(tmp_path / "old", cfg.make(**_REGS))
    z = dict(np.load(tmp_path / "old.npz"))
    z.pop("rt_mem_start_reading")
    z.pop("rt_mem_run_last")
    np.savez(tmp_path / "old.npz", **z)
    rt, _ = tcpi.load_state(tmp_path / "old")
    assert rt.mem_start_reading == 1 and rt.mem_run_last == 1
    assert rt.threshold_scaler == float(np.float32(4.3))
    assert rt.cfar_mode == 2 and rt.plfg_profile is None


# ---- CLI and profiling ----

def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_cli_selftest_gives_the_jax_peaks():
    rc, out = _run(tcli.main, ["selftest", "--device", "cpu"])
    rc_j, out_j = _run(jcli.main, ["selftest"])
    assert rc == rc_j == 0
    assert out == out_j
    assert "peaks=[32] expected=[32] PASS" in out


def test_cli_run_top_k_lists_the_jax_detections():
    rc, out = _run(tcli.main, ["run", "--top-k", "4", "--device", "cpu"])
    assert rc == 0
    # the JAX package's default elaboration, its XLA composition, on the
    # CLI's fixture and registers, ranked by threshold as the CLI ranks
    cfg = R.ChainConfig(cfar=R.CfarConfig(use_pallas=False))
    iq = R.golden.three_tone_signal(1024, shift_range_factor=12)
    want = R.fft_mag_cfar_chain(cfg)(R.as_pair(iq), R.RuntimeConfig.make())
    dl = j_compact(want.threshold, want, 4)
    k = int(dl.count)
    pairs = ", ".join(f"{b}:thr={v:.3g}" for b, v in zip(
        np.asarray(dl.bins)[:k], np.asarray(dl.values)[:k]))
    peaks = np.flatnonzero(np.asarray(want.peaks)).tolist()
    assert f"detections ({len(peaks)}): {peaks}" in out.splitlines()
    assert f"top-4 frame 0 (count {k}): {pairs}" in out.splitlines()
    assert peaks == [0, 128, 256, 512]


def test_cli_refuses_the_card_without_one_and_bench_on_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tcli.main(["run"])
    rc, _ = _run(tcli.main, ["bench", "--device", "cpu"])
    assert rc == 2


def test_stage_timings_keys_are_the_stage_names():
    cfg = T.ChainConfig(fft=T.FftConfig(max_size=256),
                        cfar=T.CfarConfig(max_ref_window=16, use_pallas=False,
                                          variant=T.CfarVariant.CA,
                                          include_cash=False))
    chain = T.fft_mag_cfar_chain(cfg, device="cpu")
    assert chain.stage_names == ("fft", "logmag", "cfar")
    x = T.as_pair(T.golden.three_tone_signal(256, shift_range_factor=12))
    rt = T.RuntimeConfig.make(fft_size=256, ref_window_size=8,
                              guard_window_size=2)
    got = profiling.stage_timings(chain, x, rt, iters=2)
    assert tuple(got) == chain.stage_names
    assert all(v > 0 for v in got.values())


def test_trace_writes_a_chrome_trace_with_the_stage_ranges(tmp_path):
    chain = T.fft_mag_cfar_chain(device="cpu")
    x = T.as_pair(T.golden.three_tone_signal(1024, shift_range_factor=12))
    with profiling.trace(str(tmp_path)) as d:
        chain(x, T.RuntimeConfig.make())
    text = (tmp_path / "trace.json").read_text()
    assert d == str(tmp_path)
    assert chain.stage_names[0] in text
