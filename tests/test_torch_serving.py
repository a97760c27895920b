"""The PyTorch port's serving plane against the JAX package's, on the CPU:
``StreamingPipeline`` (CPIs, register writes between CPIs, the wait and fetch
cadences, elastic errors, watermark edges), ``ChainServer`` (framed requests,
config frames, the run_last flag, routing), ``ControlServer`` and ``poke``
(peek, poke, rejected writes, the atomic read-modify-write) and the pipeline's
checkpoint.

Bars: each CPI's threshold within the JAX bench's bar (max|dthr| / max|thr|
< 1e-4) with peak flips <= 1e-5 of the cells; served words with equal peaks
and bins and threshold fields within one count and within the bar. Every
socket read has a timeout and every wait a bound in seconds."""

import contextlib
import io
import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

import rsp_chains_tpu as R
from rsp_chains_tpu.io import framing as jframing
from rsp_chains_tpu.io.server import ChainServer as JChainServer
from rsp_chains_tpu.io.stream import StreamingPipeline as JPipeline

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch import cli as tcli
from rsp_chains_tpu_torch import packing as TP
from rsp_chains_tpu_torch.convert import runtime_from_reference
from rsp_chains_tpu_torch.io import framing as tframing
from rsp_chains_tpu_torch.io import native
from rsp_chains_tpu_torch.io.control import ControlServer, poke
from rsp_chains_tpu_torch.io.cpi import CpiBuffer, load_state
from rsp_chains_tpu_torch.io.server import ChainServer, request_frames
from rsp_chains_tpu_torch.io.stream import StreamingPipeline

N = 256
REL, FLIPS = 1e-4, 1e-5
REGS = dict(fft_size=N, ref_window_size=8, guard_window_size=2,
            threshold_scaler=3.5, div_sum=3)
WAIT_S = 60


def _chains():
    ca = dict(max_ref_window=16, variant="CA", include_cash=False,
              use_pallas=False)
    jcfg = R.ChainConfig(fft=R.FftConfig(max_size=N), cfar=R.CfarConfig(
        **{**ca, "variant": R.CfarVariant.CA}))
    tcfg = T.ChainConfig(fft=T.FftConfig(max_size=N), cfar=T.CfarConfig(
        **{**ca, "variant": T.CfarVariant.CA}))
    return (R.fft_mag_cfar_chain(jcfg).jit(),
            T.fft_mag_cfar_chain(tcfg, device="cpu"))


def _cpis(n, frames=4, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = (rng.randn(frames, N) + 1j * rng.randn(frames, N)) * 3
        x[:, 40] += 60
        out.append(x.astype(np.complex64))
    return out


def _wait(cond, what):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > WAIT_S:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


def _bar(thr, pk, thr_w, pk_w):
    thr_w = np.asarray(thr_w, np.float64)
    rel = np.abs(np.asarray(thr, np.float64) - thr_w).max() / np.abs(thr_w).max()
    flips = int((np.asarray(pk) != np.asarray(pk_w)).sum())
    assert rel < REL, rel
    assert flips <= FLIPS * np.asarray(pk_w).size + 0.5, flips


def _collect(results):
    lock = threading.Lock()

    def on_result(seq, out, m):
        with lock:
            results[seq] = (out, m)
    return on_result


def _drive(pipe, cpis, rt_go, results):
    """Three CPIs, a register write once they are out, three more."""
    with pipe:
        for s in range(3):
            pipe.submit(s, cpis[s])
        _wait(lambda: len(results) == 3, "the first three CPIs")
        pipe.reconfigure(rt_go)
        for s in range(3, 6):
            pipe.submit(s, cpis[s])
        _wait(lambda: len(results) == 6, "six CPIs")


def test_pipeline_matches_the_jax_pipeline_across_a_register_write():
    jchain, tchain = _chains()
    cpis = _cpis(6)
    rt_j = R.RuntimeConfig.make(**REGS)
    got, want = {}, {}
    _drive(JPipeline(jchain, rt_j, on_result=_collect(want)), cpis,
           rt_j.merge_regs(cfar_mode=1), want)
    rt_t = runtime_from_reference(rt_j.peek())
    pipe = StreamingPipeline(tchain, rt_t, on_result=_collect(got))
    assert pipe.device == torch.device("cpu")
    _drive(pipe, cpis, rt_t.merge_regs(cfar_mode=1), got)
    for s in range(6):
        out, m = got[s]
        ref, mj = want[s]
        _bar(out.threshold.numpy(), out.peaks.numpy(), ref.threshold,
             ref.peaks)
        assert m.detections == int(out.peaks.sum()) == mj.detections
        assert m.samples == mj.samples == 4 * N
    # the write landed between CPIs 2 and 3, whole
    direct = [tchain(cpis[s], rt_t if s < 3 else rt_t.merge_regs(cfar_mode=1))
              for s in range(6)]
    for s in range(6):
        assert torch.equal(got[s][0].threshold, direct[s].threshold)
    assert not torch.equal(tchain(cpis[4], rt_t).threshold,
                           direct[4].threshold)
    assert pipe.detections_total == sum(int(d.peaks.sum()) for d in direct)
    assert pipe.stats.frames_out == 6 and pipe.stats.frames_failed == 0
    assert set(pipe.stats.phase_ms_per_cpi()) == {
        "t_queue_wait", "t_place", "t_dispatch", "t_block", "t_result"}


@pytest.mark.parametrize("block_every,detections_every",
                         [(1, 1), (3, 1), (3, 4), (1, 0)])
def test_wait_and_fetch_cadences_deliver_every_cpi(block_every,
                                                   detections_every):
    _, tchain = _chains()
    cpis = _cpis(10, frames=2, seed=1)
    rt = T.RuntimeConfig.make(**REGS)
    got = {}
    pipe = StreamingPipeline(tchain, rt, on_result=_collect(got),
                             block_every=block_every,
                             detections_every=detections_every)
    with pipe:
        for s, c in enumerate(cpis):
            pipe.submit(s, c)
        _wait(lambda: len(got) == 10, "ten CPIs")
    counts = [int(tchain(c, rt).peaks.sum()) for c in cpis]
    dets = [got[s][1].detections for s in range(10)]
    if detections_every == 1:
        assert dets == counts
        assert pipe.detections_total == sum(counts)
    else:
        assert dets == [-1] * 10
        if detections_every > 1:
            assert pipe.detections_total == sum(counts[:8])
        else:
            assert pipe.detections_total == 0
    assert pipe.flush_detections() == sum(counts)
    assert pipe.stats.frames_out == 10 and pipe.stats.frames_failed == 0


def test_a_python_error_skips_one_cpi_and_the_stream_goes_on():
    _, tchain = _chains()
    cpis = _cpis(6, frames=1, seed=2)
    errors, got = [], {}

    def fn(x, rt):
        if x.re[0, 0] == float(np.float32(cpis[2][0, 0].real)):
            raise ValueError("bad CPI")
        return tchain(x, rt)

    def on_result(seq, out, m):
        if seq == 4:
            raise KeyError("consumer fault")
        got[seq] = out

    pipe = StreamingPipeline(fn, T.RuntimeConfig.make(**REGS), device="cpu",
                             on_result=on_result,
                             on_error=lambda s, e: errors.append((s, type(e))))
    with pipe:
        for s, c in enumerate(cpis):
            pipe.submit(s, c)
        _wait(lambda: len(got) + len(errors) == 6, "six CPIs or errors")
    assert sorted(got) == [0, 1, 3, 5]
    assert sorted(errors) == [(2, ValueError), (4, KeyError)]
    # as in the JAX package, a consumer's error leaves the CPI counted out
    assert pipe.stats.frames_failed == 1 and pipe.stats.frames_out == 5
    assert pipe.device_error is None


def test_a_cuda_error_is_sticky_and_stop_raises_it():
    errors = []

    def fn(x, rt):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    pipe = StreamingPipeline(fn, T.RuntimeConfig.make(**REGS), device="cpu",
                             on_error=lambda s, e: errors.append(s))
    pipe.start()
    for s in range(3):
        pipe.submit(s, _cpis(1, frames=1)[0])
    _wait(lambda: len(errors) == 3, "three failures")
    with pytest.raises(RuntimeError, match="CUDA error") as info:
        pipe.stop()
    assert "illegal memory access" in str(info.value.__cause__)
    assert pipe.stats.frames_failed == 3 and pipe.stats.frames_out == 0


def _watermarks(cls, chain, rt, **kw):
    """Hold the worker in its first CPI while six more queue, then let it
    go; returns the watermark interrupts in order."""
    gate, events = threading.Event(), []

    def fn(x, r):
        gate.wait(timeout=WAIT_S)
        return chain(x, r)

    pipe = cls(fn, rt, depth=8, watermark=(1, 4), on_watermark=events.append,
               **kw)
    cpi = _cpis(1, frames=1)[0]
    with pipe:
        pipe.submit(0, cpi)
        _wait(lambda: pipe._q.qsize() == 0, "the worker to take CPI 0")
        for s in range(1, 7):
            pipe.submit(s, cpi)
        gate.set()
        _wait(lambda: pipe.stats.frames_out == 7, "seven CPIs")
    return events


def test_watermark_edges_fire_as_the_jax_pipeline_fires_them():
    jchain, tchain = _chains()
    rt_j = R.RuntimeConfig.make(**REGS)
    want = _watermarks(JPipeline, jchain, rt_j)
    got = _watermarks(StreamingPipeline, tchain,
                      runtime_from_reference(rt_j.peek()), device="cpu")
    assert got == want == ["low", "high", "low"]


def test_the_pipeline_raises_without_a_card_and_on_a_device_mismatch():
    _, tchain = _chains()
    rt = T.RuntimeConfig.make(**REGS)
    with pytest.raises(ValueError, match="runs on cpu"):
        StreamingPipeline(tchain, rt, device="cuda")
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA card"):
        StreamingPipeline(lambda x, r: x, rt)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        StreamingPipeline(T.fft_mag_cfar_chain(), rt)


def test_checkpoint_resumes_with_equal_outputs(tmp_path):
    _, tchain = _chains()
    rt = T.RuntimeConfig.make(**REGS).merge_regs(cfar_mode=2)
    pulses = _cpis(1, frames=8, seed=3)[0]
    buf = CpiBuffer(num_pulses=8, n_range=N)
    for p in pulses[:5]:
        buf.push(p)
    got, got2 = {}, {}
    pipe = StreamingPipeline(tchain, rt, on_result=_collect(got))
    pipe.checkpoint(tmp_path / "ck", buf, cursor=5)
    buf2 = CpiBuffer(num_pulses=8, n_range=N)
    rt2, extras = load_state(tmp_path / "ck", buf2)
    assert int(extras["cursor"]) == 5 and rt2.peek() == rt.peek()
    pipe2 = StreamingPipeline(tchain, rt2, on_result=_collect(got2))
    for p, b, res in ((pipe, buf, got), (pipe2, buf2, got2)):
        with p:
            for pulse in pulses[5:]:
                cpi = b.push(pulse)
            p.submit(0, cpi)
            _wait(lambda: len(res) == 1, "the resumed CPI")
    assert torch.equal(got[0][0].threshold, got2[0][0].threshold)
    assert torch.equal(got[0][0].peaks, got2[0][0].peaks)


# ---- the chain server ----

def _config_frame(mod, kw, seq=0):
    payload = json.dumps(kw).encode() + b"\0"
    payload += b"\0" * ((-len(payload)) % 4)
    return mod.encode_frame(np.frombuffer(payload, np.uint32), seq,
                            config=True)


def _exchange(sock, mod, payloads, n_replies):
    for p in payloads:
        sock.sendall(p)
    dec, got = mod.FrameDecoder(), []
    t0 = time.time()
    while len(got) < n_replies:
        if time.time() - t0 > WAIT_S:
            raise AssertionError("timed out waiting for replies")
        chunk = sock.recv(1 << 16)
        if not chunk:
            break
        got.extend(dec.feed(chunk))
    return got


def _session(srv_port, mod, iqs):
    """Three requests, a config frame writing the scaler, two requests, a
    config frame clearing run_last, one request; returns the replies."""
    with socket.create_connection(("127.0.0.1", srv_port),
                                  timeout=WAIT_S) as sock:
        sock.settimeout(WAIT_S)
        enc = mod.encode_iq_frame
        out = _exchange(sock, mod, [enc(iqs[i], i, channel=3)
                                    for i in range(3)], 3)
        out += _exchange(sock, mod, [_config_frame(mod, {
            "threshold_scaler": 5.0})] + [enc(iqs[i], i, channel=3)
                                         for i in range(3, 5)], 2)
        out += _exchange(sock, mod, [_config_frame(mod, {"mem_run_last": 0}),
                                     enc(iqs[5], 5, channel=3)], 1)
    return out


def test_both_servers_answer_the_same_frames():
    jchain, tchain = _chains()
    rng = np.random.RandomState(4)
    iqs = [np.round((rng.randn(N) + 1j * rng.randn(N)) * 30
                    + 400 * np.exp(2j * np.pi * 0.2 * np.arange(N))
                    ).astype(np.complex64) for _ in range(6)]
    rt_j = R.RuntimeConfig.make(**REGS)
    jsrv = JChainServer(jchain, rt_j, frame_len=N, log2_fft_size=8)
    tsrv = ChainServer(tchain, runtime_from_reference(rt_j.peek()),
                       frame_len=N, log2_fft_size=8)
    with jsrv, tsrv:
        want = _session(jsrv.port, jframing, iqs)
        got = _session(tsrv.port, tframing, iqs)
    assert [(f.seq, f.channel, f.last) for f in got] == \
        [(f.seq, f.channel, f.last) for f in want] == \
        [(i, 3, i < 5) for i in range(6)]
    rt = runtime_from_reference(rt_j.peek())
    for i, (g, w) in enumerate(zip(got, want)):
        thr, bins, pk = (v.numpy() for v in TP.unpack_cfar_words(g.words, 8))
        thr_w, bins_w, pk_w = (v.numpy() for v in TP.unpack_cfar_words(
            w.words, 8))
        np.testing.assert_array_equal(pk, pk_w)
        np.testing.assert_array_equal(bins, bins_w)
        assert np.abs(thr.astype(np.int64) - thr_w).max() <= 1
        _bar(thr, pk, thr_w, pk_w)
        # each reply is the direct call under the registers live at its
        # request: the scaler write takes effect from the next frame
        r = rt if i < 3 else rt.merge_regs(threshold_scaler=5.0)
        d = tchain(iqs[i][None], r)
        np.testing.assert_array_equal(
            g.words, TP.pack_cfar_words(d.threshold[0], d.peaks[0], 8)
            .numpy().view(np.uint32))
    assert tsrv.config_errors == 0 and tsrv.results_dropped == 0


def test_two_connections_get_their_own_replies():
    _, tchain = _chains()
    iqs = _cpis(1, frames=8, seed=5)[0]
    with ChainServer(tchain, T.RuntimeConfig.make(**REGS), frame_len=N,
                     log2_fft_size=8) as srv:
        res = {}

        def client(c):
            res[c] = request_frames("127.0.0.1", srv.port,
                                    list(iqs[c::2]), timeout=WAIT_S)

        ts = [threading.Thread(target=client, args=(c,)) for c in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=WAIT_S)
        assert not any(t.is_alive() for t in ts)
    rt = T.RuntimeConfig.make(**REGS)
    for c in range(2):
        assert [f.seq for f in res[c]] == list(range(4))
        for f, iq in zip(res[c], iqs[c::2]):
            # the request carries the samples rounded to int16 beat words
            d = tchain(native.unpack_iq_c64(native.pack_iq_c64(iq))[None], rt)
            np.testing.assert_array_equal(
                f.words, TP.pack_cfar_words(d.threshold[0], d.peaks[0], 8)
                .numpy().view(np.uint32))


def test_a_config_frame_merges_and_a_bad_one_is_counted():
    _, tchain = _chains()
    with ChainServer(tchain, T.RuntimeConfig.make(**REGS), frame_len=N,
                     log2_fft_size=8, cfar_cfg=tchain.cfg.cfar) as srv:
        with socket.create_connection(("127.0.0.1", srv.port),
                                      timeout=WAIT_S) as sock:
            sock.sendall(_config_frame(tframing, {"threshold_scaler": 9.0}))
            _wait(lambda: srv._pipe.runtime.threshold_scaler == 9.0,
                  "the scaler write")
            regs = srv._pipe.runtime.peek()
            assert regs["fft_size"] == N and regs["ref_window_size"] == 8
            sock.sendall(_config_frame(tframing, {"ref_window_size": 3}))
            sock.sendall(_config_frame(tframing, {"ref_window_size": 32}))
            _wait(lambda: srv.config_errors == 2, "two rejected writes")
            assert srv._pipe.runtime.peek() == regs


# ---- the control port ----

def test_peek_poke_and_rejected_writes():
    _, tchain = _chains()
    pipe = StreamingPipeline(tchain, T.RuntimeConfig.make(**REGS))
    with pipe, ControlServer(lambda: pipe.runtime, pipe.reconfigure,
                             cfar_cfg=tchain.cfg.cfar,
                             update_rt=pipe.update_runtime) as srv:
        regs = poke("127.0.0.1", srv.port)["regs"]
        assert regs == T.RuntimeConfig.make(**REGS).peek()
        new = poke("127.0.0.1", srv.port, {"cfar_mode": 1,
                                           "threshold_scaler": 4.5})["regs"]
        assert new == {**regs, "cfar_mode": 1, "threshold_scaler": 4.5}
        assert pipe.runtime.peek() == new
        for bad in ({"ref_window_size": 3}, {"ref_window_size": 64},
                    {"no_such_register": 1}):
            with pytest.raises(RuntimeError, match="poke rejected"):
                poke("127.0.0.1", srv.port, bad)
        assert pipe.runtime.peek() == new
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = tcli.main(["poke", "--port", str(srv.port), "--set",
                            "peak_grouping=1"])
        assert rc == 0 and json.loads(buf.getvalue())["peak_grouping"] == 1
        assert pipe.runtime.peak_grouping == 1


def test_the_poke_is_atomic_against_a_concurrent_reconfigure():
    _, tchain = _chains()
    pipe = StreamingPipeline(tchain, T.RuntimeConfig.make(**REGS))
    gate = threading.Event()

    def slow_update(fn):
        def slow(cur):
            gate.wait(timeout=5)
            time.sleep(0.05)   # the racing reconfigure must block meanwhile
            return fn(cur)
        return pipe.update_runtime(slow)

    with pipe, ControlServer(lambda: pipe.runtime, pipe.reconfigure,
                             cfar_cfg=tchain.cfg.cfar,
                             update_rt=slow_update) as srv:
        t = threading.Thread(target=lambda: poke(
            "127.0.0.1", srv.port, {"peak_grouping": 1}))
        racer = threading.Thread(target=lambda: (
            gate.wait(timeout=5),
            pipe.reconfigure(T.RuntimeConfig.make(**REGS).merge_regs(
                threshold_scaler=9.0))))
        t.start()
        racer.start()
        gate.set()
        t.join(timeout=WAIT_S)
        racer.join(timeout=WAIT_S)
        assert not t.is_alive() and not racer.is_alive()
        regs = poke("127.0.0.1", srv.port)["regs"]
    # one serialization or the other, never a merged write reverted
    assert (regs["peak_grouping"], regs["threshold_scaler"]) in (
        (0, 9.0), (1, 9.0)), regs
