"""The PyTorch port's pod path (``parallel.multihost``) against the JAX
package's, on the CPU: the pod mesh's layout rules and errors, ``pod_spec``,
``shard_cpi_stream`` and ``PodStreamingPipeline`` in one process, and in two
processes of four CPU devices each, joined by ``torch.distributed`` (gloo,
meeting at a ``file://`` store under the test's ``tmp_path``) on the ``(cpi=2,
ch=2, rng=2)`` mesh that ``tests/test_multihost.py`` runs: one-shot,
streaming with a register write and a checkpoint after CPI 2 and a restored
pipeline, a CPI that fails in one process only, and a count whose fetch fails
in one process while the callers issue collectives of their own.

Every shard is held against the JAX package's unsharded
``fft_mag_cfar_chain(cfg).jit()`` at JAX's own bar (``rtol=1e-5,
atol=1e-4``, peaks equal), and every global detection count against the
unsharded chain's peaks. Each child process has a timeout, after which the
pair is killed.

The child processes run this file: ``python tests/test_torch_multihost.py
MODE RANK INIT OUTDIR``."""

import functools
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import rsp_chains_tpu_torch as T
from rsp_chains_tpu_torch.io.cpi import load_state
from rsp_chains_tpu_torch.parallel import multihost as M

N = 256
REGS = dict(fft_size=N, ref_window_size=8, guard_window_size=2,
            threshold_scaler=3.5, div_sum=3)
CFG = dict(max_ref_window=16, max_guard_window=8)
N_CPIS = 6
CHILD_S = 120     # each child's time limit
GROUP_S = 60      # the process group's timeout on a collective


def _cpi(seq=None):
    """The ``[T=2, C=2, N]`` batch of tests/multihost_driver.py: CPI ``seq``
    of the stream, or the one-shot batch."""
    base = 0 if seq is None else 100 * seq
    return np.stack([
        np.stack([T.golden.three_tone_signal(N, shift_range_factor=3,
                                             seed=base + s + 10 * t)
                  for s in range(2)])
        for t in range(2)]).astype(np.complex64)


def _tchain():
    cfg = T.ChainConfig(fft=T.FftConfig(max_size=N), cfar=T.CfarConfig(**CFG))
    return T.fft_mag_cfar_chain(cfg, device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_chain():
    import rsp_chains_tpu as R

    cfg = R.ChainConfig(fft=R.FftConfig(max_size=N),
                        cfar=R.CfarConfig(**CFG))
    return R.fft_mag_cfar_chain(cfg).jit()


def _jax_want(jf, iq, scaler=3.5):
    import rsp_chains_tpu as R

    rt = R.RuntimeConfig.make(**{**REGS, "threshold_scaler": scaler})
    out = jf(R.as_pair(iq), rt)
    return np.asarray(out.threshold), np.asarray(out.peaks)


def _check_shard(index, thr, pk, want_thr, want_pk):
    sl = tuple(slice(a, b) for a, b in index)
    np.testing.assert_allclose(thr, want_thr[sl], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(pk.astype(bool), want_pk[sl])


def _index(shard):
    return np.array([[s.start, s.stop] for s in shard.index], np.int64)


def _fake(procs):
    return [M.PodDevice(p, i, torch.device("cpu"))
            for i, p in enumerate(procs)]


# ---- layout ----------------------------------------------------------------

def test_pod_mesh_groups_devices_by_process():
    """make_pod_mesh must not put devices from different processes in one
    (ch, rng) time block even when the device list interleaves them."""
    mesh = M.make_pod_mesh(time_blocks=2, channels=2, range_shards=2,
                           devices=_fake([i % 2 for i in range(8)]))
    for t in range(2):
        procs = {d.process_index for row in mesh.devices[t] for d in row}
        assert len(procs) == 1, f"time block {t} spans processes {procs}"
    assert [d.id for d in mesh.devices[0][0]] == [0, 2]


def test_pod_mesh_rejects_block_straddling_hosts():
    with pytest.raises(ValueError, match="intra-host"):
        M.make_pod_mesh(time_blocks=1, channels=8, range_shards=1,
                        devices=_fake([i // 4 for i in range(8)]))


@pytest.mark.parametrize("procs,args,shape", [
    ([0] * 4, {}, (1, 4, 1)),
    ([0] * 4, dict(range_shards=2), (1, 2, 2)),
    ([0, 0, 1, 1], {}, (2, 2, 1)),
    ([0] * 4 + [1] * 4, dict(range_shards=2), (2, 2, 2)),
    ([0] * 4 + [1] * 4, dict(time_blocks=4), (4, 2, 1)),
    ([0] * 4 + [1] * 4, dict(time_blocks=4, channels=1, range_shards=2),
     (4, 1, 2)),
])
def test_pod_mesh_arithmetic(procs, args, shape):
    """The defaults of JAX's make_pod_mesh: one time block a process, the
    channels from the rest; this process (0, no group) holds the blocks of
    process 0."""
    mesh = M.make_pod_mesh(devices=_fake(procs), **args)
    assert tuple(mesh.shape.values()) == shape
    assert mesh.axis_names == (M.TIME_AXIS, "ch", "rng")
    assert M.TIME_AXIS == "cpi"
    local = mesh.local_blocks()
    assert [t for t, _ in local] == [
        t for t in range(shape[0]) if mesh.devices[t][0][0].process_index == 0]
    assert all(sub.shape == {"ch": shape[1], "rng": shape[2]}
               for _, sub in local)


@pytest.mark.parametrize("procs,args,match", [
    ([0] * 8, dict(time_blocks=3), "!= 8 devices"),
    ([0] * 8, dict(time_blocks=2, channels=2, range_shards=3),
     "!= 8 devices"),
    ([0] * 4 + [1] * 4, dict(time_blocks=1), "intra-host"),
    ([0] * 4 + [1] * 4, dict(time_blocks=2, channels=1, range_shards=4),
     None),
    ([], {}, "!= 0 devices"),
    ([0] * 6 + [1] * 2, dict(time_blocks=2, channels=4), "intra-host"),
])
def test_pod_mesh_errors(procs, args, match):
    if match is None:
        M.make_pod_mesh(devices=_fake(procs), **args)
        return
    with pytest.raises(ValueError, match=match):
        M.make_pod_mesh(devices=_fake(procs), **args)


@pytest.mark.parametrize("batch_axes", [1, 2, 3])
def test_pod_spec_matches_the_jax_partition_spec(batch_axes):
    from rsp_chains_tpu.parallel import multihost as JM

    assert M.TIME_AXIS == JM.TIME_AXIS
    want = tuple(JM.pod_spec(batch_axes))
    got = M.pod_spec(batch_axes)
    assert len(got) == len(want) == batch_axes + 2
    for g, w in zip(got, want):
        assert g == w


def test_one_process_cluster_is_a_no_op_and_lists_its_devices():
    assert M.initialize_cluster() == 0
    assert M.initialize_cluster(num_processes=1) == 0
    devs = M.global_devices(["cpu", "cpu"])
    assert devs == [M.PodDevice(0, 0, torch.device("cpu")),
                    M.PodDevice(0, 1, torch.device("cpu"))]
    with pytest.raises(ValueError, match="coordinator_address"):
        M.initialize_cluster(num_processes=2, process_id=0)


@pytest.mark.parametrize("what", ["plain callable", "fixed-point chain",
                                  "range-Doppler chain"])
def test_a_multi_device_block_refuses_what_it_cannot_shard(what):
    """No partitioner: a block of several devices runs
    make_sharded_pipeline, so any function but a float fft_mag_cfar_chain
    raises, where gathering onto one device would hide the layout."""
    mesh = M.make_pod_mesh(channels=2, devices=_fake([0, 0]))
    if what == "plain callable":
        fn = _tchain().__call__
    elif what == "fixed-point chain":
        fn = T.fft_mag_cfar_chain(T.ChainConfig(
            fft=T.FftConfig(max_size=N), cfar=T.CfarConfig(**CFG),
            fixed_point=T.FixedPointConfig(enabled=True, width=16,
                                           bin_point=0, bit_true=True)),
            device="cpu")
    else:
        fn = T.range_doppler_chain(T.ChainConfig(
            fft=T.FftConfig(max_size=N),
            doppler=T.DopplerConfig(num_pulses=8),
            cfar=T.CfarConfig(**CFG)), device="cpu")
    with pytest.raises(ValueError, match="make_sharded_pipeline"):
        M.shard_cpi_stream(fn, mesh)
    # one device a block calls any function
    M.shard_cpi_stream(fn, M.make_pod_mesh(devices=_fake([0])))


def test_place_copies_only_this_process_rows():
    """Process 0 of a two-process layout (process 1's devices listed, as
    global_devices would give them) places only its own time block."""
    mesh = M.make_pod_mesh(time_blocks=2, channels=2,
                           devices=_fake([0, 0, 1, 1]))
    pipe = M.PodStreamingPipeline(_tchain(), T.RuntimeConfig.make(**REGS),
                                  mesh)
    iq = _cpi()
    placed = pipe._place(iq)
    assert len(placed) == 1
    assert [(s.start, s.stop) for s in placed[0].index] == [(0, 1), (0, 2),
                                                            (0, N)]
    assert tuple(placed[0].data.shape) == (1, 2, N)
    np.testing.assert_array_equal(placed[0].data.re.numpy(), iq[:1].real)
    # only rows 0:1 of the batch are read: the other block may be anything
    poisoned = iq.copy()
    poisoned[1] = np.nan
    assert torch.equal(pipe._place(poisoned)[0].data.re, placed[0].data.re)
    with pytest.raises(ValueError, match="drops no CPI"):
        M.PodStreamingPipeline(_tchain(), T.RuntimeConfig.make(**REGS), mesh,
                               drop_on_full=True)


def _wait(cond, what, budget=60):
    t0 = time.time()
    while not cond():
        if time.time() - t0 > budget:
            raise TimeoutError(f"waited {budget} s for {what}")
        time.sleep(0.01)


def test_one_process_pod_pipeline_on_a_2x2_mesh_matches_jax():
    """One process, a (cpi=1, ch=2, rng=2) mesh of CPU devices: each
    [2, 2, N] batch runs as two sharded steps of one time block."""
    mesh = M.make_pod_mesh(channels=2, range_shards=2,
                           devices=M.global_devices(["cpu"] * 4))
    assert mesh.shape == {"cpi": 1, "ch": 2, "rng": 2}
    rt = T.RuntimeConfig.make(**REGS)
    got = {}
    pipe = M.PodStreamingPipeline(
        _tchain(), rt, mesh, on_result=lambda s, o, m: got.__setitem__(
            s, (o, m)))
    with pipe:
        for seq in range(3):
            pipe.submit(seq, _cpi(seq))
        _wait(lambda: len(got) == 3, "three CPIs")
    jf = _jax_chain()
    total = 0
    for seq in range(3):
        want_thr, want_pk = _jax_want(jf, _cpi(seq))
        out, m = got[seq]
        assert len(out) == 1
        _check_shard(_index(out[0]), out[0].data.threshold.numpy(),
                     out[0].data.peaks.numpy(), want_thr, want_pk)
        assert m.detections == int(want_pk.sum())
        total += int(want_pk.sum())
    assert pipe.detections_total == total == pipe.flush_detections()
    assert pipe.stats.frames_out == 3 and pipe.stats.frames_failed == 0


# ---- two processes -----------------------------------------------------------

def _run_pair(tmp_path, mode):
    """Run the two child processes of ``mode``; kill both when either
    outlives CHILD_S. Returns each child's saved arrays."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": root, "OMP_NUM_THREADS": "1"}
    init = f"file://{tmp_path}/store"
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), mode, str(rank), init,
         str(tmp_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_S)
            outs.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rc, err in outs:
        assert rc == 0, err.decode()[-3000:]
    return [dict(np.load(tmp_path / f"{mode}{rank}.npz")) for rank in (0, 1)]


def test_two_process_pod_mesh_matches_unsharded(tmp_path):
    z = _run_pair(tmp_path, "oneshot")
    want_thr, want_pk = _jax_want(_jax_chain(), _cpi())
    blocks = []
    for rank in (0, 1):
        assert list(z[rank]["devices"]) == [0] * 4 + [1] * 4
        idx = z[rank]["idx"]
        _check_shard(idx, z[rank]["thr"], z[rank]["pk"], want_thr, want_pk)
        blocks.append(tuple(idx[0]))
    # each process produced its own time block, and together every block
    assert blocks == [(0, 1), (1, 2)]


def test_two_process_pod_streaming_with_checkpoint_restore(tmp_path):
    """BASELINE config 5 end to end: 6 CPIs through PodStreamingPipeline in
    two processes, a register write and a checkpoint after CPI 2, a restored
    pipeline finishing CPIs 3..5; every shard equals the unsharded JAX chain
    and every process's global count the chain's peaks."""
    z = _run_pair(tmp_path, "stream")
    jf = _jax_chain()
    for seq in range(N_CPIS):
        want_thr, want_pk = _jax_want(jf, _cpi(seq),
                                      3.5 if seq < 3 else 5.0)
        for rank in (0, 1):
            _check_shard(z[rank][f"idx{seq}"], z[rank][f"thr{seq}"],
                         z[rank][f"pk{seq}"], want_thr, want_pk)
            assert z[rank][f"idx{seq}"][0].tolist() == [rank, rank + 1]
            assert int(z[rank]["detections"][seq]) == int(want_pk.sum()), seq
    for rank in (0, 1):
        assert z[rank]["totals"].tolist() == [
            sum(int(_jax_want(jf, _cpi(s))[1].sum()) for s in range(3)),
            int(z[rank]["detections"][3:].sum())]


def test_a_cpi_failing_in_one_process_takes_part_with_zero(tmp_path):
    """Process 1's function raises on CPI 1. Both processes end well inside
    the timeout: the failed CPI still takes part in the reduction, adding 0,
    so CPI 1's global count is process 0's alone and every later CPI's is
    whole."""
    t0 = time.time()
    z = _run_pair(tmp_path, "fail")
    assert time.time() - t0 < GROUP_S
    jf = _jax_chain()
    assert z[0]["failed"] == 0 and z[1]["failed"] == 1
    assert z[1]["errors"].tolist() == [1]
    for seq in range(4):
        want_pk = _jax_want(jf, _cpi(seq))[1]
        counts = [int(want_pk[t].sum()) for t in (0, 1)]
        want = counts[0] if seq == 1 else sum(counts)
        assert int(z[0]["detections"][seq]) == want, seq
        if seq != 1:
            assert int(z[1]["detections"][seq]) == want, seq
    assert int(z[1]["detections"][1]) == -1   # no result for the failed CPI
    assert z[0]["total"] == z[1]["total"]


def test_a_failed_count_fetch_takes_part_beside_the_callers_collectives(
        tmp_path):
    """Process 1's fetch of CPI 1's count raises, and both main threads
    issue a barrier after every submit while the drains reduce. Both
    processes end, the failure reaches on_error, CPI 1's global count is
    process 0's alone and every later count is whole: the pipeline's
    reductions stay paired CPI by CPI, on a group of their own."""
    z = _run_pair(tmp_path, "fetchfail")
    jf = _jax_chain()
    assert z[0]["failed"] == z[1]["failed"] == 0
    assert z[0]["errors"].tolist() == [] and z[1]["errors"].tolist() == [1]
    total = 0
    for seq in range(4):
        want_pk = _jax_want(jf, _cpi(seq))[1]
        counts = [int(want_pk[t].sum()) for t in (0, 1)]
        total += sum(counts)
        want = counts[0] if seq == 1 else sum(counts)
        assert int(z[0]["detections"][seq]) == want, seq
        if seq != 1:
            assert int(z[1]["detections"][seq]) == want, seq
    assert int(z[1]["detections"][1]) == -1   # no result for the failed count
    assert z[0]["total"] == z[1]["total"] == total


# ---- the child processes -----------------------------------------------------

def _child(mode, rank, init, outdir):
    torch.set_num_threads(1)
    M.initialize_cluster(num_processes=2, process_id=rank, init_method=init,
                         timeout_s=GROUP_S)
    one = mode in ("fail", "fetchfail")   # one device a time block
    local = ["cpu"] if one else ["cpu"] * 4
    devs = M.global_devices(local)
    assert M.process_count() == 2 and len(devs) == 2 * len(local)
    mesh = (M.make_pod_mesh(time_blocks=2, devices=devs) if one
            else M.make_pod_mesh(time_blocks=2, channels=2, range_shards=2,
                                 devices=devs))
    chain = _tchain()
    rt = T.RuntimeConfig.make(**REGS)
    store = {"devices": np.array([d.process_index for d in devs])}
    dets = np.full(N_CPIS, -1, np.int64)

    def keep(seq, out, m):
        (s,) = out
        store[f"thr{seq}"] = s.data.threshold.numpy()
        store[f"pk{seq}"] = s.data.peaks.numpy()
        store[f"idx{seq}"] = _index(s)
        dets[seq] = m.detections

    def wait_out(pipe, k, what):
        _wait(lambda: pipe.stats.frames_out + pipe.stats.frames_failed >= k,
              f"rank {rank}: {what}")

    if mode == "oneshot":
        (s,) = M.shard_cpi_stream(chain, mesh)(_cpi(), rt)
        store.update(thr=s.data.threshold.numpy(), pk=s.data.peaks.numpy(),
                     idx=_index(s))
    elif mode == "stream":
        pipe = M.PodStreamingPipeline(chain, rt, mesh, on_result=keep)
        pipe.start()
        for seq in range(3):
            assert pipe.submit(seq, _cpi(seq))
        wait_out(pipe, 3, "CPIs 0-2")
        # a register write, then a checkpoint of the registers and the
        # cursor; every process writes its own identical copy
        pipe.reconfigure(pipe.runtime.merge_regs(threshold_scaler=5.0))
        ck = os.path.join(outdir, f"ckpt{rank}")
        pipe.checkpoint(ck, next_seq=np.int64(3))
        pipe.stop()
        first_total = pipe.detections_total
        rt2, extras = load_state(ck)
        assert float(rt2.threshold_scaler) == 5.0
        start = int(extras["next_seq"])
        assert start == 3
        with M.PodStreamingPipeline(chain, rt2, mesh, on_result=keep) as pipe2:
            for seq in range(start, N_CPIS):
                assert pipe2.submit(seq, _cpi(seq))
            wait_out(pipe2, N_CPIS - start, "CPIs 3-5")
        assert pipe.stats.frames_out + pipe2.stats.frames_out == N_CPIS
        assert pipe.stats.frames_failed == pipe2.stats.frames_failed == 0
        store["totals"] = np.array([first_total, pipe2.detections_total])
    elif mode == "fetchfail":
        errors = []
        pipe = M.PodStreamingPipeline(chain, rt, mesh, on_result=keep,
                                      on_error=lambda s, e: errors.append(s))
        if rank == 1:
            fetch, calls = pipe._fetch, []

            def broken(count, ev):
                calls.append(1)
                if len(calls) == 3:   # CPI 1's own count (2 fetches a CPI)
                    raise RuntimeError("a count fetch fails on process 1")
                return fetch(count, ev)

            pipe._fetch = broken
        with pipe:
            for seq in range(4):
                assert pipe.submit(seq, _cpi(seq))
                # the caller's collective, beside the drain's reductions
                torch.distributed.barrier()
            wait_out(pipe, 4, "CPIs 0-3")
        store.update(failed=np.int64(pipe.stats.frames_failed),
                     errors=np.array(errors, np.int64),
                     total=np.int64(pipe.detections_total))
    else:
        calls = []

        def flaky(x, rt_):
            calls.append(1)
            if rank == 1 and len(calls) == 2:
                raise ValueError("a bad CPI on process 1")
            return chain(x, rt_)

        errors = []
        with M.PodStreamingPipeline(
                flaky, rt, mesh, on_result=keep,
                on_error=lambda s, e: errors.append(s)) as pipe:
            for seq in range(4):
                assert pipe.submit(seq, _cpi(seq))
            wait_out(pipe, 4, "CPIs 0-3")
        store.update(failed=np.int64(pipe.stats.frames_failed),
                     errors=np.array(errors), total=np.int64(
                         pipe.detections_total))
    store["detections"] = dets
    np.savez(os.path.join(outdir, f"{mode}{rank}.npz"), **store)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
