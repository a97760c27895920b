"""The frozen plain references against the port's plain ops and golden
models at a small size on the CPU. The test imports the port; the references
themselves import nothing of it."""

from __future__ import annotations

import ast

import numpy as np
import pytest
import torch

from rspbench import cells, inputs, run
from rspbench.reference import bit_true_chain, float_chain
from rspbench_small import small_cell

import rsp_chains_tpu_torch as rsp
from rsp_chains_tpu_torch.golden import models
from rsp_chains_tpu_torch.golden import int_models
from rsp_chains_tpu_torch.ops import bit_true, cfar, fft, logmag

GOS = {"cfar_algorithm": 1}
CA = {"cfar_algorithm": 0}


def _cpi(cell_name, seed=2**31 + 3):
    cell = small_cell(cell_name)
    (re, im), = inputs.make_ring(cell.config, 1, seed, "cpu")
    return cell, re, im


@pytest.mark.parametrize("regs", [GOS, CA, {**GOS, "cfar_mode": 1},
                                  {**CA, "cfar_mode": 2}])
def test_float_reference_matches_the_ports_plain_ops(regs):
    cell, re, im = _cpi("float_gosca.gos_sat")
    r = {**cell.config["registers"], **regs}
    thr, pk = float_chain.chain(re, im, r)
    chain, _ = run.build(cell.config, {"registers": regs}, "cpu")
    rt = rsp.RuntimeConfig.make(**r)
    spec = fft.fft_op(rsp.C(re, im), rt.log2_fft_size, chain.cfg.fft)
    out = cfar.cfar_op(logmag.logmag(spec, rt.mag_mode), rt, chain.cfg.cfar)
    rel = ((out.threshold.double() - thr).abs()
           / thr.abs().clamp_min(1e-300)).max()
    assert float(rel) < 1e-5
    assert int((out.peaks != pk).sum()) <= 2


@pytest.mark.parametrize("regs", [GOS, CA, {**GOS, "cfar_mode": 2},
                                  {**CA, "cfar_mode": 1}])
def test_bit_true_reference_equals_the_ports_integer_ops(regs):
    cell, re, im = _cpi("int_gosca.gos_sat")
    r = {**cell.config["registers"], **regs}
    thr, pk = bit_true_chain.chain(re, im, r)
    chain, _ = run.build(cell.config, {"registers": regs}, "cpu")
    rt = rsp.RuntimeConfig.make(**r)
    spec = bit_true.fft_int_op(rsp.C(re, im), None, chain.cfg.fft)
    out = bit_true.cfar_int(bit_true.mag_int_op(spec, rt.mag_mode), rt,
                            chain.cfg.cfar)
    assert torch.equal(out.threshold.long(), thr)
    assert torch.equal(out.peaks, pk)


def test_references_equal_the_golden_models_on_frames():
    cell, re, im = _cpi("int_gosca.gos_sat")
    r = {**cell.config["registers"], **GOS}
    xr, xi = re.reshape(-1, 1024)[:2].numpy(), im.reshape(-1, 1024)[:2].numpy()
    gr, gi = int_models.int_fft_golden(xr, xi)
    sr, si = bit_true_chain.bit_true_fft(torch.from_numpy(xr).long(),
                                         torch.from_numpy(xi).long())
    assert np.array_equal(sr.numpy(), gr) and np.array_equal(si.numpy(), gi)
    mag = int_models.int_jpl_golden(gr, gi)
    thr, pk = bit_true_chain.chain(torch.from_numpy(xr), torch.from_numpy(xi),
                                   r)
    for f in range(2):
        gt, gp = int_models.int_gosca_cfar_golden(
            mag[f], ref_window=32, guard_window=4, div_sum=5,
            threshold_scaler=3.5, wmax=64, algorithm=1, mode=0,
            rank_lagg=16, rank_lead=16)
        assert np.array_equal(thr[f].numpy(), gt)
        assert np.array_equal(pk[f].numpy(), gp)

    cell, re, im = _cpi("float_gosca.gos_sat")
    x = (re.reshape(-1, 1024)[:1].double() + 1j * im.reshape(-1, 1024)[:1]
         .double()).numpy()
    gm = models.jpl_mag(models.fft_golden(x))
    for regs, kw in ((GOS, dict(algorithm=1, index_lagg=16, index_lead=16)),
                     (CA, dict(algorithm=0, div_sum=5))):
        r = {**cell.config["registers"], **regs}
        thr, pk = float_chain.chain(torch.from_numpy(x.real.copy()),
                                    torch.from_numpy(x.imag.copy()), r)
        gt, gp = models.cfar_golden(gm[0], ref_window=32, guard_window=4,
                                    threshold_scaler=3.5, mode=0, **kw)
        assert np.allclose(thr[0].numpy(), gt, rtol=1e-12, atol=0)
        assert np.array_equal(pk[0].numpy(), gp)


def test_references_refuse_registers_they_do_not_compute():
    cell, re, im = _cpi("int_gosca.gos_sat")
    r = {**cell.config["registers"], "cfar_mode": 3}
    with pytest.raises(ValueError):
        bit_true_chain.chain(re, im, r)
    with pytest.raises(ValueError):
        float_chain.chain(re.float(), im.float(), {**r, "cfar_mode": 0,
                                                   "fft_size": 512})


def test_references_import_torch_and_numpy_alone():
    for mod in (bit_true_chain, float_chain):
        tree = ast.parse(open(mod.__file__).read())
        tops = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                assert node.level == 0
                tops.add(node.module.split(".")[0])
        assert tops <= {"__future__", "functools", "math", "numpy", "torch"}


def test_ring_follows_the_seed_and_keeps_its_sizes():
    cell = small_cell("int_gosca.gos_sat")
    a = inputs.make_ring(cell.config, 2, 2**31 + 1, "cpu")
    b = inputs.make_ring(cell.config, 2, 2**31 + 1, "cpu")
    c = inputs.make_ring(cell.config, 2, 2**31 + 2, "cpu")
    assert all(torch.equal(x, y) for p, q in zip(a, b) for x, y in zip(p, q))
    assert not torch.equal(a[0][0], c[0][0])
    assert not torch.equal(a[0][0], a[1][0])
    assert a[0][0].dtype == torch.int32 and a[0][0].shape == (2, 4, 1024)
    assert int(a[0][0].abs().max()) <= 32767
    cfg = cells.resolve("float_gosca.gos_sat").config
    assert cfg["scene"] == cell.config["scene"]
