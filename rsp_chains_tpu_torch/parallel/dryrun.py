"""The five cross-checked sharded datapaths of the JAX package's
``__graft_entry__.dryrun_multichip`` (:84-243), on the port.

``dryrun_multichip(devices)`` builds the JAX dry run's mesh over ``devices``
(a list that may repeat a device: ``["cuda:0"] * 8`` is eight virtual
shards of one card) and runs, at its shape (CPIs of 64 pulses x 1024 range
cells, a 128-tap chirp, w = 32 reference windows):

1. ``plain``: ``make_sharded_rd_pipeline`` with ``use_pallas=False``;
2. ``fused``: the same with the kernels (Kernel H's map per channel shard,
   then Kernel B or C on the halo-extended range shards);
3. ``rdma-halo``: ``range_sharded_mag_cfar`` with ``use_rdma_halo`` on a
   range-only mesh (Kernel L, then Kernel B or C on the given magnitude);
4. ``sharded-1d``: ``make_sharded_pipeline`` of a CA elaboration against the
   unsharded ``fft_mag_cfar_chain`` on the same frames;
5. ``sharded-2d``: ``cfar_2d_halo_shard`` on the range-sharded magnitude map
   against the unsharded ``cfar_2d_op``.

Legs 2 and 3 are held against leg 1 at the JAX dry run's bar (max|dthr| /
max|thr| < 1e-3, at most max(1, cells / 1000) flipped peaks); legs 4 and 5
against their unsharded ops at 1e-4 relative with equal peaks. A leg that
misses its bar raises.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..configs import (
    CfarConfig, CfarVariant, ChainConfig, DopplerConfig, FftConfig,
    MatchedFilterConfig, RuntimeConfig,
)
from ..cplx import as_pair
from ..golden import lfm_chirp
from ..ops.cfar_2d import Cfar2dConfig, Cfar2dRuntime, cfar_2d_op
from ..ops.doppler import doppler_fft
from ..ops.logmag import logmag
from ..ops.matched_filter import matched_filter
from .mesh import make_mesh
from .sharded import (
    cfar_2d_halo_shard, gather, make_sharded_pipeline,
    make_sharded_rd_pipeline, range_sharded_mag_cfar, scatter,
)


def _rel_flips(got, want) -> tuple[float, int]:
    scale = max(want.threshold.abs().max().item(), 1e-30)
    rel = (got.threshold - want.threshold).abs().max().item() / scale
    return rel, int((got.peaks != want.peaks).sum().item())


def dryrun_multichip(devices: Sequence, num_pulses: int = 64,
                     n_range: int = 1024, seed: int = 0) -> dict:
    """Run the five legs on a mesh over ``devices`` and cross-check them;
    returns ``{leg: (rel dthr, peak flips)}`` against each leg's
    reference."""
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    ch, rng = (n // 2, 2) if n >= 2 and n % 2 == 0 else (n, 1)
    mesh = make_mesh(ch, rng, devices)
    dev = devices[0]
    chirp = lfm_chirp(128, 0.0, 0.25)

    def config(use_pallas: bool, use_rdma: bool) -> ChainConfig:
        return ChainConfig(
            fft=FftConfig(max_size=n_range),
            matched_filter=MatchedFilterConfig(num_taps=128,
                                               fft_size=n_range),
            doppler=DopplerConfig(num_pulses=num_pulses),
            cfar=CfarConfig(max_ref_window=32, max_guard_window=8,
                            variant=CfarVariant.GOSCA, include_cash=True,
                            max_fft_size=n_range, use_pallas=use_pallas,
                            use_rdma_halo=use_rdma))

    rt = RuntimeConfig.make(fft_size=n_range, ref_window_size=32,
                            guard_window_size=4, threshold_scaler=5.0,
                            index_lagg=24, index_lead=24)
    r = np.random.RandomState(seed)
    x_np = (r.randn(ch, num_pulses, n_range)
            + 1j * r.randn(ch, num_pulses, n_range)).astype(np.complex64)
    x = as_pair(x_np, device=dev)

    outs = {name: make_sharded_rd_pipeline(config(up, False), mesh, chirp)(
        x, rt) for name, up in (("plain", False), ("fused", True))}
    cfg_rdma = config(True, True)
    rng_mesh = make_mesh(1, max(2, min(rng, n)), devices)
    rd_map = doppler_fft(matched_filter(x, chirp, cfg_rdma.matched_filter),
                         cfg_rdma.doppler)
    outs["rdma-halo"] = range_sharded_mag_cfar(cfg_rdma, rng_mesh)(rd_map, rt)
    for name, out in outs.items():
        if tuple(out.peaks.shape) != x_np.shape:
            raise AssertionError(f"{name}: peaks {tuple(out.peaks.shape)}")

    report = {}
    cells = x_np.size
    for name in ("fused", "rdma-halo"):
        rel, flips = _rel_flips(outs[name], outs["plain"])
        report[name] = (rel, flips)
        if not (rel < 1e-3 and flips <= max(1, cells // 1000)):
            raise AssertionError(f"dry run leg {name}: rel dthr {rel:.3e}, "
                                 f"{flips} flips against the plain leg")

    # leg 4: the sharded 1-D chain against the unsharded chain
    from ..presets import fft_mag_cfar_chain

    cfg1d = ChainConfig(
        fft=FftConfig(max_size=n_range),
        cfar=CfarConfig(max_ref_window=32, max_guard_window=8,
                        variant=CfarVariant.CA, include_cash=False,
                        max_fft_size=n_range, use_pallas=False))
    frames = as_pair(x_np[:, 0, :], device=dev)
    out4 = make_sharded_pipeline(cfg1d, mesh)(frames, rt)
    ref4 = fft_mag_cfar_chain(cfg1d, device=dev)(frames, rt)

    # leg 5: the range-sharded 2-D detector against the unsharded 2-D op
    cfg2d = Cfar2dConfig(max_ref_range=16, max_guard_range=4,
                         max_ref_doppler=8, max_guard_doppler=2)
    rt2d = Cfar2dRuntime.make(ref_range=8, guard_range=2, ref_doppler=4,
                              guard_doppler=1, threshold_scaler=6.0,
                              active_range=n_range, validate_against=cfg2d)
    mag_map = logmag(rd_map, rt.mag_mode)
    out5 = gather([cfar_2d_halo_shard(row, rt2d, cfg2d) for row in
                   scatter(mag_map, mesh, channels=True, ranges=True)])
    ref5 = cfar_2d_op(mag_map, rt2d, cfg2d)
    for name, got, want in (("sharded-1d", out4, ref4),
                            ("sharded-2d", out5, ref5)):
        rel, flips = _rel_flips(got, want)
        report[name] = (rel, flips)
        if not (rel < 1e-4 and flips == 0):
            raise AssertionError(f"dry run leg {name}: rel dthr {rel:.3e}, "
                                 f"{flips} flips against the unsharded op")
    return report
