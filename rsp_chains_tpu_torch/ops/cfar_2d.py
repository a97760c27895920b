"""2-D (range x Doppler) CFAR over range-Doppler maps, the port of
``rsp_chains_tpu.ops.cfar_2d``.

For each cell under test (d, r) the noise is taken over the training band
between two centred rectangles, the outer of half-extents ``guard + ref`` and
the inner of half-extents ``guard`` per axis. Edges are PARTIAL: cells outside
the map or the active range count for nothing, and the CA divisor is the true
number of training cells. The ordered-statistic body (``include_os``) takes
the ``os_rank``-th smallest training cell instead.

``cfar_2d_op`` is the plain version: the same centred box sums as the JAX
package (a dyadic ladder of rolls, recentred), and for OS one stack of the
map's shifted copies at a time, sorted along the stack, so memory stays
bounded by one map. ``rd_2d_cfar_chain`` routes a fusable elaboration to the
whole-chain kernel ``kernels.rd.fused_rd_2d_chain``.

The registers are host values (``Cfar2dRuntime``), clamped to the elaborated
maxima where they are read.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..chain import _host_to_device
from ..configs import ChainConfig, DopplerConfig
from ..cplx import as_pair
from ..golden.fixtures import lfm_chirp
from .cfar import CfarOutput
from .logmag import logmag


@dataclass(frozen=True)
class Cfar2dConfig:
    """Elaboration maxima of the 2-D detector, per axis. ``include_os``
    elaborates the ordered-statistic body, which the ``algorithm`` register
    then selects."""

    max_ref_range: int = 16
    max_guard_range: int = 4
    max_ref_doppler: int = 8
    max_guard_doppler: int = 2
    include_os: bool = False

    @property
    def os_stack(self) -> int:
        """Every offset of the outer rectangle but the cell under test."""
        return ((2 * (self.max_ref_doppler + self.max_guard_doppler) + 1)
                * (2 * (self.max_ref_range + self.max_guard_range) + 1) - 1)

    def __post_init__(self):
        if self.max_ref_range < 1 or self.max_ref_doppler < 1:
            raise ValueError("reference maxima must be >= 1")
        if self.max_guard_range < 0 or self.max_guard_doppler < 0:
            raise ValueError("guard maxima must be >= 0")
        if self.include_os and self.os_stack > 256:
            raise ValueError(
                f"include_os with annulus stack {self.os_stack} > 256: "
                "elaborate smaller per-axis maxima for ordered-statistic "
                "detection")


@dataclass
class Cfar2dRuntime:
    """The 2-D detector's registers as host values."""

    ref_range: int
    guard_range: int
    ref_doppler: int
    guard_doppler: int
    threshold_scaler: float
    log_or_linear: int    # 1 multiplies, else adds (log domain)
    peak_grouping: int    # 1 keeps 8-neighbour local maxima
    active_range: int     # valid range cells [0, active_range)
    algorithm: int        # 0 CA, 1 OS (needs include_os)
    os_rank: int          # 0-based rank among the valid training cells

    @staticmethod
    def make(*, ref_range: int, guard_range: int, ref_doppler: int,
             guard_doppler: int, threshold_scaler: float,
             log_or_linear: int = 1, peak_grouping: int = 0,
             active_range: int = 1 << 30, algorithm: int = 0,
             os_rank: int = 0,
             validate_against: Optional[Cfar2dConfig] = None
             ) -> "Cfar2dRuntime":
        """The JAX package's rules (``ops/cfar_2d.py:96-131``); the scaler is
        rounded to float32 as it stores it."""
        if ref_range < 1 or ref_doppler < 1:
            raise ValueError("reference extents must be >= 1")
        if guard_range < 0 or guard_doppler < 0:
            raise ValueError("guard extents must be >= 0")
        if algorithm not in (0, 1):
            raise ValueError("algorithm must be 0 (CA) or 1 (OS)")
        if os_rank < 0:
            raise ValueError("os_rank must be >= 0")
        if validate_against is not None:
            c = validate_against
            if (ref_range > c.max_ref_range or guard_range > c.max_guard_range
                    or ref_doppler > c.max_ref_doppler
                    or guard_doppler > c.max_guard_doppler):
                raise ValueError("2-D window exceeds elaborated maxima")
            if algorithm == 1 and not c.include_os:
                raise ValueError(
                    "algorithm=OS requires an include_os=True elaboration")
            if algorithm == 1 and os_rank >= c.os_stack:
                raise ValueError("os_rank exceeds the elaborated annulus")
        return Cfar2dRuntime(
            ref_range=int(ref_range), guard_range=int(guard_range),
            ref_doppler=int(ref_doppler), guard_doppler=int(guard_doppler),
            threshold_scaler=float(np.float32(threshold_scaler)),
            log_or_linear=int(log_or_linear), peak_grouping=int(peak_grouping),
            active_range=int(active_range), algorithm=int(algorithm),
            os_rank=int(os_rank))


def window_extents(rt2: Cfar2dRuntime,
                   cfg: Cfar2dConfig) -> tuple[int, int, int, int]:
    """(w_r, g_r, w_d, g_d) clamped to the elaborated maxima, as the JAX
    package clamps them (a raw register write bypasses ``make()``)."""
    def clamp(v, lo, hi):
        return min(max(int(v), lo), hi)

    return (clamp(rt2.ref_range, 1, cfg.max_ref_range),
            clamp(rt2.guard_range, 0, cfg.max_guard_range),
            clamp(rt2.ref_doppler, 1, cfg.max_ref_doppler),
            clamp(rt2.guard_doppler, 0, cfg.max_guard_doppler))


def _centered_box(x: torch.Tensor, half: int, dim: int,
                  max_half: int) -> torch.Tensor:
    """The sum over offsets [-half, +half] along ``dim``: a right-aligned
    sliding sum composed from dyadic blocks by the bits of 2*half + 1, then
    recentred, the JAX package's additions in its order. The caller pads
    ``dim`` with more than 2*max_half + 1 zeros on each side."""
    w = 2 * half + 1
    acc = torch.zeros_like(x)
    blk = x
    n_bits = max(int(np.ceil(np.log2(2 * max_half + 2))), 1)
    for b in range(n_bits):
        if (w >> b) & 1:
            acc = blk + torch.roll(acc, 1 << b, dims=dim)
        if b < n_bits - 1:
            blk = blk + torch.roll(blk, 1 << b, dims=dim)
    for b in range(max(int(max_half).bit_length(), 1)):
        if (half >> b) & 1:
            acc = torch.roll(acc, -(1 << b), dims=dim)
    return acc


def _os_noise(mp: torch.Tensor, vp: torch.Tensor, sl, ext, cfg: Cfar2dConfig,
              rank: int) -> torch.Tensor:
    """The ``min(rank, nv - 1)``-th smallest valid training cell of each cell
    of one padded map ``mp`` [Pp, Np] (validity ``vp``), 0 where there is
    none. Offsets outside the runtime annulus contribute only +inf, which
    sorts last, so only the annulus is stacked."""
    w_r, g_r, w_d, g_d = ext
    a_r, a_d = g_r + w_r, g_d + w_d
    rows, nv = [], 0
    for dd in range(-a_d, a_d + 1):
        for dr in range(-a_r, a_r + 1):
            if abs(dd) <= g_d and abs(dr) <= g_r:
                continue
            v = torch.roll(mp, (-dd, -dr), dims=(-2, -1))[sl]
            ok = torch.roll(vp, (-dd, -dr), dims=(-2, -1))[sl] > 0.5
            rows.append(torch.where(ok, v, math.inf))
            nv = nv + ok.to(torch.int64)
    s = torch.sort(torch.stack(rows), dim=0).values
    idx = torch.clamp(torch.clamp(nv - 1, max=int(rank)), 0, cfg.os_stack - 1)
    idx = torch.clamp(idx, max=s.shape[0] - 1)
    got = s.gather(0, idx[None])[0]
    return torch.where(nv > 0, got, 0.0)


def cfar_2d_op(mag: torch.Tensor, rt2: Cfar2dRuntime,
               cfg: Cfar2dConfig = Cfar2dConfig(), *,
               active_lo: Optional[int] = None,
               active_hi: Optional[int] = None) -> CfarOutput:
    """2-D CFAR over the trailing [P, N] (Doppler, range) axes of ``mag``
    (float32). The valid range cells are [``active_lo``, ``active_hi``),
    by default [0, ``rt2.active_range``); Doppler spans the map."""
    mag = mag.float()
    p, n = mag.shape[-2], mag.shape[-1]
    pad_d = 2 * (cfg.max_ref_doppler + cfg.max_guard_doppler) + 2
    pad_r = 2 * (cfg.max_ref_range + cfg.max_guard_range) + 2
    lo = 0 if active_lo is None else int(active_lo)
    hi = int(rt2.active_range) if active_hi is None else int(active_hi)
    cell = torch.arange(n, device=mag.device)
    active = ((cell >= lo) & (cell < hi)).expand(mag.shape)
    m = torch.where(active, mag, 0.0)
    pads = (pad_r, pad_r, pad_d, pad_d)
    mp = F.pad(m, pads)
    vp = F.pad(active.float(), pads)
    ext = window_extents(rt2, cfg)
    w_r, g_r, w_d, g_d = ext
    a_d, a_r = g_d + w_d, g_r + w_r
    max_ad = cfg.max_guard_doppler + cfg.max_ref_doppler
    max_ar = cfg.max_guard_range + cfg.max_ref_range
    sl = (..., slice(pad_d, pad_d + p), slice(pad_r, pad_r + n))

    if cfg.include_os and int(rt2.algorithm) == 1:
        lead = mp.shape[:-2]
        mp_f = mp.reshape((-1,) + mp.shape[-2:])
        vp_f = vp.reshape((-1,) + vp.shape[-2:])
        noise = torch.stack([
            _os_noise(mp_f[i], vp_f[i], sl, ext, cfg, rt2.os_rank)
            for i in range(mp_f.shape[0])]).reshape(lead + (p, n))
    else:
        def box2(x, hd, hr, mhd, mhr):
            return _centered_box(_centered_box(x, hd, -2, mhd), hr, -1, mhr)

        outer = box2(mp, a_d, a_r, max_ad, max_ar)
        inner = box2(mp, g_d, g_r, cfg.max_guard_doppler, cfg.max_guard_range)
        c_out = box2(vp, a_d, a_r, max_ad, max_ar)
        c_in = box2(vp, g_d, g_r, cfg.max_guard_doppler, cfg.max_guard_range)
        noise = (outer - inner)[sl] / torch.clamp((c_out - c_in)[sl], min=1.0)

    if int(rt2.log_or_linear) == 1:
        thr = noise * rt2.threshold_scaler
    else:
        thr = noise + rt2.threshold_scaler
    thr = torch.where(active, thr, 0.0)
    peaks = (m > thr) & active
    if int(rt2.peak_grouping) == 1:
        # 8-neighbour local maxima; a neighbour outside the frame is -inf
        mrow = F.pad(torch.where(active, m, -math.inf), pads, value=-math.inf)
        for dd in (-1, 0, 1):
            for dr in (-1, 0, 1):
                if dd or dr:
                    nb = torch.roll(mrow, (dd, dr), dims=(-2, -1))[sl]
                    peaks = peaks & (m >= nb)
    return CfarOutput(threshold=thr, peaks=peaks)


def rd_2d_cfar_chain(cfg: Optional[ChainConfig] = None, taps=None,
                     cfg2d: Cfar2dConfig = Cfar2dConfig(), device=None):
    """The range-Doppler chain with the 2-D map detector: matched filter ->
    Doppler -> magnitude -> 2-D CFAR. Returns ``run(x, rt, rt2) ->
    CfarOutput`` (not a ``Chain``: the detector has its own register
    record), with the JAX package's routing (``ops/cfar_2d.py:316-382``):

    * a fusable CA elaboration (``fully_fusable``) runs the whole CPI in
      ``kernels.rd.fused_rd_2d_chain`` (Kernel J);
    * another ``rd_fusable`` elaboration runs ``fused_rd_chain(emit='map')``
      (Kernel H), the magnitude and ``cfar_2d_op``;
    * the rest runs the matched-filter and Doppler stages, the magnitude and
      ``cfar_2d_op``.

    Numpy input goes to ``device``, CUDA unless ``device="cpu"``."""
    # kernels.rd and presets import this module
    from ..kernels.cfar import PAD
    from ..kernels.rd import fused_rd_2d_chain, fused_rd_chain, rd_fusable
    from ..presets import doppler_stage, matched_filter_stage

    cfg = cfg or ChainConfig(doppler=DopplerConfig())
    dev = torch.device(device if device is not None else "cuda")
    if cfg.matched_filter is None:
        if taps is not None:
            raise ValueError(
                "taps given but cfg.matched_filter is None: elaborate a "
                "MatchedFilterConfig for the filter stage to exist")
        taps_np, mf = None, None
        fusable = fully_fusable = False
    else:
        if taps is None:
            taps = lfm_chirp(cfg.matched_filter.num_taps)
        taps_np = np.asarray(taps)
        fusable = rd_fusable(cfg, taps_np) and cfg.cfar.use_pallas
        fully_fusable = (
            fusable
            and 2 * (cfg2d.max_ref_range + cfg2d.max_guard_range) + 2 <= PAD
            and not cfg.mag.use_lut_log and not cfg.fixed_point.enabled
            and not cfg2d.include_os)
        mf = matched_filter_stage(cfg, taps_np)
    dop = doppler_stage(cfg)

    def run(x, rt, rt2: Cfar2dRuntime) -> CfarOutput:
        xp = as_pair(_host_to_device(x, dev))
        if fully_fusable:
            return fused_rd_2d_chain(xp, rt, rt2, taps_np, cfg, cfg2d)
        if fusable:
            y = fused_rd_chain(xp, rt, taps_np, cfg, emit="map")
        else:
            y = dop.fn(mf.fn(xp, rt) if mf is not None else xp, rt)
        return cfar_2d_op(logmag(y, rt.mag_mode, cfg.mag), rt2, cfg2d)

    run.fully_fusable = fully_fusable
    run.fusable = fusable
    return run
