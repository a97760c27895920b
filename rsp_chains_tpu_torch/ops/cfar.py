"""CFAR, the port of ``rsp_chains_tpu.ops.cfar.cfar_op``: the CA family (cell
averaging, greatest-of, smallest-of), order statistics (GOS), their
runtime-switched union (GOSCA) and CASH, under the PARTIAL, WRAP and REFLECT
edge policies.

* CA window sums under PARTIAL edges are dyadic box sums over a zero-padded
  row, the same additions in the same order as the JAX package's gather-free
  path (``_ca_sums_roll``): ``S_{k+1}[j] = S_k[j] + S_k[j - 2^k]``. Cells
  outside ``[active_lo, active_hi)`` count as zero and the divider stays
  ``2^divSum``.
* GOS and CASH statistics, and CA sums under WRAP / REFLECT, come from each
  cell's reference windows gathered into ``[..., N, Wmax]`` tensors (the JAX
  package's gather form, ``_gather_windows`` / ``_gos_stats`` /
  ``_cash_stat``; its roll forms exist only because of Mosaic).

The registers are host values, so only the statistic they select is computed;
the JAX package traces every elaborated datapath and selects afterwards. The
result is the same.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..configs import CfarConfig, CfarVariant, EdgePolicy, RuntimeConfig


class CfarOutput(NamedTuple):
    """Per-bin CFAR result. ``noise`` / ``cut`` are None unless elaborated
    (``CfarConfig.emit_noise`` / ``send_cut``). ``detections`` is the number
    of peaks where the kernel that made the output counted them (Kernels D
    and G), else None: an output built anew (a concatenation, a slice, an
    integration) sets none."""

    threshold: torch.Tensor               # float32 [..., N]
    peaks: torch.Tensor                   # bool    [..., N]
    noise: Optional[torch.Tensor] = None  # float32 [..., N]
    cut: Optional[torch.Tensor] = None    # float32 [..., N]
    detections: Optional[torch.Tensor] = None  # int64 [], on the device


def window_registers(rt: RuntimeConfig, cfg: CfarConfig) -> tuple[int, int]:
    """(log2 of the reference window, guard) clamped to the elaborated maxima,
    as the JAX package clamps them before its kernels
    (``chain_pallas._chain_scalars``)."""
    w = min(max(int(rt.ref_window_size), 1), cfg.max_ref_window)
    log2w = int(round(math.log2(w)))
    guard = min(max(int(rt.guard_window_size), 0), cfg.max_guard_window)
    return log2w, guard


def effective_mode(rt: RuntimeConfig, cfg: CfarConfig) -> int:
    """The mode register clipped to 0..3 (CA, GO, SO, CASH); CASH degrades to
    CA where it is not elaborated."""
    mode = min(max(int(rt.cfar_mode), 0), 3)
    return 0 if mode == 3 and not cfg.include_cash else mode


def effective_algorithm(rt: RuntimeConfig, cfg: CfarConfig) -> int:
    """1 where the side statistics are order statistics, else 0 (CA sums).
    Only a GOSCA elaboration reads the algorithm register; a pure-GOS
    elaboration has no CA datapath and a CA elaboration no GOS one."""
    if cfg.variant is CfarVariant.GOSCA:
        return 1 if int(rt.cfar_algorithm) == 1 else 0
    return 1 if cfg.variant is CfarVariant.GOS else 0


def ca_window_sums(mag: torch.Tensor, lo: int, hi: int, guard: int,
                   log2w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """lag(i) = sum mag[i-g-w .. i-g-1], lead(i) = sum mag[i+g+1 .. i+g+w],
    with cells outside [lo, hi) counted as zero. In the dtype of ``mag``; an
    int32 ``mag`` sums with int32 wraparound, as XLA's int32 does."""
    n = mag.shape[-1]
    w = 1 << log2w
    pad = guard + w + 1
    cell = torch.arange(n, device=mag.device)
    row = F.pad(torch.where((cell >= lo) & (cell < hi), mag, 0), (pad, pad))
    for k in range(log2w):
        s = 1 << k
        row = row + F.pad(row[..., :-s], (s, 0))
    # row[j] = sum of the masked magnitude over [j - w + 1, j] (padded index)
    lag = row[..., pad - guard - 1: pad - guard - 1 + n]
    lead = row[..., pad + guard + w: pad + guard + w + n]
    return lag, lead


def gather_windows(mag: torch.Tensor, lo: int, hi: int, guard: int, w: int,
                   cfg: CfarConfig):
    """Each cell's lag / lead reference windows as ``[..., N, Wmax]`` tensors
    with ``[N, Wmax]`` validity masks: lag cells i-g-w .. i-g-1, lead cells
    i+g+1 .. i+g+w. PARTIAL marks cells outside [lo, hi) invalid; WRAP takes
    positions modulo the active cell count and REFLECT mirrors them, and then
    every in-window cell is valid."""
    n = mag.shape[-1]
    i = torch.arange(n, device=mag.device)[:, None]
    k = torch.arange(cfg.max_ref_window, device=mag.device)[None, :]
    lag_pos = i - guard - w + k
    lead_pos = i + guard + 1 + k
    if cfg.edge_policy is EdgePolicy.PARTIAL:
        lag_valid = (k < w) & (lag_pos >= lo) & (lag_pos < hi)
        lead_valid = (k < w) & (lead_pos >= lo) & (lead_pos < hi)
    else:
        n_act = max(hi - lo, 1)
        if cfg.edge_policy is EdgePolicy.WRAP:
            def fold(pos):
                return lo + torch.remainder(pos - lo, n_act)
        else:
            period = max(2 * n_act - 2, 1)

            def fold(pos):
                m = torch.remainder(pos - lo, period)
                return lo + torch.where(m < n_act, m, period - m)
        lag_pos, lead_pos = fold(lag_pos), fold(lead_pos)
        lag_valid = lead_valid = (k < w).expand(n, -1)

    def take(pos):
        return mag[..., pos.clamp(0, n - 1)]

    return take(lag_pos), lag_valid, take(lead_pos), lead_valid


def gos_stat(win: torch.Tensor, valid: torch.Tensor, rank: int) -> torch.Tensor:
    """The ``min(rank, nv - 1)``-th smallest valid cell of each window, nv its
    valid count; 0 where nv is 0. Invalid cells sort as +inf."""
    s = torch.sort(torch.where(valid, win, math.inf), dim=-1).values
    nv = valid.sum(-1)
    idx = torch.minimum(torch.full_like(nv, int(rank)), nv - 1).clamp(
        0, s.shape[-1] - 1)
    got = s.gather(-1, idx.expand(s.shape[:-1])[..., None])[..., 0]
    return torch.where(nv > 0, got, 0.0)


def cash_stat(win: torch.Tensor, valid: torch.Tensor, sub_w: int) -> torch.Tensor:
    """The least mean of ``sub_w`` consecutive cells that are all valid, over
    each window; 0 where no such sub-window fits."""
    wmax = win.shape[-1]
    c = F.pad(torch.cumsum(torch.where(valid, win, 0.0), -1), (1, 0))
    cv = F.pad(torch.cumsum(valid.int(), -1), (1, 0))
    t = torch.arange(wmax, device=win.device)
    end = (t + sub_w).clamp(0, wmax)
    sub_sum = c[..., end] - c[..., t]
    ok = (cv[..., end] - cv[..., t] == sub_w) & (t + sub_w <= wmax)
    est = torch.where(ok, sub_sum / max(sub_w, 1), math.inf).min(-1).values
    return torch.where(torch.isfinite(est), est, 0.0)


def combine(mode: int, lag: torch.Tensor, lead: torch.Tensor) -> torch.Tensor:
    """The noise of two side statistics: 1 GO (max), 2 SO (min), else CA
    (mean)."""
    if mode == 1:
        return torch.maximum(lag, lead)
    if mode == 2:
        return torch.minimum(lag, lead)
    return 0.5 * (lag + lead)


def cfar_op(mag: torch.Tensor, rt: RuntimeConfig, cfg: CfarConfig = CfarConfig(),
            *, active_lo: Optional[int] = None,
            active_hi: Optional[int] = None) -> CfarOutput:
    """CFAR over the last axis of ``mag`` (float32 [..., N]). ``active_lo`` /
    ``active_hi`` bound the valid cells; they default to [0, cfar fftSize)."""
    mag = mag.float()
    n = mag.shape[-1]
    lo = 0 if active_lo is None else int(active_lo)
    hi = min(int(rt.cfar_fft_size), n) if active_hi is None else int(active_hi)
    log2w, guard = window_registers(rt, cfg)
    mode = effective_mode(rt, cfg)

    def windows():
        return gather_windows(mag, lo, hi, guard, 1 << log2w, cfg)

    if mode == 3:  # CASH: the greater side of the least sub-window means
        sw = min(max(int(rt.sub_window_size), cfg.min_sub_window),
                 cfg.max_ref_window)
        lag_win, lag_valid, lead_win, lead_valid = windows()
        noise = torch.maximum(cash_stat(lag_win, lag_valid, sw),
                              cash_stat(lead_win, lead_valid, sw))
    elif effective_algorithm(rt, cfg) == 1:
        lag_win, lag_valid, lead_win, lead_valid = windows()
        noise = combine(mode, gos_stat(lag_win, lag_valid, rt.index_lagg),
                        gos_stat(lead_win, lead_valid, rt.index_lead))
    else:
        if cfg.edge_policy is EdgePolicy.PARTIAL:
            lag, lead = ca_window_sums(mag, lo, hi, guard, log2w)
        else:  # circular windows: sum the folded windows directly
            lag_win, lag_valid, lead_win, lead_valid = windows()
            lag = torch.where(lag_valid, lag_win, 0.0).sum(-1)
            lead = torch.where(lead_valid, lead_win, 0.0).sum(-1)
        inv_div = 2.0 ** -int(rt.div_sum)
        noise = combine(mode, lag * inv_div, lead * inv_div)
    if int(rt.log_or_linear) == 1:
        threshold = noise * rt.threshold_scaler
    else:  # log domain: the scaler adds
        threshold = noise + rt.threshold_scaler

    cell = torch.arange(n, device=mag.device)
    active = (cell >= lo) & (cell < hi)
    threshold = torch.where(active, threshold, 0.0)
    peaks = (mag > threshold) & active
    if int(rt.peak_grouping) == 1:
        # local maxima only; a neighbour outside the active range is -inf
        ninf = torch.full_like(mag[..., :1], -math.inf)
        left = torch.cat([ninf, mag[..., :-1]], dim=-1)
        right = torch.cat([mag[..., 1:], ninf], dim=-1)
        left = torch.where(cell - 1 >= lo, left, -math.inf)
        right = torch.where(cell + 1 < hi, right, -math.inf)
        peaks = peaks & (mag >= left) & (mag >= right)
    return CfarOutput(
        threshold=threshold,
        peaks=peaks,
        noise=noise if cfg.emit_noise else None,
        cut=mag if cfg.send_cut else None,
    )
