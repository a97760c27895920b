"""CA-family CFAR (cell averaging, greatest-of, smallest-of), the port of
``rsp_chains_tpu.ops.cfar.cfar_op`` for CA elaborations.

Window sums are dyadic box sums over a zero-padded row, the same additions in
the same order as the JAX package's gather-free path (``_ca_sums_roll``):
``S_{k+1}[j] = S_k[j] + S_k[j - 2^k]``. Cells outside ``[active_lo, active_hi)``
count as zero and the divider stays ``2^divSum`` (``EdgePolicy.PARTIAL``).

GOS, GOSCA, CASH and the WRAP/REFLECT edge policies are not ported yet and
raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..configs import CfarConfig, CfarVariant, EdgePolicy, RuntimeConfig

_TODO_GOS = "ROADMAP queue 1 item 4"


class CfarOutput(NamedTuple):
    """Per-bin CFAR result. ``noise`` / ``cut`` are None unless elaborated
    (``CfarConfig.emit_noise`` / ``send_cut``)."""

    threshold: torch.Tensor               # float32 [..., N]
    peaks: torch.Tensor                   # bool    [..., N]
    noise: Optional[torch.Tensor] = None  # float32 [..., N]
    cut: Optional[torch.Tensor] = None    # float32 [..., N]


def require_ca_family(cfg: CfarConfig) -> None:
    """Raise for the CFAR elaborations the port does not carry yet."""
    if cfg.variant is not CfarVariant.CA:
        raise NotImplementedError(
            f"CFAR variant {cfg.variant.value} (GOS statistics) is not ported "
            f"yet ({_TODO_GOS})")
    if cfg.include_cash:
        raise NotImplementedError(
            f"CASH CFAR (include_cash=True) is not ported yet ({_TODO_GOS})")
    if cfg.edge_policy is not EdgePolicy.PARTIAL:
        raise NotImplementedError(
            f"CFAR edge policy {cfg.edge_policy.value} is not ported yet "
            f"({_TODO_GOS})")


def window_registers(rt: RuntimeConfig, cfg: CfarConfig) -> tuple[int, int]:
    """(log2 of the reference window, guard) clamped to the elaborated maxima,
    as the JAX package clamps them before its kernels
    (``chain_pallas._chain_scalars``)."""
    w = min(max(int(rt.ref_window_size), 1), cfg.max_ref_window)
    log2w = int(round(math.log2(w)))
    guard = min(max(int(rt.guard_window_size), 0), cfg.max_guard_window)
    return log2w, guard


def ca_window_sums(mag: torch.Tensor, lo: int, hi: int, guard: int,
                   log2w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """lag(i) = sum mag[i-g-w .. i-g-1], lead(i) = sum mag[i+g+1 .. i+g+w],
    with cells outside [lo, hi) counted as zero."""
    n = mag.shape[-1]
    w = 1 << log2w
    pad = guard + w + 1
    cell = torch.arange(n, device=mag.device)
    row = F.pad(torch.where((cell >= lo) & (cell < hi), mag, 0.0), (pad, pad))
    for k in range(log2w):
        s = 1 << k
        row = row + F.pad(row[..., :-s], (s, 0))
    # row[j] = sum of the masked magnitude over [j - w + 1, j] (padded index)
    lag = row[..., pad - guard - 1: pad - guard - 1 + n]
    lead = row[..., pad + guard + w: pad + guard + w + n]
    return lag, lead


def cfar_op(mag: torch.Tensor, rt: RuntimeConfig, cfg: CfarConfig = CfarConfig(),
            *, active_lo: Optional[int] = None,
            active_hi: Optional[int] = None) -> CfarOutput:
    """CFAR over the last axis of ``mag`` (float32 [..., N]). ``active_lo`` /
    ``active_hi`` bound the valid cells; they default to [0, cfar fftSize)."""
    require_ca_family(cfg)
    mag = mag.float()
    n = mag.shape[-1]
    lo = 0 if active_lo is None else int(active_lo)
    hi = min(int(rt.cfar_fft_size), n) if active_hi is None else int(active_hi)
    log2w, guard = window_registers(rt, cfg)

    lag, lead = ca_window_sums(mag, lo, hi, guard, log2w)
    inv_div = 2.0 ** -int(rt.div_sum)
    s_lag, s_lead = lag * inv_div, lead * inv_div
    mode = min(max(int(rt.cfar_mode), 0), 3)
    if mode == 1:
        noise = torch.maximum(s_lag, s_lead)
    elif mode == 2:
        noise = torch.minimum(s_lag, s_lead)
    else:  # CA, and CASH degrades to CA where it is not elaborated
        noise = 0.5 * (s_lag + s_lead)
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
