"""Detection-list compaction, the port of ``rsp_chains_tpu.ops.detect``.

The reference streams one 32-bit ``{threshold|bin|peak}`` word per range cell
(``RspChainVanillaTester.scala:164-172``) because hardware streams are dense.
Where the device-to-host link is the scarce resource, the serving path can
emit a fixed-size top-K detection list instead: static shapes, tiny egress,
sorted by strength. ``max_detections`` is an elaboration choice; the count is
data-dependent and returned alongside.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .cfar import CfarOutput


class DetectionList(NamedTuple):
    """Top-K detections per frame (last axis compacted).

    ``bins``: int32 [..., K] cell indices, -1 past ``count``.
    ``values``: float32 [..., K] magnitude (CUT) of each detection.
    ``thresholds``: float32 [..., K] threshold at each detection.
    ``count``: int32 [...] number of valid detections (clipped at K).
    """

    bins: torch.Tensor
    values: torch.Tensor
    thresholds: torch.Tensor
    count: torch.Tensor


def compact_detections(mag: torch.Tensor, out: CfarOutput,
                       max_detections: int = 64) -> DetectionList:
    """Compact a dense CfarOutput into a strength-sorted top-K detection list.

    ``mag``: the magnitude the CFAR ran on (``out.cut`` when ``send_cut`` was
    elaborated). Detections are ranked by magnitude; non-detections rank below
    everything and yield ``bins == -1``. Equal magnitudes keep the lower
    cell first, as ``jax.lax.top_k`` orders them: a stable descending sort,
    where ``torch.topk`` promises no order among ties."""
    k = max_detections
    n = mag.shape[-1]
    if not 0 <= k <= n:
        raise ValueError(f"max_detections {k} outside [0, {n}]")
    score = torch.where(out.peaks, mag.to(torch.float32),
                        torch.tensor(-torch.inf, device=mag.device))
    vals, idx = torch.sort(score, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    valid = torch.isfinite(vals)
    thr = torch.gather(out.threshold.to(torch.float32), -1, idx)
    zero = torch.zeros((), dtype=torch.float32, device=mag.device)
    return DetectionList(
        bins=torch.where(valid, idx, -1).to(torch.int32),
        values=torch.where(valid, vals, zero),
        thresholds=torch.where(valid, thr, zero),
        count=out.peaks.sum(dim=-1).clamp(0, k).to(torch.int32),
    )
