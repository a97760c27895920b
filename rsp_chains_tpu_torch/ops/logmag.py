"""LogMagMux: the runtime-muxed magnitude, the port of
``rsp_chains_tpu.ops.logmag``. Modes (``configs.MagMode``): 0 abs, 1 squared,
2 JPL approximation, 3 log2(JPL); the register is clipped to 0..3."""

from __future__ import annotations

import torch

from ..configs import LogMagConfig
from ..cplx import as_pair


def jpl(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """JPL magnitude approximation max(u + v/8, 7u/8 + v/2), u = max(|re|,
    |im|), v = min (``RspChainTesterUtils.scala:120-127``)."""
    ar, ai = re.abs(), im.abs()
    u, v = torch.maximum(ar, ai), torch.minimum(ar, ai)
    return torch.maximum(u + v * 0.125, u * 0.875 + v * 0.5)


def logmag(x, mag_mode: int, cfg: LogMagConfig | None = None) -> torch.Tensor:
    """The ``mag_mode``-selected magnitude of ``x`` (pair or complex), float32
    of the same shape."""
    cfg = cfg or LogMagConfig()
    xp = as_pair(x)
    re, im = xp.re, xp.im
    mode = min(max(int(mag_mode), 0), 3)
    if mode == 0:
        return torch.sqrt(re * re + im * im)
    if mode == 1:
        return re * re + im * im
    if mode == 2:
        return jpl(re, im)
    lg = torch.log2(torch.clamp(jpl(re, im), min=1e-30))
    if not cfg.use_lut_log:
        return lg
    # LUT path: the fraction truncated to log2_lookup_width bits, then snapped
    # and clamped to the FixedPoint(data_width_log, bin_point_log) output proto
    q = 2.0 ** cfg.log2_lookup_width
    lg = torch.floor(lg * q) / q
    qo = 2.0 ** cfg.bin_point_log
    hi = (2.0 ** (cfg.data_width_log - 1) - 1) / qo
    lo = -(2.0 ** (cfg.data_width_log - 1)) / qo
    return torch.clamp(torch.floor(lg * qo) / qo, lo, hi)
