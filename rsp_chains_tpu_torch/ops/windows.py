"""Window functions for FFT pre-weighting (host-side numpy constants), the same
functions as ``rsp_chains_tpu.ops.windows``."""

from __future__ import annotations

import numpy as np


def window(name: str | None, n: int, dtype=np.float32) -> np.ndarray:
    """An n-point window by name."""
    if name is None or name == "rect":
        return np.ones(n, dtype)
    i = np.arange(n, dtype=np.float64)
    if name == "hann":
        w = 0.5 - 0.5 * np.cos(2 * np.pi * i / n)
    elif name == "hamming":
        w = 0.54 - 0.46 * np.cos(2 * np.pi * i / n)
    elif name == "blackman":
        w = (0.42 - 0.5 * np.cos(2 * np.pi * i / n)
             + 0.08 * np.cos(4 * np.pi * i / n))
    elif name == "taylor":
        w = _taylor(n)
    else:
        raise ValueError(f"unknown window {name!r}")
    return w.astype(dtype)


def _taylor(n: int, nbar: int = 4, sll_db: float = 30.0) -> np.ndarray:
    """Taylor window."""
    a = np.arccosh(10 ** (sll_db / 20.0)) / np.pi
    sigma2 = nbar**2 / (a**2 + (nbar - 0.5) ** 2)
    m = np.arange(1, nbar)
    fm = np.empty(nbar - 1)
    for mi, mm in enumerate(m):
        num = np.prod(1 - (mm**2 / sigma2) / (a**2 + (m - 0.5) ** 2))
        den = np.prod([1 - mm**2 / k**2 for k in m if k != mm])
        fm[mi] = ((-1) ** (mm + 1)) * num / (2 * den)
    i = np.arange(n)
    w = np.ones(n)
    for mi, mm in enumerate(m):
        w += 2 * fm[mi] * np.cos(2 * np.pi * mm * (i - (n - 1) / 2.0) / n)
    return w
