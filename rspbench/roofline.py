"""The least time a CPI's work can take on one NVIDIA H100.

A configuration's chain file (``rspbench/chains/<chain>.py``, found by
``cells.chain``) counts the bytes and operations of one CPI from its shapes,
whatever kernels implement the chain; ``cpi_work`` is the one entry point.
This module keeps the card's peaks, so that no later change to the program
moves the yardstick: the least time is the larger of bytes over the memory
bandwidth and operations over the peak rate. Peaks are NVIDIA's data sheet
figures for the SXM part at its 700 W limit; ``power_limit_w`` reads the
card's own limit, which is reported beside every share of these peaks.
"""

from __future__ import annotations

import subprocess
from typing import Optional

from . import cells

HBM_BYTES_PER_S = 3.35e12
FP32_PER_S = 67e12
INT32_PER_S = 33.5e12


def cpi_work(config: dict, root=cells.REPO) -> dict:
    """Bytes, operations and the least seconds of one CPI of ``config``, as
    its chain file's ``work`` counts them: the keys of ``least``."""
    return cells.chain(config, root).work(config)


def least(samples: int, nbytes: float, ops: float, peak: float) -> dict:
    """The work of a CPI of ``samples`` samples that moves ``nbytes`` and
    computes ``ops`` operations at ``peak`` a second: ``samples``,
    ``bytes``, ``ops``, the times ``bytes_s`` and ``ops_s``, the larger of
    them ``least_s``, and ``bound_by``, which of the two it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return {"samples": samples, "bytes": nbytes, "ops": ops,
            "bytes_s": t_bytes, "ops_s": t_ops,
            "least_s": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def power_limit_w() -> Optional[float]:
    """The card's power limit in watts from ``nvidia-smi``, or None where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
