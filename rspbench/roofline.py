"""The least time a CPI's work can take on one NVIDIA H100, from its shapes.

The arithmetic of the port's kernel table (``PERF.md`` section 6), kept here
so that no later change to the program moves the yardstick:

* bytes: each input byte read once and each output byte written once. The
  input is two 32-bit planes (float32, or the integer samples as int32), 8 B
  a sample; the output a 32-bit threshold and a one-byte peak flag, 5 B a
  sample: 13 B a sample whatever kernels implement the chain.
* operations: a float FFT's 5 N log2 N a frame at the float32 peak outside
  the tensor cores; the bit-true chain's butterflies, 8.5 log2 N a sample,
  at the int32 peak (half the float32 issue rate).

The least time is the larger of bytes over the memory bandwidth and
operations over the peak rate. Peaks are NVIDIA's data sheet figures for the
SXM part at its 700 W limit; ``power_limit_w`` reads the card's own limit,
which is reported beside every share of these peaks.
"""

from __future__ import annotations

import math
import subprocess
from typing import Optional

HBM_BYTES_PER_S = 3.35e12
FP32_PER_S = 67e12
INT32_PER_S = 33.5e12
IN_BYTES = 8
OUT_BYTES = 5


def cpi_work(config: dict) -> dict:
    """Bytes, operations and the least seconds of one CPI of ``config``."""
    cpi = config["cpi"]
    n = int(cpi["samples"])
    samples = int(cpi["channels"]) * int(cpi["pulses"]) * n
    frames = samples // n
    log2n = math.log2(n)
    nbytes = samples * (IN_BYTES + OUT_BYTES)
    if config["numeric_format"] == "bit_true_int16":
        ops, peak = 8.5 * log2n * samples, INT32_PER_S
    else:
        ops, peak = 5.0 * n * log2n * frames, FP32_PER_S
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
