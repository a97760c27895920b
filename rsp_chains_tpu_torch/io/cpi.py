"""CPI assembly (slow-time corner turn) and checkpoint/resume, the port of
``rsp_chains_tpu.io.cpi``.

The reference is (almost) stateless per frame — its only state is the register
file (SURVEY §5.4). The 2-D range-Doppler extension adds exactly one piece of
cross-frame state: the pulse buffer accumulating a CPI. ``CpiBuffer`` is that
buffer, a host array as in the JAX package; ``save_state``/``load_state``
checkpoint it together with the runtime register file, which is the complete
restartable state of a streaming deployment.

A checkpoint is the JAX package's ``.npz``: the registers under ``rt_<field>``
with its dtypes (int32 for the integer registers, float32 for
``threshold_scaler``, ``phase_offset`` and the PLFG profile), the buffer under
``cpi_buf``, ``cpi_count`` and ``cpi_pulses_seen``, a caller's extras under
``x_<name>``. A file written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..configs import RuntimeConfig

# the registers the JAX package stores as float32; the rest are int32
FLOAT_REGS = ("threshold_scaler", "phase_offset")


class CpiBuffer:
    """Accumulates per-pulse range lines into [pulses, n_range] CPI blocks.

    The hardware analog is the corner-turn memory between range and Doppler
    processing. ``push`` returns a completed CPI (and resets) every
    ``num_pulses`` pulses. Supports overlapped CPIs via ``hop`` < num_pulses
    (sliding-window Doppler processing)."""

    def __init__(self, num_pulses: int, n_range: int, channels: int = 1,
                 hop: Optional[int] = None, dtype=np.complex64):
        self.num_pulses = num_pulses
        self.hop = hop or num_pulses
        if not (0 < self.hop <= num_pulses):
            raise ValueError("hop must be in (0, num_pulses]")
        self._buf = np.zeros((channels, num_pulses, n_range), dtype)
        self._count = 0
        self.pulses_seen = 0

    def push(self, pulse: np.ndarray) -> Optional[np.ndarray]:
        """Add one pulse ([channels, n_range] or [n_range]); returns a full CPI
        copy when ready, else None."""
        if pulse.ndim == 1:
            pulse = pulse[None]
        self._buf[:, self._count] = pulse
        self._count += 1
        self.pulses_seen += 1
        if self._count == self.num_pulses:
            cpi = self._buf.copy()
            keep = self.num_pulses - self.hop
            if keep:
                self._buf[:, :keep] = self._buf[:, self.hop:]
            self._count = keep
            return cpi
        return None

    # -- checkpoint ----------------------------------------------------------

    def state(self) -> dict:
        return {"buf": self._buf, "count": self._count,
                "pulses_seen": self.pulses_seen}

    def restore(self, state: dict) -> None:
        self._buf = np.array(state["buf"])
        self._count = int(state["count"])
        self.pulses_seen = int(state["pulses_seen"])


def _register_array(name: str, value) -> np.ndarray:
    """One register as the array the JAX package stores."""
    if name == "plfg_profile":
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        return np.asarray(value, np.float32)
    return np.asarray(value, np.float32 if name in FLOAT_REGS else np.int32)


def save_state(path: str | Path, rt: RuntimeConfig,
               cpi: Optional[CpiBuffer] = None, **extra) -> None:
    """Checkpoint the complete streaming state: the runtime register file plus
    (optionally) the CPI pulse buffer."""
    # optional array state (the PLFG profile RAM) is saved only when present
    arrs = {f"rt_{f.name}": _register_array(f.name, getattr(rt, f.name))
            for f in dataclasses.fields(rt)
            if getattr(rt, f.name) is not None}
    if cpi is not None:
        st = cpi.state()
        arrs["cpi_buf"] = st["buf"]
        arrs["cpi_count"] = np.asarray(st["count"])
        arrs["cpi_pulses_seen"] = np.asarray(st["pulses_seen"])
    arrs.update({f"x_{k}": np.asarray(v) for k, v in extra.items()})
    # np.savez appends '.npz' to suffix-less paths but np.load does not:
    # normalize here so save('/ckpt') / load('/ckpt') round-trips
    np.savez(_npz_path(path), **arrs)


def _npz_path(path: str | Path) -> Path:
    p = Path(path)
    return p if p.suffix == ".npz" else p.with_name(p.name + ".npz")


def load_state(path: str | Path, cpi: Optional[CpiBuffer] = None):
    """Restore a checkpoint: returns (RuntimeConfig, extras dict); restores the
    CPI buffer in place when given. The registers come back as the port's
    host values; a register the file lacks (written before it existed) takes
    its ``RuntimeConfig.make()`` default, and a missing PLFG profile stays
    None."""
    with np.load(_npz_path(path)) as z:
        defaults = RuntimeConfig.make()
        kw = {}
        for f in dataclasses.fields(RuntimeConfig):
            key = f"rt_{f.name}"
            if f.name == "plfg_profile":
                kw[f.name] = (np.asarray(z[key], np.float32) if key in z
                              else None)
            elif key not in z:
                kw[f.name] = getattr(defaults, f.name)
            elif f.name in FLOAT_REGS:
                kw[f.name] = float(np.float32(z[key]))
            else:
                kw[f.name] = int(z[key])
        rt = RuntimeConfig(**kw)
        if cpi is not None and "cpi_buf" in z:
            cpi.restore({"buf": z["cpi_buf"], "count": z["cpi_count"],
                         "pulses_seen": z["cpi_pulses_seen"]})
        extras = {k[2:]: z[k] for k in z.files if k.startswith("x_")}
    return rt, extras
