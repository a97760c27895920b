"""Carry the JAX package's state into the port.

The system has no weights: its whole state is the elaboration (``ChainConfig``,
with its ``MatchedFilterConfig`` and ``DopplerConfig``; ``Cfar2dConfig`` for
the 2-D detector) and the register files (``RuntimeConfig``,
``Cfar2dRuntime``). These functions build the port's
versions from the JAX package's objects by reading their fields, so this module
never imports jax; the caller that holds a JAX object has already imported it.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from . import configs
from .configs import ChainConfig, RuntimeConfig
from .ops.cfar_2d import Cfar2dConfig, Cfar2dRuntime


def _mirror(value, port_cls):
    kwargs = {}
    for f in dataclasses.fields(port_cls):
        v = getattr(value, f.name)
        if isinstance(v, enum.Enum):
            v = getattr(configs, type(v).__name__)(v.value)
        elif dataclasses.is_dataclass(v):
            v = _mirror(v, getattr(configs, type(v).__name__))
        kwargs[f.name] = v
    return port_cls(**kwargs)


def chain_config_from_reference(cfg) -> ChainConfig:
    """The port's ``ChainConfig`` equal, field by field, to a JAX
    ``rsp_chains_tpu.ChainConfig``. Enums map by value."""
    return _mirror(cfg, ChainConfig)


def cfar2d_config_from_reference(cfg2d) -> Cfar2dConfig:
    """The port's ``Cfar2dConfig`` equal, field by field, to a JAX
    ``rsp_chains_tpu.Cfar2dConfig``."""
    return Cfar2dConfig(**{f.name: getattr(cfg2d, f.name)
                           for f in dataclasses.fields(Cfar2dConfig)})


def _host(v):
    v = np.asarray(v)
    return float(np.float32(v)) if v.dtype.kind == "f" else int(v)


def cfar2d_runtime_from_reference(rt2) -> Cfar2dRuntime:
    """The port's ``Cfar2dRuntime`` from a JAX ``Cfar2dRuntime`` (0-d
    arrays), register for register, copied without ``make()``'s rules."""
    return Cfar2dRuntime(**{f.name: _host(getattr(rt2, f.name))
                            for f in dataclasses.fields(Cfar2dRuntime)})


def runtime_from_reference(regs: dict) -> RuntimeConfig:
    """The port's ``RuntimeConfig`` from ``rt_jax.peek()`` (plain Python or
    numpy scalars keyed by ``make()`` keyword names), register for register.

    The values are copied, not passed through ``make()`` again: the JAX
    ``make()`` derives ``sub_window_size = 2`` for ``ref_window_size = 2``,
    which its own validation would then refuse."""
    vals = {k: _host(v) for k, v in regs.items()}
    vals["log2_fft_size"] = vals.pop("fft_size").bit_length() - 1
    return RuntimeConfig(**vals)
