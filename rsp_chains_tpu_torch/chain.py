"""Chain composition: an ordered list of named stages ``(x, rt) -> x``, the
port of ``rsp_chains_tpu.chain``. PyTorch runs eagerly, so a chain is simply
its stages called in turn; each runs under a profiler range named after it.

A chain has a device, CUDA unless the caller asks for ``device="cpu"``. Host
input (numpy arrays) goes to that device before the first stage, so a numpy
frame never lands on the CPU unasked: without a card such a call raises.
Tensors stay where they are, so CPU tensors remain the explicit way to ask
for the kernels' plain versions.

When ``cfg.fixed_point.enabled`` and not ``bit_true``, every non-terminal
stage's output is snapped to the fixed-point grid (``numerics.quantize``),
as the JAX package does (its ``chain.py:59-72``); the bit-true integer
stages are exact and need no boundary quantization.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from .configs import ChainConfig, RuntimeConfig
from .cplx import C, as_pair
from .numerics import quantize

StageFn = Callable[[Any, RuntimeConfig], Any]


@dataclass(frozen=True)
class Stage:
    """A named processing stage. A terminal stage (CFAR, word packing) emits
    structured output and gets no boundary quantization after it."""

    name: str
    fn: StageFn
    terminal: bool = False


def _require_card(device: torch.device, what: str) -> None:
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} the chain's device, CUDA, and no CUDA card is "
            "available; build the chain with device='cpu' or pass CPU "
            "tensors to run the plain versions on the CPU")


def source_device(device=None) -> torch.device:
    """The device of a source chain (``rsp_chain_vanilla``,
    ``chain_with_mem``, ``real_rx_chain``), which builds its tensors there:
    CUDA unless the caller names another; raises where that is CUDA and no
    card is available."""
    device = torch.device(device if device is not None else "cuda")
    _require_card(device, "a source chain builds its tensors on")
    return device


def _host_to_device(x: Any, device: torch.device) -> Any:
    """A numpy array as a tensor on ``device``; anything else unchanged.
    Complex arrays become a ``C`` of float32 planes; uint32 words keep their
    bits as an int32 view."""
    if not isinstance(x, np.ndarray):
        return x
    _require_card(device, "numpy input goes to")
    if np.iscomplexobj(x):
        return as_pair(x, device=device)
    if x.dtype == np.uint32:
        x = x.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


class Chain:
    """An ordered composition of stages over ``[..., frame]`` tensors. Chains
    nest: ``Chain(cfg, a) + Chain(cfg, b)``."""

    def __init__(self, cfg: ChainConfig, stages: Sequence[Stage],
                 device: Optional[torch.device | str] = None):
        self.cfg = cfg
        self.stages = tuple(stages)
        self.device = torch.device(device if device is not None else "cuda")

    def __call__(self, x: Any, rt: RuntimeConfig) -> Any:
        x = _host_to_device(x, self.device)
        fp = self.cfg.fixed_point
        for stage in self.stages:
            with torch.profiler.record_function(stage.name):
                x = stage.fn(x, rt)
            if (fp.enabled and not fp.bit_true and not stage.terminal
                    and isinstance(x, (torch.Tensor, C))):
                x = quantize(x, fp)
        return x

    def __add__(self, other: "Chain") -> "Chain":
        if not isinstance(other, Chain):
            return NotImplemented
        return Chain(self.cfg, self.stages + other.stages, self.device)

    @property
    def stage_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.stages)

    def jit(self) -> "Chain":
        """API parity with the JAX package: PyTorch compiles nothing here, and
        a register write never rebuilds a kernel, so this is the chain."""
        return self


def source_chain(cfg: ChainConfig, stages: Sequence[Stage],
                 device=None) -> Chain:
    """A chain whose first stage ignores its input and makes its own on the
    chain's device (self-stimulus tops like ``RspChainVanilla``, which has
    no external data input); call it with ``x = None``."""
    return Chain(cfg, stages, device)
