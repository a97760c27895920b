"""Chain composition: an ordered list of named stages ``(x, rt) -> x``, the
port of ``rsp_chains_tpu.chain``. PyTorch runs eagerly, so a chain is simply
its stages called in turn; each runs under a profiler range named after it."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Sequence, Tuple

import torch

from .configs import ChainConfig, RuntimeConfig

StageFn = Callable[[Any, RuntimeConfig], Any]


@dataclass(frozen=True)
class Stage:
    """A named processing stage."""

    name: str
    fn: StageFn


class Chain:
    """An ordered composition of stages over ``[..., frame]`` tensors. Chains
    nest: ``Chain(cfg, a) + Chain(cfg, b)``."""

    def __init__(self, cfg: ChainConfig, stages: Sequence[Stage]):
        if cfg.fixed_point.enabled:
            raise NotImplementedError(
                "fixed-point fidelity and the bit-true integer pipeline are "
                "not ported yet (ROADMAP queue 1 item 5)")
        self.cfg = cfg
        self.stages = tuple(stages)

    def __call__(self, x: Any, rt: RuntimeConfig) -> Any:
        for stage in self.stages:
            with torch.profiler.record_function(stage.name):
                x = stage.fn(x, rt)
        return x

    def __add__(self, other: "Chain") -> "Chain":
        if not isinstance(other, Chain):
            return NotImplemented
        return Chain(self.cfg, self.stages + other.stages)

    @property
    def stage_names(self) -> Tuple[str, ...]:
        return tuple(s.name for s in self.stages)

    def jit(self) -> "Chain":
        """API parity with the JAX package: PyTorch compiles nothing here, and
        a register write never rebuilds a kernel, so this is the chain."""
        return self
