"""The CPI ring: a few distinct CPIs made on the device from the seed.

The configuration's scene (``scene.kind``, a file ``rspbench/scenes/<kind>.py``
found by ``cells.scene``) draws each CPI's float planes from one generator on
the CPI's device, so a CPI costs a few large launches on the card. A
bit-true configuration takes the float CPI scaled, rounded and clipped to
its integer grid, as int32 planes.
"""

from __future__ import annotations

import torch

from . import cells


def uniform(g: torch.Generator, n: int, lo: float, hi: float,
            device) -> torch.Tensor:
    """``n`` float64 draws from ``[lo, hi)``, for a scene's targets."""
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device,
                                       dtype=torch.float64)


def to_input(config: dict, re: torch.Tensor, im: torch.Tensor) -> tuple:
    """A scene's float planes in the configuration's input format: float32,
    or int32 for an ``int16`` input."""
    inp = config["input"]
    if inp["kind"] == "int16":
        scale, clip = float(inp["scale"]), float(inp["clip"])
        re = torch.round(torch.clamp(re * scale, -clip, clip)).to(torch.int32)
        im = torch.round(torch.clamp(im * scale, -clip, clip)).to(torch.int32)
    elif inp["kind"] != "float32":
        raise ValueError(f"unknown input kind {inp['kind']!r}")
    return re.contiguous(), im.contiguous()


def make_ring(config: dict, n_ring: int, seed: int, device,
              root=cells.REPO) -> list:
    """``n_ring`` distinct CPIs from ``seed``, as ``(re, im)`` planes."""
    scene = cells.scene(config, root)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return [to_input(config, *scene.make_cpi(config, g, device))
            for _ in range(n_ring)]
