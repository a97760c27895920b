"""Device meshes, the port of ``rsp_chains_tpu.parallel.mesh``.

The reference's scaling axes map to a 2-D ``(ch, rng)`` grid of devices:

* ``ch``: channel / beam data parallelism (N chain instances in hardware
  terms), with no exchange between shards;
* ``rng``: range-axis (fast-time) sequence parallelism, where CFAR windows
  and overlap-save FIR history cross shard boundaries as a neighbour halo.

A mesh may list one device several times: ``[torch.device("cpu")] * 8`` is
the CPU tests' mesh, and ``["cuda:0"] * 4`` runs four virtual shards on one
card, the real kernels included. Distinct cards of a host make a mesh whose
halo kernels read their neighbours' memory over NVLink.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

CHANNEL_AXIS = "ch"
RANGE_AXIS = "rng"


@dataclass(frozen=True)
class Mesh:
    """A ``(ch, rng)`` grid of devices: ``devices[c][r]`` holds channel
    shard ``c``, range shard ``r``."""

    devices: tuple[tuple[torch.device, ...], ...]
    axis_names: tuple[str, str] = (CHANNEL_AXIS, RANGE_AXIS)

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, as ``jax.sharding.Mesh.shape``."""
        return {CHANNEL_AXIS: len(self.devices),
                RANGE_AXIS: len(self.devices[0])}


def _cuda_devices() -> list[torch.device]:
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(channels: int = 1, range_shards: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``(ch, rng)`` mesh over ``devices`` (each a ``torch.device`` or
    its name; repeats allowed), by default the visible CUDA cards."""
    if channels < 1 or range_shards < 1:
        raise ValueError(f"mesh {channels}x{range_shards}: both axes need at "
                         "least one shard")
    devices = [torch.device(d) for d in devices] if devices is not None \
        else _cuda_devices()
    need = channels * range_shards
    if need > len(devices):
        raise ValueError(f"mesh {channels}x{range_shards} needs {need} "
                         f"devices, have {len(devices)}")
    return Mesh(tuple(tuple(devices[c * range_shards:(c + 1) * range_shards])
                      for c in range(channels)))


def auto_mesh(n_devices: Optional[int] = None) -> Mesh:
    """Everything on the channel axis of the visible CUDA cards unless
    range sharding is asked for explicitly: channel parallelism needs no
    exchange."""
    n = n_devices if n_devices is not None else torch.cuda.device_count()
    return make_mesh(channels=n, range_shards=1)


def chain_spec(batch_axes: int = 1) -> tuple:
    """How ``[channels, ..., range]`` arrays lie on a ``(ch, rng)`` mesh: the
    mesh axis of each dimension, None for an unsharded one (the port's form
    of a ``PartitionSpec``)."""
    return (CHANNEL_AXIS, *([None] * (batch_axes - 1)), RANGE_AXIS)
