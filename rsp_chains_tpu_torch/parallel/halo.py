"""Neighbour halo exchange over the range axis, the port of
``rsp_chains_tpu.parallel.halo``.

The window operators fix what crosses shard boundaries when the range
(fast-time) axis is sharded: CFAR needs ``guard + ref`` cells of halo on
each side, an overlap-save FIR ``num_taps - 1`` cells of left halo. The JAX
package exchanges them with one ``lax.ppermute`` per direction inside
``shard_map``. Here the same exchange is plain torch over the blocks of one
mesh axis (each a tensor on its shard's device, in ring order): slice the
neighbour's edge and move it to the shard's device. Shards at the global
frame ends receive zeros (``ppermute``'s absent-source semantics), which
composes with the CFAR's ``active_lo`` / ``active_hi`` to reproduce the
frame-edge behaviour exactly. Kernel K (``kernels/halo.halo_exchange``) is
the kernel form, as ``pallas_halo.halo_exchange_rdma`` is JAX's.
"""

from __future__ import annotations

from typing import Sequence

import torch


def check_halo(blocks: Sequence[torch.Tensor], halo: int) -> None:
    """The blocks of one mesh axis share a shape, and ``halo`` fits in one:
    a halo wider than the local shard would need the neighbour's neighbour,
    and every fixed-width slice downstream would misindex. Shard wider
    (fewer range shards) or elaborate smaller windows or filters."""
    if not blocks:
        raise ValueError("no blocks")
    shape = blocks[0].shape
    if any(b.shape != shape for b in blocks):
        raise ValueError("the blocks of one mesh axis must share a shape")
    if halo > shape[-1]:
        raise ValueError(f"halo {halo} exceeds the local shard width "
                         f"{shape[-1]}")


def exchange_halo(blocks: Sequence[torch.Tensor], halo: int
                  ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``(left_halo, right_halo)`` for each block ``[..., n_local]`` of one
    mesh axis: ``left_halo`` the last ``halo`` samples of the left neighbour
    (zeros on the first shard), ``right_halo`` the first ``halo`` samples of
    the right neighbour (zeros on the last shard), on the shard's device."""
    blocks = list(blocks)
    check_halo(blocks, halo)
    n = len(blocks)

    def zeros(b):
        return torch.zeros(b.shape[:-1] + (max(halo, 0),), dtype=b.dtype,
                           device=b.device)

    if halo <= 0 or n == 1:
        return [(zeros(b), zeros(b)) for b in blocks]
    return [
        (blocks[r - 1][..., -halo:].to(b.device, copy=True) if r > 0
         else zeros(b),
         blocks[r + 1][..., :halo].to(b.device, copy=True) if r + 1 < n
         else zeros(b))
        for r, b in enumerate(blocks)]


def extend_with_halo(blocks: Sequence[torch.Tensor], halo: int
                     ) -> list[torch.Tensor]:
    """Each block with its neighbours' halos around it:
    ``[..., halo + n_local + halo]``."""
    return [torch.cat([left, b, right], dim=-1)
            for b, (left, right) in zip(blocks, exchange_halo(blocks, halo))]
