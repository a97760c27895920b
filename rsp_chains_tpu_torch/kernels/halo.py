"""The halo kernels of the range-sharded chains, the port of
``rsp_chains_tpu.kernels.pallas_halo``.

* Kernel K, ``halo_exchange``: each shard's ring neighbours' ``halo`` edge
  cells, zeros at the global frame ends. Replaces
  ``pallas_halo.py::halo_exchange_rdma`` (:124, ``pallas_call`` :140).
* Kernel L, ``mag_extend``: each shard's extended magnitude row
  ``[..., halo + n_loc + halo]``, the local magnitude and its neighbours'
  halo magnitudes. Replaces ``pallas_halo.py::mag_extend_rdma`` (:177,
  ``pallas_call`` :197).

CUDA source ``csrc/halo.cu``. The TPU kernels run inside ``shard_map``, one
program a chip, and push halos by remote DMA. In the port a call takes the
blocks of one mesh axis (each a tensor on its shard's device, in ring order)
and launches one kernel a shard, on that shard's device and its current
stream; the kernel pulls its neighbours' cells through their device
pointers: local memory for the virtual shards of one card, peer memory over
NVLink for the cards of a host. Peer access is enabled once for each pair of
neighbouring cards (``enable_peer_access``); a pair that cannot reach each
other raises, and nothing falls back to staged copies.

Ordering and lifetime, across cards: the reader's stream waits on an event
recorded on each neighbour's current stream, after the neighbour's
producer; after the launch, each neighbour's current stream waits on an
event recorded after the read, so the caching allocator cannot give a
neighbour's block to new work on its stream while the read runs. Shards on
one device share its current stream and need neither.

A wrapper launches its kernel for CUDA blocks and uses the plain version
(``*_reference``: ``parallel.halo.exchange_halo`` and
``extend_with_halo(logmag(...))``) only for CPU blocks.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from ..cplx import C
from ..ops.logmag import logmag
from ..parallel.halo import check_halo, exchange_halo, extend_with_halo
from .cfar import call_entry, check_cuda_operands, entry
from . import _build

_PEERS: set = set()


def enable_peer_access(reader: torch.device, owner: torch.device) -> None:
    """Let ``reader``'s kernels read ``owner``'s memory; accepts access that
    is already enabled, and raises where the two cards cannot reach each
    other."""
    key = (reader.index, owner.index)
    if reader == owner or key in _PEERS:
        return
    fn = _build.library().rsp_enable_peer_access
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    rc = fn(reader.index, owner.index)
    if rc != 0:
        raise RuntimeError(f"{reader} cannot read {owner}'s memory (CUDA error "
                           f"{rc}): the halo kernels need peer access between "
                           "neighbouring cards")
    _PEERS.add(key)


def _plain(blocks: Sequence[torch.Tensor], name: str) -> bool:
    """True for CPU blocks, False for CUDA blocks; raises for a mix or any
    other device."""
    kinds = {b.device.type for b in blocks}
    if kinds == {"cpu"}:
        return True
    if kinds != {"cuda"}:
        raise ValueError(f"{name} takes the blocks of one mesh axis, all on "
                         f"the CPU or all on CUDA devices, not {sorted(kinds)}")
    return False


def _neighbours(blocks: Sequence, r: int) -> tuple[Optional[object],
                                                   Optional[object]]:
    return (blocks[r - 1] if r > 0 else None,
            blocks[r + 1] if r + 1 < len(blocks) else None)


def _launch_reading(name: str, device: torch.device,
                    owners: Sequence[torch.device], fn, head: tuple,
                    tail: tuple) -> None:
    """Launch a kernel on ``device`` that reads the memory of ``owners``,
    with the ordering and lifetime waits of the module docstring."""
    others = {o for o in owners if o != device}
    for o in others:
        enable_peer_access(device, o)
        produced = torch.cuda.Event()
        produced.record(torch.cuda.current_stream(o))
        torch.cuda.current_stream(device).wait_event(produced)
    call_entry(name, device, fn, head, tail)
    for o in others:
        read = torch.cuda.Event()
        read.record(torch.cuda.current_stream(device))
        torch.cuda.current_stream(o).wait_event(read)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _plane_ptrs(b: Optional[C]) -> tuple[Optional[int], Optional[int]]:
    return (None, None) if b is None else (b.re.data_ptr(), b.im.data_ptr())


def _check_blocks(tensors: Sequence[torch.Tensor]) -> None:
    """The kernels take contiguous float32 blocks of one shape, each on its
    shard's card."""
    for t in tensors:
        if t.shape != tensors[0].shape:
            raise ValueError("the blocks of one mesh axis must share a shape")
        check_cuda_operands(t)


def halo_exchange_reference(blocks: Sequence[torch.Tensor], halo: int):
    """The plain PyTorch version of ``halo_exchange``:
    ``parallel.halo.exchange_halo``."""
    return exchange_halo(blocks, halo)


def halo_exchange(blocks: Sequence[torch.Tensor], halo: int
                  ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``(left, right)`` for each block of one mesh axis (``[..., n_local]``,
    in ring order): the left neighbour's last ``halo`` cells and the right
    neighbour's first ``halo`` cells, zeros at the global frame ends, each on
    its shard's device. CUDA blocks are float32, contiguous and of one
    shape."""
    blocks = list(blocks)
    check_halo(blocks, halo)
    if _plain(blocks, "halo_exchange"):
        return halo_exchange_reference(blocks, halo)
    _check_blocks(blocks)
    n_loc = blocks[0].shape[-1]
    frames = blocks[0].numel() // max(n_loc, 1)
    h = max(halo, 0)
    fn = entry("rsp_halo_exchange", ctypes.c_int, ctypes.c_int)
    out = []
    for r, b in enumerate(blocks):
        left = torch.empty(b.shape[:-1] + (h,), dtype=b.dtype, device=b.device)
        right = torch.empty_like(left)
        ln, rn = _neighbours(blocks, r)
        if frames * h:
            _launch_reading("halo_exchange", b.device,
                            [nb.device for nb in (ln, rn) if nb is not None],
                            fn, (_ptr(ln), _ptr(rn), left.data_ptr(),
                                 right.data_ptr(), frames), (n_loc, h))
        out.append((left, right))
    return out


def mag_extend_reference(blocks: Sequence[C], halo: int,
                         mag_mode: int) -> list[torch.Tensor]:
    """The plain PyTorch version of ``mag_extend``:
    ``extend_with_halo(logmag(...))``."""
    return extend_with_halo([logmag(b, mag_mode) for b in blocks], halo)


def mag_extend(blocks: Sequence[C], halo: int,
               mag_mode: int) -> list[torch.Tensor]:
    """The extended magnitude row ``[..., halo + n_local + halo]`` of each
    spectrum block of one mesh axis (``C`` pairs ``[..., n_local]``, in ring
    order): the ``mag_mode``-selected magnitude (clipped to 0..3, as
    ``ops.logmag`` clips it) of the block and of its neighbours' halo cells,
    zeros at the global frame ends. CUDA blocks are float32, contiguous and
    of one shape."""
    blocks = list(blocks)
    check_halo([b.re for b in blocks], halo)
    if _plain([b.re for b in blocks], "mag_extend"):
        return mag_extend_reference(blocks, halo, mag_mode)
    _check_blocks([t for b in blocks for t in b])
    shape = blocks[0].shape
    n_loc = shape[-1]
    frames = blocks[0].re.numel() // max(n_loc, 1)
    h = max(halo, 0)
    mode = min(max(int(mag_mode), 0), 3)
    fn = entry("rsp_mag_extend", ctypes.c_int, ctypes.c_int, ctypes.c_int,
               pointers=7)
    out = []
    for r, b in enumerate(blocks):
        ext = torch.empty(shape[:-1] + (n_loc + 2 * h,), dtype=torch.float32,
                          device=b.device)
        ln, rn = _neighbours(blocks, r)
        if ext.numel():
            _launch_reading(
                "mag_extend", b.device,
                [nb.device for nb in (ln, rn) if nb is not None], fn,
                (b.re.data_ptr(), b.im.data_ptr(),
                 *_plane_ptrs(ln), *_plane_ptrs(rn), ext.data_ptr(), frames),
                (n_loc, h, mode))
        out.append(ext)
    return out
