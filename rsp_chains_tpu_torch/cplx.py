"""Real-pair complex representation.

The kernels read and write separate float32 planes, so the chain's device format
is ``C(re, im)``, two contiguous float32 tensors, as in the JAX package. Ops
also accept a complex tensor or a complex numpy array and then answer in a
complex tensor.
"""

from __future__ import annotations

from typing import NamedTuple, Union

import numpy as np
import torch


class C(NamedTuple):
    """A complex array as separate real and imaginary float32 tensors."""

    re: torch.Tensor
    im: torch.Tensor

    @property
    def shape(self):
        return self.re.shape

    @property
    def device(self) -> torch.device:
        return self.re.device


CLike = Union[C, torch.Tensor, np.ndarray]


def as_pair(x: CLike, device=None) -> C:
    """Normalise to ``C``. A complex tensor or array is split into contiguous
    float32 planes; a real one gets a zero imaginary plane. ``device`` moves
    the result (numpy input lands on the CPU otherwise). A ``C`` passes
    through unchanged apart from the move."""
    if isinstance(x, C):
        return x if device is None else C(x.re.to(device), x.im.to(device))
    if isinstance(x, np.ndarray):
        if np.iscomplexobj(x):
            re = torch.from_numpy(np.ascontiguousarray(x.real, np.float32))
            im = torch.from_numpy(np.ascontiguousarray(x.imag, np.float32))
        else:
            re = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            im = torch.zeros_like(re)
        return C(re.to(device), im.to(device)) if device is not None else C(re, im)
    x = x if device is None else x.to(device)
    if x.is_complex():
        return C(x.real.float().contiguous(), x.imag.float().contiguous())
    x = x.float().contiguous()
    return C(x, torch.zeros_like(x))


def join(c: C) -> torch.Tensor:
    """Pair -> complex64 tensor."""
    return torch.complex(c.re.float(), c.im.float())


def like(x_in: CLike, result: C):
    """``result`` in the caller's representation: ``C`` for pair callers, a
    complex tensor otherwise."""
    return result if isinstance(x_in, C) else join(result)


def to_numpy(c: C) -> np.ndarray:
    """Pair -> host numpy complex64."""
    re = c.re.detach().cpu().numpy()
    im = c.im.detach().cpu().numpy()
    return (re + 1j * im).astype(np.complex64)
