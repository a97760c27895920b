"""Stream payload packing, the port of ``rsp_chains_tpu.packing``: int16 IQ
<-> 32-bit beat words <-> complex tensors, and the CFAR output words.

An IQ beat word carries one complex sample, real in bits [31:16] and imag in
[15:0], 16-bit two's complement (``RspChainTesterUtils.scala:105-109``). A
CFAR output word is ``{threshold | bin | peak}``: bit 0 the peak flag, bits
[log2(fftSize):1] the bin (or the cell under test where ``sendCut`` is
elaborated), the threshold above (``RspChainVanillaTester.scala:164-172``).

torch's ``uint32`` has few operations, so words are carried as an ``int32``
view of the same bits, as the JAX kernel carries them
(``chain_pallas.py:1071-1073``); ``.view(torch.uint32)`` or, on the host,
``.numpy().view(np.uint32)`` reads them unsigned. The bit work is done in
int64 and wrapped back to int32.
"""

from __future__ import annotations

import numpy as np
import torch

from .cplx import C, CLike, as_pair, join


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) as the int32 view of the same bits."""
    return torch.where(v >= 2**31, v - 2**32, v).to(torch.int32)


def as_words(words) -> torch.Tensor:
    """Words (a numpy uint32 or int32 array, or a uint32 or int32 tensor) as
    an int32 tensor of the same bits."""
    if isinstance(words, np.ndarray):
        if words.dtype == np.uint32:
            words = words.view(np.int32)
        return torch.from_numpy(np.ascontiguousarray(words, np.int32))
    return words.view(torch.int32) if words.dtype == torch.uint32 else words


def pack_iq(iq: CLike) -> torch.Tensor:
    """Pack integer-valued complex samples (a ``C`` pair, a complex tensor or
    a complex numpy array; |re|, |im| < 2^15) into beat words, int32 view.
    Values are truncated to integers and wrapped to 16 bits."""
    p = iq if isinstance(iq, C) else as_pair(iq)
    re = p.re.to(torch.int64) & 0xFFFF
    im = p.im.to(torch.int64) & 0xFFFF
    return _wrap32((re << 16) | im)


def unpack_iq_pair(words) -> C:
    """Beat words -> a ``C`` float32 pair (sign-extended halves)."""
    w = as_words(words)
    re = (w >> 16).to(torch.float32)
    im = (((w & 0xFFFF) ^ 0x8000) - 0x8000).to(torch.float32)
    return C(re, im)


def unpack_iq(words) -> torch.Tensor:
    """Beat words -> a complex64 tensor."""
    return join(unpack_iq_pair(words))


def pack_cfar_words(threshold: torch.Tensor, peaks: torch.Tensor,
                    log2_fft_size: int,
                    cut: torch.Tensor | None = None) -> torch.Tensor:
    """Pack CFAR outputs into ``{threshold | bin | peak}`` words, int32 view.
    The threshold saturates to its field, [0, 2^(31 - bin width) - 1], and
    is truncated to an integer; the bin field holds the bin, or the cell under
    test (saturated to [0, 2^32 - 1], truncated, then masked) when ``cut`` is
    given. An integer threshold goes through float32 first, as the JAX
    package's clip promotes it."""
    n = threshold.shape[-1]
    bw = int(log2_fft_size)
    mask = (1 << bw) - 1
    thr = torch.clamp(threshold.to(torch.float32).to(torch.float64), 0.0,
                      float((1 << (31 - bw)) - 1)).to(torch.int64)
    if cut is None:
        mid = torch.arange(n, device=threshold.device).expand(threshold.shape)
    else:
        mid = torch.clamp(cut.to(torch.float64), 0.0,
                          float(2**32 - 1)).to(torch.int64)
    pk = peaks.to(torch.int64) & 1
    return _wrap32((thr << (bw + 1)) | ((mid & mask) << 1) | pk)


def unpack_cfar_words(words, log2_fft_size: int):
    """Decode CFAR words -> (threshold, bin_or_cut, peak) int32 tensors, the
    tester's decode loop (``RspChainVanillaTester.scala:168-172``)."""
    w = as_words(words)
    bw = int(log2_fft_size)
    peaks = w & 1
    bins = (w >> 1) & ((1 << bw) - 1)
    threshold = (w >> (bw + 1)) & ((1 << (31 - bw)) - 1)
    return threshold, bins, peaks
