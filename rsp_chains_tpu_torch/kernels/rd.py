"""The range-Doppler kernels, the port of ``rsp_chains_tpu.kernels.rd_pallas``.

* Kernel H, ``rd_ca`` / ``rd_map``: the whole range-Doppler chain of a CPI
  batch, matched filter along range -> windowed Doppler DFT over the pulses
  (fftshift, DIV_N / SQRT_N) -> magnitude -> CA/GO/SO CFAR along range per
  Doppler bin; ``emit='map'`` stops after the Doppler transform and returns
  the complex map. Replaces ``rd_pallas.py::fused_rd_chain`` (:565,
  ``pallas_call`` :632); CUDA sources ``csrc/rd_front.cuh`` +
  ``csrc/rd_ca.cu``.
* Kernel J, ``rd_2d``: the same front, then the 2-D annulus CA CFAR on the
  magnitude map. Replaces ``rd_pallas.py::fused_rd_2d_chain`` (:442,
  ``pallas_call`` :515); CUDA sources ``csrc/rd_front.cuh`` +
  ``csrc/cfar_2d.cuh`` + ``csrc/rd_2d.cu``.

A CPI does not fit one block's shared memory, so the CUDA front runs the
Doppler transform first, as its own launch, and the matched filter per
Doppler row after it: the two are linear maps on different axes and commute
(``csrc/rd_front.cuh``). The plain versions keep the JAX package's order
(matched filter, then Doppler). A wrapper launches its kernel for CUDA
tensors and uses the plain version (``*_reference``) only for CPU tensors.

The Doppler launch runs the column plan: 16 pulses of a range column a
thread (8 at P = 8), the lanes of a warp 32 consecutive columns, radix-16
passes in registers (8; 16; 16 x 2 ... 16 x 16; 16 x 16 x 2) with a
transpose through shared memory between them, each bin stored straight to
its shifted row. The row launch's FFT pair runs in passes of radix 16
(``ROW_RADICES``, ``csrc/row_fft.cuh``, shared with Kernel A) and never
reverses bits: its forward transform leaves the spectrum in digit-reversed
order (``row_order``), H is multiplied in that order (``h_rows``), and the
inverse brings the row back to natural order. The host builds H once per
size, replica and device; both plans' twiddles (``row_twiddles`` at n = N
and at n = P) come from ``kernels/chain.py``. Kernel J's detector sums its
windows as 16-cell runs along range and 16-row runs down the columns of
32 x 128 tiles (``csrc/cfar_2d.cuh``).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..configs import (
    ChainConfig, DopplerConfig, MatchedFilterConfig, RuntimeConfig,
)
from ..cplx import C, CLike, as_pair
from ..ops.cfar import CfarOutput
from ..ops.cfar_2d import Cfar2dConfig, Cfar2dRuntime, cfar_2d_op, window_extents
from ..ops.doppler import doppler_fft, doppler_scale
from ..ops.logmag import logmag
from ..ops.matched_filter import h_planes, matched_filter
from ..ops.windows import window as make_window
from .cfar import (
    PAD, CaRegs, ca_registers, call_entry, check_cuda_operands, entry,
    fused_tail_kind, mag_cfar_reference, takes_plain_path,
)
from .chain import FUSABLE_SIZES as RD_SIZES, _permuted, _row_twiddles

class Cfar2dRegs(ctypes.Structure):
    """``RspCfar2dRegs`` of ``csrc/cfar_2d.cuh``, field for field."""

    _fields_ = [("w_r", ctypes.c_int), ("g_r", ctypes.c_int),
                ("w_d", ctypes.c_int), ("g_d", ctypes.c_int),
                ("log_or_linear", ctypes.c_int),
                ("peak_grouping", ctypes.c_int), ("active_lo", ctypes.c_int),
                ("active_hi", ctypes.c_int), ("mag_mode", ctypes.c_int),
                ("scaler", ctypes.c_float)]


def rd_fusable(cfg: ChainConfig, taps) -> bool:
    """Whether the elaboration and replica fit Kernel H: a range frame of
    256, 512 or 1024, a power-of-two pulse count in [8, 512], the
    frequency-domain (circular) matched filter, a replica no longer than the
    frame, and the CFAR window inside the kernels' margin. The JAX package's
    predicate (``rd_pallas.py:136``)."""
    mf_cfg, dop_cfg = cfg.matched_filter, cfg.doppler
    if mf_cfg is None or dop_cfg is None:
        return False
    n, p = cfg.fft.max_size, dop_cfg.num_pulses
    return (n in RD_SIZES
            and (p & (p - 1)) == 0 and 8 <= p <= 512
            and mf_cfg.method == "freq"
            and np.asarray(taps).shape[-1] <= n
            and cfg.cfar.max_ref_window + cfg.cfar.max_guard_window + 1 <= PAD)


def _check_rd(name: str, xp: C, cfg: ChainConfig, taps) -> tuple[int, int]:
    """``fused_rd_chain``'s asserts (``rd_pallas.py:595-602``) as errors."""
    mf_cfg = cfg.matched_filter or MatchedFilterConfig()
    dop_cfg = cfg.doppler or DopplerConfig()
    if xp.re.dim() < 2:
        raise ValueError(f"{name} takes CPI blocks [..., P, N]")
    p, n = xp.shape[-2], xp.shape[-1]
    if n != cfg.fft.max_size or n not in RD_SIZES:
        raise ValueError(f"{name} takes range frames of max_size in "
                         f"{RD_SIZES}, got {n} (max_size {cfg.fft.max_size})")
    if p != dop_cfg.num_pulses or p & (p - 1) or not 8 <= p <= 512:
        raise ValueError(f"{name} takes num_pulses = a power of two in "
                         f"[8, 512] pulses, got {p} (num_pulses "
                         f"{dop_cfg.num_pulses})")
    if mf_cfg.method != "freq":
        raise ValueError(f"{name} computes the circular frequency-domain "
                         f"matched filter; method {mf_cfg.method!r} keeps the "
                         "stage composition")
    if np.asarray(taps).shape[-1] > n:
        raise ValueError(f"{name}: the replica is longer than the frame")
    return p, n


def h_rows(taps, n: int, normalize: bool, device: torch.device) -> torch.Tensor:
    """``h_planes`` in ``row_order``: the [2, n] H the row launch multiplies
    into its digit-reversed spectrum, computed once per replica, size and
    device."""
    return _permuted(h_planes(taps, n, normalize, device))


@functools.lru_cache(maxsize=None)
def _window(p: int, name, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(make_window(name, p)).to(device)


def _front_args(p: int, n: int, taps, cfg: ChainConfig,
                device: torch.device) -> tuple:
    """The front's constants, as the C entries take them: the Doppler
    passes' twiddles (``row_twiddles(P)``), window, the range passes'
    twiddles, H in the row order, log2 P, log2 N, the Doppler scale and the
    fftshift flag."""
    mf_cfg = cfg.matched_filter or MatchedFilterConfig()
    dop_cfg = cfg.doppler or DopplerConfig()
    return (_row_twiddles(p, device).data_ptr(),
            _window(p, dop_cfg.window, device).data_ptr(),
            _row_twiddles(n, device).data_ptr(),
            h_rows(taps, n, mf_cfg.normalize, device).data_ptr(),
            p.bit_length() - 1, n.bit_length() - 1,
            doppler_scale(p, dop_cfg.scaling), int(dop_cfg.fft_shift))


_FRONT_TYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int, ctypes.c_int,
                                         ctypes.c_float, ctypes.c_int)


def rd_front_reference(x: CLike, taps, cfg: ChainConfig) -> C:
    """The plain front: ``matched_filter`` along range, then
    ``doppler_fft`` over the pulses (the JAX package's order)."""
    mf_cfg = cfg.matched_filter or MatchedFilterConfig()
    dop_cfg = cfg.doppler or DopplerConfig()
    return doppler_fft(matched_filter(as_pair(x), taps, mf_cfg), dop_cfg)


def fused_rd_chain_reference(x: CLike, rt: RuntimeConfig, taps,
                             cfg: ChainConfig, emit: str = "cfar"):
    """The plain PyTorch version of ``rd_ca`` (``emit='cfar'``:
    ``matched_filter`` -> ``doppler_fft`` -> ``logmag`` -> ``cfar_op``) and
    of ``rd_map`` (``emit='map'``: the complex map as a ``C``)."""
    y = rd_front_reference(x, taps, cfg)
    return y if emit == "map" else mag_cfar_reference(y, rt, cfg.cfar)


def fused_rd_chain(x: CLike, rt: RuntimeConfig, taps, cfg: ChainConfig, *,
                   emit: str = "cfar"):
    """The whole range-Doppler chain over CPI blocks ``x`` [..., P, N]
    (P = ``cfg.doppler.num_pulses``, N = ``cfg.fft.max_size``) for a CA
    elaboration: ``CfarOutput`` over the [..., P, N] map (Kernel H,
    ``rd_ca``). ``emit='map'`` returns the complex map as a ``C`` instead
    (``rd_map``), for any elaboration."""
    if emit not in ("cfar", "map"):
        raise ValueError(f"emit must be 'cfar' or 'map', not {emit!r}")
    xp = as_pair(x)
    p, n = _check_rd("fused_rd_chain", xp, cfg, taps)
    if cfg.cfar.max_ref_window + cfg.cfar.max_guard_window + 1 > PAD:
        raise ValueError("max_ref_window + max_guard_window + 1 exceeds the "
                         f"kernels' {PAD}-cell margin")
    if emit == "cfar" and fused_tail_kind(cfg) != "ca":
        raise ValueError("fused_rd_chain's CFAR is the CA family (CA/GO/SO, "
                         "PARTIAL edges); other elaborations take emit='map'")
    name = "rd_ca" if emit == "cfar" else "rd_map"
    if takes_plain_path(xp, name):
        return fused_rd_chain_reference(xp, rt, taps, cfg, emit)
    check_cuda_operands(xp.re, xp.im)
    batch = xp.re.numel() // (p * n)
    front = _front_args(p, n, taps, cfg, xp.device)
    if emit == "map":
        out = C(torch.empty_like(xp.re), torch.empty_like(xp.im))
        if batch:
            fn = entry("rsp_rd_map", *_FRONT_TYPES)
            call_entry(name, xp.device, fn,
                       (xp.re.data_ptr(), xp.im.data_ptr(),
                        out.re.data_ptr(), out.im.data_ptr(), batch), front)
        return out
    thr = torch.empty_like(xp.re)
    pk = torch.empty(xp.shape, dtype=torch.uint8, device=xp.device)
    if batch:
        yre, yim = torch.empty_like(xp.re), torch.empty_like(xp.im)
        fn = entry("rsp_rd_ca", ctypes.c_void_p, ctypes.c_void_p,
                   *_FRONT_TYPES, CaRegs)
        call_entry(name, xp.device, fn,
                   (xp.re.data_ptr(), xp.im.data_ptr(), thr.data_ptr(),
                    pk.data_ptr(), batch),
                   (yre.data_ptr(), yim.data_ptr(), *front,
                    ca_registers(rt, cfg.cfar, n)))
    return CfarOutput(threshold=thr, peaks=pk.view(torch.bool))


def cfar_2d_registers(rt: RuntimeConfig, rt2: Cfar2dRuntime,
                      cfg2d: Cfar2dConfig, n: int) -> Cfar2dRegs:
    """Kernel J's register struct, clamped on the host as
    ``rd_pallas.py:488-500`` clamps it: the extents to the elaborated maxima,
    the active range to [0, min(active_range, n)); the magnitude mode
    clipped to 0..3, as ``ops.logmag`` clips it."""
    w_r, g_r, w_d, g_d = window_extents(rt2, cfg2d)
    return Cfar2dRegs(
        w_r=w_r, g_r=g_r, w_d=w_d, g_d=g_d,
        log_or_linear=int(rt2.log_or_linear),
        peak_grouping=int(rt2.peak_grouping), active_lo=0,
        active_hi=max(min(int(rt2.active_range), n), 0),
        mag_mode=min(max(int(rt.mag_mode), 0), 3),
        scaler=float(rt2.threshold_scaler))


def fused_rd_2d_chain_reference(x: CLike, rt: RuntimeConfig,
                                rt2: Cfar2dRuntime, taps, cfg: ChainConfig,
                                cfg2d: Cfar2dConfig) -> CfarOutput:
    """The plain PyTorch version of ``rd_2d``: the plain front, ``logmag``
    and ``cfar_2d_op``."""
    return cfar_2d_op(logmag(rd_front_reference(x, taps, cfg), rt.mag_mode),
                      rt2, cfg2d)


def fused_rd_2d_chain(x: CLike, rt: RuntimeConfig, rt2: Cfar2dRuntime, taps,
                      cfg: ChainConfig, cfg2d: Cfar2dConfig) -> CfarOutput:
    """The range-Doppler chain with the 2-D annulus CA CFAR over CPI blocks
    ``x`` [..., P, N] (Kernel J, ``rd_2d``): ``rd_fusable`` shapes and the
    2-D range reach 2 (max_ref_range + max_guard_range) + 2 <= 128, the
    JAX kernel's limits; any Doppler reach."""
    xp = as_pair(x)
    p, n = _check_rd("fused_rd_2d_chain", xp, cfg, taps)
    if 2 * (cfg2d.max_ref_range + cfg2d.max_guard_range) + 2 > PAD:
        raise ValueError("the 2-D range reach exceeds the kernels' "
                         f"{PAD}-cell margin")
    if cfg2d.include_os:
        raise ValueError("the 2-D OS body has no kernel; rd_2d_cfar_chain "
                         "runs it with cfar_2d_op")
    if takes_plain_path(xp, "rd_2d"):
        return fused_rd_2d_chain_reference(xp, rt, rt2, taps, cfg, cfg2d)
    return rd_2d_launch(xp, cfar_2d_registers(rt, rt2, cfg2d, n), taps, cfg)


def rd_2d_launch(xp: C, regs: Cfar2dRegs, taps, cfg: ChainConfig
                 ) -> CfarOutput:
    """Kernel J on the CUDA CPI blocks ``xp`` [..., P, N] under the clamped
    register struct ``regs`` (``cfar_2d_registers``; the tests also set its
    ``active_lo``, which the registers leave at 0)."""
    p, n = xp.shape[-2], xp.shape[-1]
    check_cuda_operands(xp.re, xp.im)
    batch = xp.re.numel() // (p * n)
    thr = torch.empty_like(xp.re)
    pk = torch.empty(xp.shape, dtype=torch.uint8, device=xp.device)
    if batch:
        yre, yim = torch.empty_like(xp.re), torch.empty_like(xp.im)
        fn = entry("rsp_rd_2d", ctypes.c_void_p, ctypes.c_void_p,
                   *_FRONT_TYPES, Cfar2dRegs)
        call_entry("rd_2d", xp.device, fn,
                   (xp.re.data_ptr(), xp.im.data_ptr(), thr.data_ptr(),
                    pk.data_ptr(), batch),
                   (yre.data_ptr(), yim.data_ptr(),
                    *_front_args(p, n, taps, cfg, xp.device), regs))
    return CfarOutput(threshold=thr, peaks=pk.view(torch.bool))
