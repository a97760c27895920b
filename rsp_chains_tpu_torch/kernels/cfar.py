"""The magnitude + CFAR kernels on a spectrum, and their dispatch.

* Kernel B, ``mag_cfar``: magnitude + CA/GO/SO CFAR. Replaces
  ``rsp_chains_tpu/kernels/cfar_pallas.py::fused_mag_cfar`` (:489,
  ``pallas_call`` :555); CUDA source ``csrc/mag_cfar.cu`` with the run-sum
  tail of ``csrc/row_fft.cuh``, 16 contiguous cells a thread, rows of up to
  4096 cells several a block and longer rows in tiles. It moves 13 bytes per
  complex sample: 8 in, 4 + 1 out.
* Kernel C, ``mag_gos_cfar``: magnitude + GOS / GOSCA / CASH CFAR. Replaces
  ``cfar_pallas.py::fused_mag_gos_cfar`` (:1593, ``pallas_call`` :1716); CUDA
  source ``csrc/mag_gos_cfar.cu`` with ``csrc/gos_cfar.cuh``.
* ``fused_mag_gos_dispatch``, the port of ``cfar_pallas.py:1747``: CA-like
  registers of a GOSCA elaboration take Kernel B, the rest Kernel C.

All three take the JAX kernels' ``active_lo`` / ``active_hi`` (the valid
cells in local coordinates, for the range-sharded tail) and ``mag_given``:
the input is a real float32 tensor that already holds the magnitude (the
tail computes it in Kernel L, ``kernels/halo.py``). ``mag_given`` stands in
for the TPU kernels' ``MAG_PASSTHROUGH`` register code
(``cfar_pallas.py:106``); in the port it is an argument of the wrapper and
never a register value, so a user's ``mag_mode`` above 3 still gives LOG2.

Each CUDA source says what bounds its kernel on the H100 and how its design
answers. A wrapper launches its kernel for CUDA tensors and uses the plain
version (``*_reference``) only for CPU tensors. Registers are host values
passed by value at launch (``CaRegs`` / ``GosRegs``), so a register write
costs no device sync and no rebuild.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Callable, Optional

import torch

from ..configs import ChainConfig, CfarConfig, CfarVariant, EdgePolicy, RuntimeConfig
from ..cplx import C, CLike, as_pair
from ..ops.cfar import (
    CfarOutput, cfar_op, effective_algorithm, effective_mode, window_registers,
)
from ..ops.logmag import logmag
from ..utils import profiling
from . import _build

MAX_LOG2_W = 6   # the kernels' window bound, as in cfar_pallas.MAX_LOG2_W
PAD = 128        # csrc/ca_cfar.cuh RSP_PAD: zero margin each side of the row
GOS_TILE = 256   # csrc/gos_cfar.cuh RSP_GOS_TILE: Kernel C's range tile


class CaRegs(ctypes.Structure):
    """``RspCaRegs`` of ``csrc/ca_cfar.cuh``, field for field."""

    _fields_ = [("log2w", ctypes.c_int), ("guard", ctypes.c_int),
                ("div_sum", ctypes.c_int), ("cfar_mode", ctypes.c_int),
                ("log_or_linear", ctypes.c_int),
                ("peak_grouping", ctypes.c_int), ("active_lo", ctypes.c_int),
                ("active_hi", ctypes.c_int), ("mag_mode", ctypes.c_int),
                ("scaler", ctypes.c_float)]


class GosRegs(ctypes.Structure):
    """``RspGosRegs`` of ``csrc/gos_cfar.cuh``, field for field: the 13
    registers in the order of ``fused_mag_gos_cfar``'s scalars
    (``cfar_pallas.py:1663-1677``), then the scaler."""

    _fields_ = [("log2w", ctypes.c_int), ("guard", ctypes.c_int),
                ("div_sum", ctypes.c_int), ("cfar_mode", ctypes.c_int),
                ("log_or_linear", ctypes.c_int),
                ("peak_grouping", ctypes.c_int), ("active_hi", ctypes.c_int),
                ("mag_mode", ctypes.c_int), ("algorithm", ctypes.c_int),
                ("rank_lagg", ctypes.c_int), ("rank_lead", ctypes.c_int),
                ("sub_w", ctypes.c_int), ("active_lo", ctypes.c_int),
                ("scaler", ctypes.c_float)]


def fused_tail_kind(chain_cfg: ChainConfig) -> Optional[str]:
    """``"ca"`` when the CA kernels carry this elaboration's semantics,
    ``"gos"`` when the GOSCA kernels do, else None (the plain ops). The gate
    of the JAX package's ``cfar_pallas.fused_tail_kind`` (:1784)."""
    cfar = chain_cfg.cfar
    if not cfar.use_pallas or cfar.send_cut or cfar.emit_noise:
        return None
    if cfar.edge_policy is not EdgePolicy.PARTIAL:
        return None
    if chain_cfg.fixed_point.enabled or chain_cfg.mag.use_lut_log:
        return None
    if cfar.max_ref_window + cfar.max_guard_window + 1 > PAD:
        return None
    if cfar.variant is CfarVariant.CA and not cfar.include_cash:
        return "ca" if cfar.max_ref_window <= 1 << MAX_LOG2_W else None
    if cfar.variant in (CfarVariant.GOS, CfarVariant.GOSCA):
        return "gos"
    return None


def ca_like(rt: RuntimeConfig, cfg: CfarConfig) -> bool:
    """Whether the registers select CA statistics outside CASH mode, so the CA
    kernels carry the call (``fused_mag_gos_dispatch``'s condition,
    ``cfar_pallas.py:1773``). A pure-GOS elaboration never is: it has no CA
    datapath (``ops.cfar.effective_algorithm``)."""
    return (effective_algorithm(rt, cfg) == 0
            and min(max(int(rt.cfar_mode), 0), 3) != 3)


def check_window_bounds(cfg: CfarConfig) -> None:
    if cfg.max_ref_window > 1 << MAX_LOG2_W:
        raise ValueError(f"max_ref_window {cfg.max_ref_window} exceeds the "
                         f"kernels' {1 << MAX_LOG2_W}")
    if cfg.max_ref_window + cfg.max_guard_window + 1 > PAD:
        raise ValueError("max_ref_window + max_guard_window + 1 exceeds the "
                         f"kernels' {PAD}-cell margin")


def active_range(rt: RuntimeConfig, n: int, active_lo: Optional[int],
                 active_hi: Optional[int]) -> tuple[int, int]:
    """The active cells ``[lo, hi)`` within ``[0, n]``: by default
    ``[0, min(cfar_fft_size, n))``, as ``chain_pallas._chain_scalars``
    (:817) clamps it."""
    lo = 0 if active_lo is None else int(active_lo)
    hi = int(rt.cfar_fft_size) if active_hi is None else int(active_hi)
    return min(max(lo, 0), n), min(max(hi, 0), n)


def ca_registers(rt: RuntimeConfig, cfg: CfarConfig, n: int,
                 active_lo: Optional[int] = None,
                 active_hi: Optional[int] = None) -> CaRegs:
    """The CA kernels' register struct, clamped on the host as
    ``chain_pallas._chain_scalars`` (:817) clamps it, with the active range
    of ``active_range``.

    ``mag_mode`` is clipped to 0..3 as the JAX package's ``ops.logmag`` clips
    it, so a code above 3 gives LOG2. The Pallas kernels' ``_magnitude`` passes
    such a code through as the raw real part instead; the port follows the
    plain op."""
    log2w, guard = window_registers(rt, cfg)
    lo, hi = active_range(rt, n, active_lo, active_hi)
    return CaRegs(
        log2w=log2w, guard=guard, div_sum=int(rt.div_sum),
        cfar_mode=int(rt.cfar_mode), log_or_linear=int(rt.log_or_linear),
        peak_grouping=int(rt.peak_grouping), active_lo=lo, active_hi=hi,
        mag_mode=min(max(int(rt.mag_mode), 0), 3),
        scaler=float(rt.threshold_scaler))


def gos_registers(rt: RuntimeConfig, cfg: CfarConfig, n: int,
                  active_lo: Optional[int] = None,
                  active_hi: Optional[int] = None) -> GosRegs:
    """The GOSCA kernels' register struct, clamped on the host as
    ``fused_mag_gos_cfar`` clamps its scalars (the active range of
    ``active_range``), with the elaboration resolved
    as ``ops.cfar.cfar_op`` resolves it: the mode clipped to 0..3 and CASH
    degraded to CA where it is not elaborated, the algorithm 1 for a pure-GOS
    elaboration whatever the register holds, the ranks clamped to
    ``[0, max_ref_window)``."""
    log2w, guard = window_registers(rt, cfg)
    lo, hi = active_range(rt, n, active_lo, active_hi)
    wmax = cfg.max_ref_window

    def clamp(v, lo, hi):
        return min(max(int(v), lo), hi)

    return GosRegs(
        log2w=log2w, guard=guard, div_sum=int(rt.div_sum),
        cfar_mode=effective_mode(rt, cfg), log_or_linear=int(rt.log_or_linear),
        peak_grouping=int(rt.peak_grouping), active_hi=hi,
        mag_mode=clamp(rt.mag_mode, 0, 3),
        algorithm=effective_algorithm(rt, cfg),
        rank_lagg=clamp(rt.index_lagg, 0, wmax - 1),
        rank_lead=clamp(rt.index_lead, 0, wmax - 1),
        sub_w=clamp(rt.sub_window_size, cfg.min_sub_window, wmax),
        active_lo=lo, scaler=float(rt.threshold_scaler))


def takes_plain_path(x: C, name: str) -> bool:
    """True for CPU tensors (the plain version runs), False for CUDA tensors
    (the kernel launches); other devices raise."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, not {x.device}")
    return False


def check_cuda_operands(*tensors: torch.Tensor,
                        dtype: torch.dtype = torch.float32) -> None:
    """The kernels take contiguous planes of one dtype and shape on one
    card."""
    first = tensors[0]
    for t in tensors:
        if t.device != first.device or t.dtype != dtype:
            raise ValueError(f"kernel operands must be {dtype} on one device, "
                             f"got {t.dtype} on {t.device}")
        if t.shape != first.shape or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous and of one "
                             "shape")


@functools.lru_cache(maxsize=None)
def entry(symbol: str, *argtypes, pointers: int = 4) -> Callable[..., int]:
    """The library's C entry ``symbol``. Every entry takes ``pointers``
    device pointers (``(re, im, thr, peaks)``, or ``(words, out)`` for the
    wire kernel), the frame count and the stream, then the kernel arguments,
    whose types are ``argtypes``, and returns ``cudaGetLastError()``."""
    fn = getattr(_build.library(), symbol)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int,
                                                  ctypes.c_void_p, *argtypes]
    fn.restype = ctypes.c_int
    return fn


def call_entry(name: str, device: torch.device, fn: Callable[..., int],
               head: tuple, tail: tuple) -> None:
    """Call the C entry ``fn(*head, stream, *tail)`` on the current stream of
    ``device``, raise if the launch failed, and count it and its host time
    under ``name``; where the port's spans are on, the call runs under the
    range ``rsp.launch.<name>``."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        with profiling.span(f"rsp.launch.{name}", profiling.SPANS):
            t0 = time.perf_counter()
            rc = fn(*head, stream, *tail)
            dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    _build.LAUNCHES[name] += 1
    _build.LAUNCH_S[name] += dt


def launch(name: str, x: C, fn: Callable[..., int], *args,
           dtype: torch.dtype = torch.float32,
           count: bool = False) -> CfarOutput:
    """Allocate threshold (of ``dtype``, the input planes' dtype) and peaks
    for the frames of ``x`` (CUDA; ``x.im`` may be None where the kernel
    reads one plane), launch the kernel through its C entry ``fn`` with the
    kernel arguments ``args`` on the current stream, and count the launch
    under ``name``. With ``count`` (an entry whose last argument is a
    counter, Kernels D and G) the entry also gets an int64 counter, which the
    output carries as ``detections``."""
    check_cuda_operands(*(t for t in x if t is not None), dtype=dtype)
    thr = torch.empty(x.shape, dtype=dtype, device=x.device)
    pk = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    frames = x.re.numel() // x.shape[-1]
    det = None
    if frames:
        if count:
            det = torch.empty((), dtype=torch.int64, device=x.device)
            args += (det.data_ptr(),)
        call_entry(name, x.device, fn,
                   (x.re.data_ptr(), None if x.im is None else x.im.data_ptr(),
                    thr.data_ptr(), pk.data_ptr(), frames), args)
    return CfarOutput(threshold=thr, peaks=pk.view(torch.bool),
                      detections=det)


def _tail_input(spectrum, mag_given: bool) -> C:
    """The spectrum as a pair, or with ``mag_given`` the magnitude (a real
    tensor) as the pair ``C(mag, None)``."""
    if not mag_given:
        return as_pair(spectrum)
    if not isinstance(spectrum, torch.Tensor) or spectrum.is_complex():
        raise ValueError("with mag_given the input is the magnitude, a real "
                         "tensor")
    return C(spectrum, None)


def _aligned(x: C) -> C:
    """``x`` with each contiguous plane 16-byte aligned, as the float4 loads
    of Kernel B need: a plane that is not (a view at an odd offset) is
    copied."""
    return C(*(t.clone() if t is not None and t.is_contiguous()
               and t.data_ptr() % 16 else t for t in x))


def mag_cfar_reference(spectrum: CLike, rt: RuntimeConfig, cfg: CfarConfig,
                       *, active_lo: Optional[int] = None,
                       active_hi: Optional[int] = None,
                       mag_given: bool = False) -> CfarOutput:
    """The plain PyTorch version of ``mag_cfar`` and ``mag_gos_cfar``,
    composed from the ops."""
    mag = (_tail_input(spectrum, True).re.float() if mag_given
           else logmag(spectrum, rt.mag_mode))
    return cfar_op(mag, rt, cfg, active_lo=active_lo, active_hi=active_hi)


def mag_cfar(spectrum: CLike, rt: RuntimeConfig, cfg: CfarConfig, *,
             active_lo: Optional[int] = None, active_hi: Optional[int] = None,
             mag_given: bool = False) -> CfarOutput:
    """Magnitude + CA-family CFAR over the last axis of a spectrum
    ``[..., N]``, N a multiple of 128. Returns threshold float32 and peaks
    bool."""
    sp = _tail_input(spectrum, mag_given)
    n = sp.shape[-1]
    if n % 128:
        raise ValueError(f"frame length {n} is not a multiple of 128")
    check_window_bounds(cfg)
    if takes_plain_path(sp, "mag_cfar"):
        return mag_cfar_reference(sp.re if mag_given else sp, rt, cfg,
                                  active_lo=active_lo, active_hi=active_hi,
                                  mag_given=mag_given)
    return launch("mag_cfar", _aligned(sp),
                  entry("rsp_mag_cfar", ctypes.c_int, CaRegs, ctypes.c_int),
                  n, ca_registers(rt, cfg, n, active_lo, active_hi),
                  int(mag_given))


# The plain ops carry every CFAR variant, so Kernel C's plain version is
# Kernel B's.
mag_gos_cfar_reference = mag_cfar_reference


def mag_gos_cfar(spectrum: CLike, rt: RuntimeConfig, cfg: CfarConfig, *,
                 active_lo: Optional[int] = None,
                 active_hi: Optional[int] = None,
                 mag_given: bool = False) -> CfarOutput:
    """Magnitude + GOS / GOSCA / CASH CFAR (and the CA statistics a GOSCA
    elaboration selects at runtime) over the last axis of a spectrum
    ``[..., N]``, N a multiple of 256. Returns threshold float32 and peaks
    bool."""
    sp = _tail_input(spectrum, mag_given)
    n = sp.shape[-1]
    if n % GOS_TILE:
        raise ValueError(f"frame length {n} is not a multiple of {GOS_TILE}")
    check_window_bounds(cfg)
    if takes_plain_path(sp, "mag_gos_cfar"):
        return mag_gos_cfar_reference(sp.re if mag_given else sp, rt, cfg,
                                      active_lo=active_lo,
                                      active_hi=active_hi,
                                      mag_given=mag_given)
    return launch("mag_gos_cfar", sp,
                  entry("rsp_mag_gos_cfar", ctypes.c_int, GosRegs,
                        ctypes.c_int),
                  n, gos_registers(rt, cfg, n, active_lo, active_hi),
                  int(mag_given))


def fused_mag_gos_dispatch(spectrum: CLike, rt: RuntimeConfig,
                           cfg: CfarConfig, **tail) -> CfarOutput:
    """The GOSCA tail stage: CA-like registers (``ca_like``) take
    ``mag_cfar``, the rest ``mag_gos_cfar``, each with the keyword arguments
    ``tail`` (``active_lo``, ``active_hi``, ``mag_given``). The choice is a
    host ``if`` on registers, which are host values."""
    if ca_like(rt, cfg):
        return mag_cfar(spectrum, rt, cfg, **tail)
    return mag_gos_cfar(spectrum, rt, cfg, **tail)
