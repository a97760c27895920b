"""Kernel B, ``mag_cfar``: magnitude + CA/GO/SO CFAR on a spectrum.

Replaces ``rsp_chains_tpu/kernels/cfar_pallas.py::fused_mag_cfar`` (:489,
``pallas_call`` :555). The CUDA source is ``csrc/mag_cfar.cu``, with the
shared device functions in ``csrc/ca_cfar.cuh``; that file says what bounds the
kernel on the H100 and how its design answers. The kernel moves 13 bytes per
complex sample: 8 in, 4 + 1 out.

``mag_cfar`` launches the kernel for CUDA tensors and uses the plain version,
``mag_cfar_reference``, only for CPU tensors. Registers are host values passed
by value at launch (``CaRegs``), so a register write costs no device sync and
no rebuild.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..configs import ChainConfig, CfarConfig, CfarVariant, EdgePolicy, RuntimeConfig
from ..cplx import CLike, as_pair
from ..ops.cfar import CfarOutput, cfar_op, window_registers
from ..ops.logmag import logmag
from . import _build

MAX_LOG2_W = 6   # the kernels' window bound, as in cfar_pallas.MAX_LOG2_W
PAD = 128        # csrc/ca_cfar.cuh RSP_PAD: zero margin each side of the row

# Launches of the CUDA kernel in this process; the plain path never adds.
LAUNCHES = 0


class CaRegs(ctypes.Structure):
    """``RspCaRegs`` of ``csrc/ca_cfar.cuh``, field for field."""

    _fields_ = [("log2w", ctypes.c_int), ("guard", ctypes.c_int),
                ("div_sum", ctypes.c_int), ("cfar_mode", ctypes.c_int),
                ("log_or_linear", ctypes.c_int),
                ("peak_grouping", ctypes.c_int), ("active_lo", ctypes.c_int),
                ("active_hi", ctypes.c_int), ("mag_mode", ctypes.c_int),
                ("scaler", ctypes.c_float)]


def fused_tail_kind(chain_cfg: ChainConfig) -> Optional[str]:
    """``"ca"`` when the CA kernels carry this elaboration's semantics, else
    None (the plain ops). The same gate as the JAX package's
    ``cfar_pallas.fused_tail_kind`` (:1784) for CA elaborations; GOS variants
    are refused earlier (``ops.cfar.require_ca_family``)."""
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
    return None


def check_window_bounds(cfg: CfarConfig) -> None:
    if cfg.max_ref_window > 1 << MAX_LOG2_W:
        raise ValueError(f"max_ref_window {cfg.max_ref_window} exceeds the "
                         f"kernels' {1 << MAX_LOG2_W}")
    if cfg.max_ref_window + cfg.max_guard_window + 1 > PAD:
        raise ValueError("max_ref_window + max_guard_window + 1 exceeds the "
                         f"kernels' {PAD}-cell margin")


def ca_registers(rt: RuntimeConfig, cfg: CfarConfig, n: int) -> CaRegs:
    """The kernels' register struct, clamped on the host as
    ``chain_pallas._chain_scalars`` (:817) clamps it: the active range is
    ``[0, min(cfar_fft_size, n))``.

    ``mag_mode`` is clipped to 0..3 as the JAX package's ``ops.logmag`` clips
    it, so a code above 3 gives LOG2. The Pallas kernels' ``_magnitude`` passes
    such a code through as the raw real part instead; the port follows the
    plain op."""
    log2w, guard = window_registers(rt, cfg)
    return CaRegs(
        log2w=log2w, guard=guard, div_sum=int(rt.div_sum),
        cfar_mode=int(rt.cfar_mode), log_or_linear=int(rt.log_or_linear),
        peak_grouping=int(rt.peak_grouping),
        active_lo=0, active_hi=max(min(int(rt.cfar_fft_size), n), 0),
        mag_mode=min(max(int(rt.mag_mode), 0), 3),
        scaler=float(rt.threshold_scaler))


def check_cuda_operands(*tensors: torch.Tensor) -> None:
    """The kernels take contiguous float32 planes of one shape on one card."""
    first = tensors[0]
    for t in tensors:
        if t.device != first.device or t.dtype != torch.float32:
            raise ValueError("kernel operands must be float32 on one device, "
                             f"got {t.dtype} on {t.device}")
        if t.shape != first.shape or not t.is_contiguous():
            raise ValueError("kernel operands must be contiguous and of one "
                             "shape")


def launch_stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def check_launch(name: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


@functools.lru_cache(maxsize=1)
def _entry():
    fn = _build.library().rsp_mag_cfar
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, CaRegs,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mag_cfar_reference(spectrum: CLike, rt: RuntimeConfig,
                       cfg: CfarConfig) -> CfarOutput:
    """The plain PyTorch version of ``mag_cfar``, composed from the ops."""
    return cfar_op(logmag(spectrum, rt.mag_mode), rt, cfg)


def mag_cfar(spectrum: CLike, rt: RuntimeConfig, cfg: CfarConfig) -> CfarOutput:
    """Magnitude + CA-family CFAR over the last axis of a spectrum
    ``[..., N]``, N a multiple of 128. Returns threshold float32 and peaks
    bool."""
    global LAUNCHES
    sp = as_pair(spectrum)
    n = sp.shape[-1]
    if n % 128:
        raise ValueError(f"frame length {n} is not a multiple of 128")
    check_window_bounds(cfg)
    if sp.device.type == "cpu":
        return mag_cfar_reference(sp, rt, cfg)
    if sp.device.type != "cuda":
        raise ValueError(f"mag_cfar takes CPU or CUDA tensors, not {sp.device}")
    check_cuda_operands(sp.re, sp.im)
    regs = ca_registers(rt, cfg, n)
    thr = torch.empty(sp.shape, dtype=torch.float32, device=sp.device)
    pk = torch.empty(sp.shape, dtype=torch.uint8, device=sp.device)
    frames = sp.re.numel() // n
    if frames:
        with torch.cuda.device(sp.device):
            rc = _entry()(sp.re.data_ptr(), sp.im.data_ptr(), thr.data_ptr(),
                          pk.data_ptr(), frames, n, regs,
                          launch_stream(sp.device))
        check_launch("mag_cfar", rc)
        LAUNCHES += 1
    return CfarOutput(threshold=thr, peaks=pk.view(torch.bool))
