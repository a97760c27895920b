"""The bit-true integer whole-chain kernels and the bit-true chain stage.

* Kernel F, ``chain_int``: integer FFT + magnitude (modes 0-2) + integer
  CA/GO/SO CFAR. Replaces
  ``rsp_chains_tpu/kernels/int_chain_pallas.py::fused_chain_int`` (:441,
  ``pallas_call`` :512). Three routes, chosen here by N alone, all giving
  the same integers: frames of ``ROW_SIZES`` (256-1024) take the row plan in
  registers (``csrc/chain_int.cu`` with ``csrc/int_rows.cuh``, entry
  ``rsp_chain_int_rows``, counted as ``chain_int``), frames of 2048 up to
  ``2**MAX_LOG2N`` the mid-size route, longer ones the split route.
* Kernel G, ``chain_int_gos``: the same front + an integer CA / GOS tail
  muxed by the algorithm register. Replaces
  ``int_chain_pallas.py::fused_chain_int_gos`` (:552, ``pallas_call`` :622),
  on the same three routes as F: frames of ``ROW_SIZES`` on F's row plan
  (``csrc/chain_int_gos.cu``, entry ``rsp_chain_int_gos_rows``, the
  selection over the block's frames of ``csrc/gos_rows.cuh``, counted as
  ``chain_int_gos``; it also counts the peaks, ``CfarOutput.detections``),
  then the mid-size and the split routes.
* The mid-size route of F and G for frames of 2048 ... 16384 (CUDA source
  ``csrc/int_mid.cu``, entry ``rsp_int_mid``, counted as ``chain_int_mid``
  and ``chain_int_gos_mid``): one launch; a block of 1024 threads holds
  8192 cells in registers on the split route's body (1, 2 or 4 whole
  frames, or at N = 16384 half a frame, two blocks of a thread-block
  cluster a frame), stores each bin's magnitude in a row in shared memory
  and runs F's run-sum CA or G's rank statistics over it.
* The split route of F and G for frames of N > ``2**MAX_LOG2N`` (CUDA source
  ``csrc/int_split.cu``, entry ``rsp_int_split``, counted as
  ``chain_int_split`` and ``chain_int_gos_split``): head launches run the
  first L - 13 FFT stages on groups of cells in registers (up to five
  stages a launch), a body launch the last 13 on each sub-frame of 8192
  cells on F's register row plan and stores each sub-frame's magnitudes as
  one contiguous run, a tail launch F's run-sum CA or G's rank statistics
  over tiles of 4096 cells read back from those runs; 12 bytes a sample of
  scratch, allocated a call.
* ``int_chain_fusable`` and ``fused_chain_int_op``, the ports of
  ``int_chain_pallas.py:660-686`` and ``:689-779``: host ``if``s on the
  registers choose Kernel F, Kernel G or the integer ops
  (``ops.bit_true``), which carry the LUT log2, CASH, a shrunken FFT size
  and pure-GOS elaborations.

Both kernels are exact: their plain versions (``chain_int_reference``,
``chain_int_gos_reference``) are the integer ops, and the card's output
equals them bit for bit. A wrapper launches its kernel for CUDA tensors and
uses the plain version only for CPU tensors. The registers are host values
passed by value (``IntRegs``), the FFT's elaboration flags (expanding and
keepLSB stages) as two bit masks, so no register write rebuilds a kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..configs import (
    CfarConfig, CfarVariant, ChainConfig, EdgePolicy, FftConfig, RuntimeConfig,
)
from ..cplx import C, CLike, as_pair
from ..ops.bit_true import (
    MAX_EXPANDING, ca_cfar_int, cfar_int, check_expanding, div_shift,
    fft_int_op, int_scaler, mag_int_op, stage_twiddles,
)
from ..ops.cfar import CfarOutput, effective_algorithm, window_registers
from .cfar import MAX_LOG2_W, PAD, check_window_bounds, entry, launch, takes_plain_path
from .chain import FUSABLE_SIZES

MAX_LOG2N = 14    # the mid-size route's bound: at N = 16384 a frame fills
                  # two blocks of 1024 threads, 8 cells a thread in
                  # registers; longer frames take the split route
                  # (csrc/int_split.cu)
MAX_LOG2N_SPLIT = 30    # the split route's bound (int32 cell indices)
OPS_CELLS = 512 * 1024  # cells a call of the plain versions (window stacks)
ROW_SIZES = FUSABLE_SIZES   # the row-plan route of Kernels F and G


class IntRegs(ctypes.Structure):
    """``RspIntRegs`` of ``csrc/int_front.cuh``, field for field."""

    _fields_ = [("log2w", ctypes.c_int), ("guard", ctypes.c_int),
                ("div_sum", ctypes.c_int), ("cfar_mode", ctypes.c_int),
                ("log_or_linear", ctypes.c_int),
                ("peak_grouping", ctypes.c_int), ("n_active", ctypes.c_int),
                ("mag_mode", ctypes.c_int), ("scaler_q", ctypes.c_int),
                ("scaler_add", ctypes.c_int), ("algorithm", ctypes.c_int),
                ("rank_lagg", ctypes.c_int), ("rank_lead", ctypes.c_int)]


def _int32(v) -> int:
    return min(max(int(v), -(2**31)), 2**31 - 1)


def int_registers(rt: RuntimeConfig, cfg: CfarConfig, n: int) -> IntRegs:
    """The integer kernels' register struct, clamped on the host as the
    integer ops read the registers: the window and guard as ``ops.cfar``
    clamps them, ``divSum`` outside [0, 31] as 31 (XLA fills with the sign
    bit), the scaler rounded half to even, the magnitude mode clipped to
    0..3, the elaboration resolved (``effective_algorithm``), the ranks
    clamped to ``[0, max_ref_window)``; the mode register raw."""
    log2w, guard = window_registers(rt, cfg)
    q, add = int_scaler(rt.threshold_scaler)

    def rank(v):
        return min(max(int(v), 0), cfg.max_ref_window - 1)

    return IntRegs(
        log2w=log2w, guard=guard, div_sum=div_shift(rt.div_sum),
        cfar_mode=_int32(rt.cfar_mode), log_or_linear=_int32(rt.log_or_linear),
        peak_grouping=_int32(rt.peak_grouping),
        n_active=_int32(min(int(rt.cfar_fft_size), n)),
        mag_mode=min(max(int(rt.mag_mode), 0), 3), scaler_q=q,
        scaler_add=add, algorithm=effective_algorithm(rt, cfg),
        rank_lagg=rank(rt.index_lagg), rank_lead=rank(rt.index_lead))


def fft_masks(fft_cfg: FftConfig, n: int) -> tuple[int, int]:
    """(expanding stages, keepLSB stages) of the first log2(n) stages as bit
    masks, bit s for stage s."""
    el, km = fft_cfg.expand_logic, fft_cfg.keep_msb_or_lsb
    stages = range(n.bit_length() - 1)
    expand = sum(1 << s for s in stages if el is not None and el[s])
    lsb = sum(1 << s for s in stages if km is not None and not km[s])
    return expand, lsb


@functools.lru_cache(maxsize=None)
def _int_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """[n, 2] int32: row h + j holds the 1.15 twiddle (cos, sin) of
    W_{2h}^j, j < h, for each half-block h = n/2, n/4, ..., 1 (the b-lane
    values of ``stage_twiddles``)."""
    stages, _ = stage_twiddles(n)
    tab = np.zeros((n, 2), np.int32)
    for s, (wr, wi) in enumerate(stages):
        half = n >> (s + 1)
        tab[half:2 * half, 0] = wr[half:2 * half]
        tab[half:2 * half, 1] = wi[half:2 * half]
    return torch.from_numpy(tab).to(device)


def _check_operands(name: str, n: int, rt: RuntimeConfig, fft_cfg: FftConfig,
                    cfar_cfg: CfarConfig, gos: bool) -> None:
    if (n != fft_cfg.max_size or n & (n - 1)
            or not 256 <= n <= 1 << MAX_LOG2N_SPLIT):
        raise ValueError(f"{name} takes frames of max_size, a power of two in "
                         f"[256, {1 << MAX_LOG2N_SPLIT}], got {n} (max_size "
                         f"{fft_cfg.max_size})")
    check_window_bounds(cfar_cfg)
    check_expanding(fft_cfg.expand_logic)
    if min(max(int(rt.mag_mode), 0), 3) == 3:
        raise ValueError(f"{name} computes magnitude modes 0-2; the LUT log2 "
                         "runs on the integer ops (fused_chain_int_op)")
    if gos and int(rt.cfar_mode) == 3 and cfar_cfg.include_cash:
        raise ValueError(f"{name} has no CASH datapath; the CASH mode runs "
                         "on the integer ops (fused_chain_int_op)")


def _by_cells(fn, x: CLike) -> CfarOutput:
    """``fn`` over chunks of whole frames of ``x``, about ``OPS_CELLS`` cells
    (one frame at least) a call, outputs concatenated: the integer ops'
    window stacks take ~2 KB a cell at max_ref_window 64
    (``int_chain_pallas.py:710-741``)."""
    xp = x if isinstance(x, C) else as_pair(x)
    n = xp.shape[-1]
    re, im = xp.re.reshape(-1, n), xp.im.reshape(-1, n)
    step = max(1, OPS_CELLS // n)
    outs = [fn(C(re[k:k + step], im[k:k + step]))
            for k in range(0, max(re.shape[0], 1), step)]
    return CfarOutput(
        threshold=torch.cat([o.threshold for o in outs]).reshape(xp.shape),
        peaks=torch.cat([o.peaks for o in outs]).reshape(xp.shape))


def chain_int_reference(x: CLike, rt: RuntimeConfig, fft_cfg: FftConfig,
                        cfar_cfg: CfarConfig) -> CfarOutput:
    """The plain PyTorch version of ``chain_int``: the full-size
    ``fft_int_op``, ``mag_int_op`` and ``ca_cfar_int``, by ``_by_cells``."""
    return _by_cells(lambda c: ca_cfar_int(
        mag_int_op(fft_int_op(c, None, fft_cfg), rt.mag_mode), rt, cfar_cfg),
        x)


def chain_int_gos_reference(x: CLike, rt: RuntimeConfig, fft_cfg: FftConfig,
                            cfar_cfg: CfarConfig) -> CfarOutput:
    """The plain PyTorch version of ``chain_int_gos``: the full-size
    ``fft_int_op``, ``mag_int_op`` and ``cfar_int``, by ``_by_cells``."""
    return _by_cells(lambda c: cfar_int(
        mag_int_op(fft_int_op(c, None, fft_cfg), rt.mag_mode), rt, cfar_cfg),
        x)


def _int_kernel(name: str, symbol: str, x: C, regs: IntRegs,
                fft_cfg: FftConfig, count: bool = False) -> CfarOutput:
    """Launch the integer whole-chain entry ``symbol`` (the row plan's or
    the mid-size route's) over the CUDA frames ``x`` with the register
    struct ``regs``, counted under ``name``; with ``count``, an entry that
    counts the peaks (Kernel G's row plan, ``launch``)."""
    n = x.shape[-1]
    xi = C(x.re.to(torch.int32).contiguous(), x.im.to(torch.int32).contiguous())
    expand, lsb = fft_masks(fft_cfg, n)
    fn = entry(symbol, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, IntRegs, *([ctypes.c_void_p] if count else []))
    return launch(name, xi, fn, _int_twiddles(n, x.device).data_ptr(),
                  n.bit_length() - 1, expand, lsb, regs, dtype=torch.int32,
                  count=count)


def _split_kernel(name: str, x: C, regs: IntRegs,
                  fft_cfg: FftConfig) -> CfarOutput:
    """Launch the split route (``csrc/int_split.cu``) over the CUDA frames
    ``x`` of N > ``2**MAX_LOG2N`` with the register struct ``regs``, whose
    algorithm register picks F's CA sums (0) or G's rank statistics (1);
    the 12 bytes a sample of scratch live for the call."""
    n = x.shape[-1]
    xi = C(x.re.to(torch.int32).contiguous(), x.im.to(torch.int32).contiguous())
    expand, lsb = fft_masks(fft_cfg, n)
    scratch = torch.empty(3 * xi.re.numel(), dtype=torch.int32,
                          device=x.device)
    fn = entry("rsp_int_split", ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, IntRegs, ctypes.c_void_p)
    return launch(name, xi, fn, _int_twiddles(n, x.device).data_ptr(),
                  n.bit_length() - 1, expand, lsb, regs, scratch.data_ptr(),
                  dtype=torch.int32)


def _route(x: C, regs: IntRegs, fft_cfg: FftConfig,
           gos: bool) -> CfarOutput:
    """Kernel F (``gos`` False) or G over the CUDA frames ``x`` on the route
    of their N: the row plan, the mid-size route or the split route. G's
    row plan counts the peaks."""
    n = x.shape[-1]
    suffix = "_gos" if gos else ""
    if n in ROW_SIZES:
        return _int_kernel(f"chain_int{suffix}",
                           f"rsp_chain_int{suffix}_rows", x, regs, fft_cfg,
                           gos)
    if n <= 1 << MAX_LOG2N:
        return _int_kernel(f"chain_int{suffix}_mid", "rsp_int_mid", x, regs,
                           fft_cfg)
    return _split_kernel(f"chain_int{suffix}_split", x, regs, fft_cfg)


def chain_int(x: CLike, rt: RuntimeConfig, fft_cfg: FftConfig,
              cfar_cfg: CfarConfig) -> CfarOutput:
    """Bit-true integer FFT + magnitude (modes 0-2) + integer CA/GO/SO CFAR
    at the full elaborated FFT size over 16-bit integer IQ frames ``[..., N]``
    (an int32 or integer-valued float ``C``), N = ``fft_cfg.max_size`` a power
    of two >= 256. Returns an int32 threshold and bool peaks."""
    xp = x if isinstance(x, C) else as_pair(x)
    n = xp.shape[-1]
    _check_operands("chain_int", n, rt, fft_cfg, cfar_cfg, False)
    if takes_plain_path(xp, "chain_int"):
        return chain_int_reference(xp, rt, fft_cfg, cfar_cfg)
    regs = int_registers(rt, cfar_cfg, n)
    regs.algorithm = 0
    return _route(xp, regs, fft_cfg, False)


def chain_int_gos(x: CLike, rt: RuntimeConfig, fft_cfg: FftConfig,
                  cfar_cfg: CfarConfig) -> CfarOutput:
    """Bit-true integer FFT + magnitude (modes 0-2) + integer CA or GOS CFAR
    (the algorithm register of a GOSCA elaboration) at the full elaborated
    FFT size, frames as ``chain_int``'s. The CASH mode is refused: it runs on
    the integer ops. Returns an int32 threshold, bool peaks and, from the
    row plan's kernel (N <= 1024), the number of peaks (``detections``)."""
    xp = x if isinstance(x, C) else as_pair(x)
    n = xp.shape[-1]
    _check_operands("chain_int_gos", n, rt, fft_cfg, cfar_cfg, True)
    if takes_plain_path(xp, "chain_int_gos"):
        return chain_int_gos_reference(xp, rt, fft_cfg, cfar_cfg)
    return _route(xp, int_registers(rt, cfar_cfg, n), fft_cfg, True)


def int_ops_chain(x: CLike, rt: RuntimeConfig, cfg: ChainConfig) -> CfarOutput:
    """The integer ops, ``fft_int_op`` -> ``mag_int_op`` -> ``cfar_int``, by
    ``_by_cells``."""
    return _by_cells(lambda c: cfar_int(mag_int_op(
        fft_int_op(c, rt.log2_fft_size, cfg.fft), rt.mag_mode, cfg.mag), rt,
        cfg.cfar), x)


def int_chain_fusable(cfg: ChainConfig) -> bool:
    """Whether a bit-true elaboration takes the fused integer stage, the JAX
    package's gate: PARTIAL edges, plain outputs, natural output order, a
    power-of-two frame >= 256, kernel-sized windows, <= 7 expanding stages,
    and a CA or GOSCA variant (a pure-GOS elaboration has no CA datapath)."""
    cfar = cfg.cfar
    n = cfg.fft.max_size
    el = cfg.fft.expand_logic
    return (
        cfar.use_pallas
        and not (cfar.send_cut or cfar.emit_noise)
        and cfar.edge_policy is EdgePolicy.PARTIAL
        and cfg.fft.use_bit_reverse
        and n % 128 == 0 and n & (n - 1) == 0 and n >= 256
        and cfar.max_ref_window <= 1 << MAX_LOG2_W
        and cfar.max_ref_window + cfar.max_guard_window + 1 <= PAD
        and (el is None or sum(1 for e in el if e) <= MAX_EXPANDING)
        and cfar.variant in (CfarVariant.CA, CfarVariant.GOSCA)
    )


def fused_chain_int_op(x: CLike, rt: RuntimeConfig,
                       cfg: ChainConfig) -> CfarOutput:
    """The bit-true chain stage over the whole register surface, host
    ``if``s on the registers: at the full FFT size and a magnitude mode
    below 3, CA-like registers run Kernel F and the GOS registers of a GOSCA
    elaboration Kernel G; the LUT log2, the CASH mode, a shrunken FFT size
    and a pure-GOS elaboration run the integer ops. Every route gives the
    same integers, at every power-of-two frame >= 256 that
    ``int_chain_fusable`` passes."""
    xp = x if isinstance(x, C) else as_pair(x)
    fft_cfg, cfar_cfg = cfg.fft, cfg.cfar
    if cfar_cfg.variant is CfarVariant.GOS:
        return int_ops_chain(xp, rt, cfg)
    mode, algorithm = int(rt.cfar_mode), int(rt.cfar_algorithm)
    cash = cfar_cfg.include_cash and mode == 3
    gosca = cfar_cfg.variant is CfarVariant.GOSCA
    kernel_sized = (int(rt.mag_mode) < 3 and not cash
                    and (not fft_cfg.runtime_size
                         or rt.log2_fft_size >= fft_cfg.log2_max))
    if kernel_sized and (not gosca or algorithm == 0):
        return chain_int(xp, rt, fft_cfg, cfar_cfg)
    if kernel_sized and gosca and algorithm == 1:
        return chain_int_gos(xp, rt, fft_cfg, cfar_cfg)
    return int_ops_chain(xp, rt, cfg)
