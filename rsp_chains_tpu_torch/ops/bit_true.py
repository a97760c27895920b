"""The bit-true integer chain, the port of ``rsp_chains_tpu.ops.bit_true``:
exact 16-bit fixed-point stream emulation in int32 tensors.

The arithmetic contract is the JAX package's (its module docstring gives
the spec and its provenance in the reference):

* **FFT**: radix-2 DIF, natural order in, bit-reversed out, then the final
  reorder. Stage s on blocks of m = N >> s: ``y[j] = x[j] + x[j + m/2]``,
  ``y[j + m/2] = x[j] - x[j + m/2]``; on a non-expanding stage the keepMSB
  halving ``(v + 1) >> 1`` (or, on a keepLSB stage, the 16-bit wraparound
  trim) before the twiddle; the twiddle ``W_m^j`` in 1.15 fixed point, the
  product rounded ``(p + 2^14) >> 15``. Once a stage has expanded, the
  product takes the 8-bit split form ``_rhu15_wide``.
* **Magnitudes**: exact integer sqrt of the saturating square sum (0), the
  saturating square sum (1), the JPL shift-add form (2), the LUT log2 of the
  JPL magnitude on the protoLog grid (3).
* **CFAR**: integer window sums; per side ``sum >> divSum`` (arithmetic);
  the noise ``(lag + lead) >> 1``, max or min; GOS rank select over the valid
  window cells; CASH min sub-window sum divided once (floor) by the
  sub-window; linear threshold ``(noise * round(scaler * 64) + 32) >> 6``,
  log-domain ``noise + round(scaler)``. PARTIAL edges.

Integer overflow is part of the contract: XLA's int32 wraps, so every sum
and product here stays in int32 and wraps the same way (the CA window sums
of large squared magnitudes, ``noise * scaler_q``, ``(lag + lead) >> 1``).
A shift by ``divSum`` outside [0, 31] fills with the sign bit, as XLA's
shift does. The scaler is rounded half to even on the host, as
``jnp.round`` rounds it.

The registers are host values, so only the datapath they select is
computed; the JAX package traces every elaborated datapath and selects.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..configs import (
    CfarConfig, CfarVariant, EdgePolicy, FftConfig, LogMagConfig, RuntimeConfig,
)
from ..cplx import C, as_pair
from .cfar import CfarOutput, ca_window_sums, gather_windows, window_registers
from .fft import transform_size

INT_MAX = 2**31 - 1
MAX_EXPANDING = 7   # the split-product twiddle stays int32-exact up to here
PEAK_EDGE = -(1 << 30)  # a missing neighbour in peak grouping


def rhu(v, k: int):
    """Round-half-up arithmetic right shift: floor((v + 2^(k-1)) / 2^k)."""
    if k == 0:
        return v
    return (v + (1 << (k - 1))) >> k


def wrap16(v):
    """Trim to the 16-bit two's-complement grid with wraparound overflow (the
    keepMSBorLSB = LSB stage trim)."""
    return ((v + 32768) & 0xFFFF) - 32768


@functools.lru_cache(maxsize=None)
def stage_twiddles(n: int):
    """Per-stage 1.15 fixed-point twiddle lane vectors of the radix-2 DIF
    pipeline (lanes on the 'a' half of a butterfly get exact unity, 2^15) and
    the final bit-reversal permutation, numpy int32."""
    p = n.bit_length() - 1
    i = np.arange(n)
    stages = []
    for s in range(p):
        m = n >> s
        half = m >> 1
        j = i & (half - 1)
        w = np.exp(-2j * np.pi * j / m)
        wr = np.round(w.real * 32768.0).astype(np.int64)
        wi = np.round(w.imag * 32768.0).astype(np.int64)
        b_lane = (i & half) != 0
        wr = np.where(b_lane, wr, 32768)
        wi = np.where(b_lane, wi, 0)
        stages.append((wr.astype(np.int32), wi.astype(np.int32)))
    rev = np.zeros(n, np.int64)
    for b in range(p):
        rev |= ((i >> b) & 1) << (p - 1 - b)
    return stages, rev


@functools.lru_cache(maxsize=None)
def _stage_tensors(n: int, device: torch.device):
    stages, rev = stage_twiddles(n)
    tw = [(torch.from_numpy(wr).to(device), torch.from_numpy(wi).to(device))
          for wr, wi in stages]
    return tw, torch.from_numpy(rev).to(device)


def check_expanding(expand_logic: Optional[tuple]) -> None:
    if expand_logic is not None and sum(1 for e in expand_logic if e) > MAX_EXPANDING:
        raise ValueError("bit-true FFT supports at most "
                         f"{MAX_EXPANDING} expanding stages")


def _rhu15_wide(a, b, wa, wb):
    """``rhu(a*wa + b*wb, 15)`` exactly in int32 for data wider than 16 bits:
    an 8-bit split of the data keeps every partial product within int32, and
    floor((H*2^8 + T)/2^15) = floor((H + floor(T/2^8))/2^7)."""
    al = a & 255
    ah = (a - al) >> 8
    bl = b & 255
    bh = (b - bl) >> 8
    h = ah * wa + bh * wb
    t = al * wa + bl * wb + (1 << 14)
    return (h + (t >> 8)) >> 7


def _fft_int_fixed(xr: torch.Tensor, xi: torch.Tensor, n: int,
                   expand_logic: Optional[tuple],
                   keep_msb: Optional[tuple] = None):
    """The integer FFT of int32 frames ``[..., n]``; returns the int32 pair
    in natural order. ``keep_msb[s]`` False makes stage s a keepLSB stage
    (wraparound trim before the twiddle and after it)."""
    check_expanding(expand_logic)
    tw, rev = _stage_tensors(n, xr.device)
    batch = xr.shape[:-1]
    grown = 0
    for s, (wr, wi) in enumerate(tw):
        half = (n >> s) >> 1

        def butterfly(v):
            v = v.reshape(*batch, n // (2 * half), 2, half)
            a, b = v[..., 0, :], v[..., 1, :]
            return torch.stack([a + b, a - b], dim=-2).reshape(*batch, n)

        sr, si = butterfly(xr), butterfly(xi)
        lsb_stage = False
        expanding = expand_logic is not None and bool(expand_logic[s])
        if not expanding:
            if keep_msb is None or keep_msb[s]:
                sr, si = rhu(sr, 1), rhu(si, 1)
            else:
                sr, si = wrap16(sr), wrap16(si)
                lsb_stage = True
        if expanding:
            grown += 1
        if grown:
            xr = _rhu15_wide(sr, si, wr, -wi)
            xi = _rhu15_wide(sr, si, wi, wr)
        else:
            xr = rhu(sr * wr - si * wi, 15)
            xi = rhu(sr * wi + si * wr, 15)
        if lsb_stage:
            xr, xi = wrap16(xr), wrap16(xi)
    return xr[..., rev], xi[..., rev]


def fft_int_op(x, log2_fft_size: Optional[int] = None,
               cfg: FftConfig = FftConfig()) -> C:
    """The runtime-sized integer FFT stage over frames ``[..., max_size]`` of
    16-bit integers (an int32 or integer-valued float ``C`` pair, or a complex
    tensor): the first n = 2^clip(log2_fft_size) samples are transformed and
    bins >= n are zero. Returns an int32 ``C``."""
    xp = x if isinstance(x, C) else as_pair(x)
    if xp.shape[-1] != cfg.max_size:
        raise ValueError(f"frame length {xp.shape[-1]} != elaborated "
                         f"max_size {cfg.max_size}")
    n = transform_size(log2_fft_size, cfg)
    el, km = cfg.expand_logic, cfg.keep_msb_or_lsb
    yr, yi = _fft_int_fixed(
        xp.re.to(torch.int32)[..., :n], xp.im.to(torch.int32)[..., :n], n,
        None if el is None else tuple(el), None if km is None else tuple(km))
    pad = cfg.max_size - n
    if pad:
        yr, yi = F.pad(yr, (0, pad)), F.pad(yi, (0, pad))
    return C(yr, yi)


def jpl_mag_int(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Integer JPL magnitude, shift-add form with truncating shifts."""
    ar, ai = re.abs(), im.abs()
    u, v = torch.maximum(ar, ai), torch.minimum(ar, ai)
    return torch.maximum(u + (v >> 3), u - (u >> 3) + (v >> 1))


def sqr_mag_int(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """re^2 + im^2 in int32, saturated to int32 max where the sum wrapped."""
    s = re * re + im * im
    return torch.where(s < 0, INT_MAX, s)


def _isqrt32(x: torch.Tensor) -> torch.Tensor:
    """Exact floor(sqrt(x)) of int32 x >= 0: a float32 seed and integer
    corrections (``s > x // s`` so nothing overflows)."""
    s = torch.floor(torch.sqrt(x.clamp(min=0).to(torch.float32))).to(torch.int32)
    s = s.clamp(min=1)
    for _ in range(2):
        s = torch.where(s > torch.div(x, s, rounding_mode="floor"), s - 1, s)
        s = s.clamp(min=1)
    for _ in range(2):
        nxt = s + 1
        s = torch.where(nxt <= torch.div(x, nxt, rounding_mode="floor"), nxt, s)
    return torch.where(x <= 0, 0, s)


def abs_mag_int(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """floor(|re + j im|): the exact integer sqrt of the saturating square."""
    return _isqrt32(sqr_mag_int(re, im))


@functools.lru_cache(maxsize=None)
def _log2_frac_lut(width: int) -> np.ndarray:
    """Entry k = floor(log2(1 + k 2^-W) 2^W), the LUT ROM of the log2."""
    k = np.arange(1 << width, dtype=np.float64)
    return np.floor(np.log2(1.0 + k / (1 << width)) * (1 << width)).astype(np.int32)


def log2_mag_int(re: torch.Tensor, im: torch.Tensor,
                 cfg: Optional[LogMagConfig] = None) -> torch.Tensor:
    """LUT log2 of the JPL magnitude on the protoLog grid
    (2^-bin_point_log): exponent e = floor(log2 j), the mantissa bucket the
    top ``log2_lookup_width`` bits of j's fraction (truncated), clamped to
    the 16-bit proto; j = 0 gives the proto minimum."""
    cfg = cfg or LogMagConfig()
    L, B = cfg.log2_lookup_width, cfg.bin_point_log
    j = jpl_mag_int(re, im)
    e = torch.zeros_like(j)
    for k in range(1, 31):
        e = e + (j >= (1 << k)).to(torch.int32)
    idx = torch.where(e >= L, j >> (e - L).clamp(min=0),
                      j << (L - e).clamp(min=0)) - (1 << L)
    idx = idx.clamp(0, (1 << L) - 1)
    lut = torch.from_numpy(_log2_frac_lut(L)).to(j.device)
    raw_l = e * (1 << L) + lut[idx.long()]
    raw_b = (raw_l >> (L - B)) if L >= B else (raw_l << (B - L))
    lo = -(1 << (cfg.data_width_log - 1))
    hi = (1 << (cfg.data_width_log - 1)) - 1
    return torch.where(j > 0, raw_b, lo).clamp(lo, hi)


def mag_int_op(x, mag_mode: int, cfg: Optional[LogMagConfig] = None) -> torch.Tensor:
    """The integer LogMagMux, the mode register clipped to 0..3: 0 abs,
    1 squared, 2 JPL, 3 LUT log2. int32 out."""
    xp = x if isinstance(x, C) else as_pair(x)
    re, im = xp.re.to(torch.int32), xp.im.to(torch.int32)
    mode = min(max(int(mag_mode), 0), 3)
    if mode == 0:
        return abs_mag_int(re, im)
    if mode == 1:
        return sqr_mag_int(re, im)
    if mode == 2:
        return jpl_mag_int(re, im)
    return log2_mag_int(re, im, cfg)


def div_shift(div_sum: int) -> int:
    """The ``>> divSum`` amount: XLA fills with the sign bit for a shift
    outside [0, 31], which is a shift by 31."""
    d = int(div_sum)
    return d if 0 <= d <= 31 else 31


def int_scaler(threshold_scaler: float) -> tuple[int, int]:
    """(round(scaler * 64), round(scaler)), rounded half to even as
    ``jnp.round`` rounds the float32 register, saturated to int32 as XLA's
    conversion saturates."""
    s = float(np.float32(threshold_scaler))

    def sat(v):
        return min(max(v, -(2**31)), INT_MAX)

    return sat(round(s * 64.0)), sat(round(s))


def _int_gos_side(win: torch.Tensor, valid: torch.Tensor,
                  rank: int) -> torch.Tensor:
    """The min(rank, nv - 1)-th smallest valid cell of each window, nv its
    valid count (invalid cells sort as int32 max); 0 where nv is 0."""
    s = torch.sort(torch.where(valid, win, INT_MAX), dim=-1).values
    nv = valid.sum(-1)
    idx = torch.minimum(torch.full_like(nv, min(max(int(rank), 0), INT_MAX)),
                        nv - 1).clamp(0, s.shape[-1] - 1)
    got = s.gather(-1, idx.expand(s.shape[:-1])[..., None])[..., 0]
    return torch.where(nv > 0, got, 0)


def _int_cash_side(win: torch.Tensor, valid: torch.Tensor,
                   sub_w: int) -> torch.Tensor:
    """The least sum of ``sub_w`` consecutive valid cells of each window,
    floor-divided once by ``sub_w``; 0 where none fits. The sums wrap in
    int32."""
    wmax = win.shape[-1]
    c = F.pad(torch.cumsum(torch.where(valid, win, 0), -1, dtype=torch.int32),
              (1, 0))
    cv = F.pad(torch.cumsum(valid.to(torch.int32), -1), (1, 0))
    t = torch.arange(wmax, device=win.device)
    end = (t + sub_w).clamp(max=wmax)
    ok = (cv[..., end] - cv[..., t] == sub_w) & (t + sub_w <= wmax)
    est = torch.where(ok, c[..., end] - c[..., t], INT_MAX).min(-1).values
    return torch.where(ok.any(-1),
                       torch.div(est, max(sub_w, 1), rounding_mode="floor"), 0)


def _int_thr_peaks(mag: torch.Tensor, noise: torch.Tensor, rt: RuntimeConfig,
                   n_active: int) -> CfarOutput:
    """The integer threshold and detection tail: the 6-fractional-bit scaler
    (linear) or the additive rounded scaler (log), active-range masking and
    raw-magnitude peak grouping."""
    q, add = int_scaler(rt.threshold_scaler)
    if int(rt.log_or_linear) == 1:
        thr = rhu(noise * q, 6)
    else:
        thr = noise + add
    n = mag.shape[-1]
    cell = torch.arange(n, device=mag.device)
    active = cell < n_active
    thr = torch.where(active, thr, 0)
    peaks = (mag > thr) & active
    if int(rt.peak_grouping) == 1:
        edge = torch.full_like(mag[..., :1], PEAK_EDGE)
        left = torch.cat([edge, mag[..., :-1]], dim=-1)
        right = torch.cat([mag[..., 1:], edge], dim=-1)
        right = torch.where(cell + 1 < n_active, right, PEAK_EDGE)
        peaks = peaks & (mag >= left) & (mag >= right)
    return CfarOutput(threshold=thr, peaks=peaks)


def _combine_int(mode: int, s_lag: torch.Tensor,
                 s_lead: torch.Tensor) -> torch.Tensor:
    if mode == 1:
        return torch.maximum(s_lag, s_lead)
    if mode == 2:
        return torch.minimum(s_lag, s_lead)
    return (s_lag + s_lead) >> 1


def cfar_int(mag: torch.Tensor, rt: RuntimeConfig,
             cfg: CfarConfig = CfarConfig()) -> CfarOutput:
    """Integer CFAR over every elaborated variant with PARTIAL edges: CA sums
    or GOS rank statistics (a GOSCA elaboration reads the algorithm register,
    1 for GOS; a pure-GOS one always ranks), the mode register raw (1 GO,
    2 SO, 3 CASH where elaborated, anything else CA), then the threshold and
    detection tail. int32 threshold, bool peaks."""
    mag = mag.to(torch.int32)
    n = mag.shape[-1]
    n_active = min(int(rt.cfar_fft_size), n)
    log2w, guard = window_registers(rt, cfg)
    w = 1 << log2w
    m = torch.where(torch.arange(n, device=mag.device) < n_active, mag, 0)
    mode = int(rt.cfar_mode)
    gos = cfg.variant is CfarVariant.GOS or (
        cfg.variant is CfarVariant.GOSCA and int(rt.cfar_algorithm) == 1)

    def windows():
        partial = dataclasses.replace(cfg, edge_policy=EdgePolicy.PARTIAL)
        return gather_windows(m, 0, n_active, guard, w, partial)

    if mode == 3 and cfg.include_cash:
        sw = min(max(int(rt.sub_window_size), cfg.min_sub_window),
                 cfg.max_ref_window)
        lag_win, lag_valid, lead_win, lead_valid = windows()
        noise = torch.maximum(_int_cash_side(lag_win, lag_valid, sw),
                              _int_cash_side(lead_win, lead_valid, sw))
    elif gos:
        lag_win, lag_valid, lead_win, lead_valid = windows()
        noise = _combine_int(mode,
                             _int_gos_side(lag_win, lag_valid, rt.index_lagg),
                             _int_gos_side(lead_win, lead_valid, rt.index_lead))
    else:
        lag, lead = ca_window_sums(m, 0, n_active, guard, log2w)
        d = div_shift(rt.div_sum)
        noise = _combine_int(mode, lag >> d, lead >> d)
    return _int_thr_peaks(mag, noise, rt, n_active)


def ca_cfar_int(mag: torch.Tensor, rt: RuntimeConfig,
                cfg: CfarConfig = CfarConfig()) -> CfarOutput:
    """Integer CA/GO/SO CFAR (the CA datapath of ``cfar_int`` whatever the
    elaborated variant)."""
    return cfar_int(mag, rt, dataclasses.replace(
        cfg, variant=CfarVariant.CA, include_cash=False))
