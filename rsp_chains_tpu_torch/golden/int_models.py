"""Numpy goldens for the bit-true integer chain (``ops.bit_true``).

Same arithmetic contract (see ``ops/bit_true.py`` docstring for the spec and
its reference provenance), written directly index-wise in int64 numpy —
deliberately NOT sharing the roll/vector formulation of the jnp ops, so an
exact-equality test between the two is a real cross-check of the spec, not the
same code run twice."""

from __future__ import annotations

import numpy as np


def _rhu(v, k: int):
    if k == 0:
        return v
    return (v + (1 << (k - 1))) >> k


def _wrap16(v):
    return ((v + 32768) & 0xFFFF) - 32768


def int_fft_golden(xr, xi, expand_logic=None, keep_msb=None):
    """Radix-2 DIF integer FFT, natural order out, int64 numpy.

    ``keep_msb[s]`` (default all-True): non-expanding stage trim side — True
    halves with RoundHalfUp, False keeps LSBs with wraparound overflow (and
    wraps the post-twiddle product, whose unhalved input can overflow the
    16-bit proto). Mirrors ``ops.bit_true._fft_int_fixed``."""
    xr = np.asarray(xr, np.int64).copy()
    xi = np.asarray(xi, np.int64).copy()
    n = xr.shape[-1]
    p = int(np.log2(n))
    for s in range(p):
        m = n >> s
        half = m >> 1
        yr = np.empty_like(xr)
        yi = np.empty_like(xi)
        trim = None
        if expand_logic is None or not expand_logic[s]:
            trim = "msb" if (keep_msb is None or keep_msb[s]) else "lsb"
        for b0 in range(0, n, m):
            for j in range(half):
                a_r, a_i = xr[..., b0 + j], xi[..., b0 + j]
                b_r, b_i = xr[..., b0 + j + half], xi[..., b0 + j + half]
                sr, si = a_r + b_r, a_i + b_i
                dr, di = a_r - b_r, a_i - b_i
                if trim == "msb":
                    sr, si = _rhu(sr, 1), _rhu(si, 1)
                    dr, di = _rhu(dr, 1), _rhu(di, 1)
                elif trim == "lsb":
                    sr, si = _wrap16(sr), _wrap16(si)
                    dr, di = _wrap16(dr), _wrap16(di)
                w = np.exp(-2j * np.pi * j / m)
                wr = int(np.round(w.real * 32768.0))
                wi = int(np.round(w.imag * 32768.0))
                yr[..., b0 + j], yi[..., b0 + j] = sr, si
                yr[..., b0 + j + half] = _rhu(dr * wr - di * wi, 15)
                yi[..., b0 + j + half] = _rhu(dr * wi + di * wr, 15)
        if trim == "lsb":
            yr, yi = _wrap16(yr), _wrap16(yi)
        xr, xi = yr, yi
    rev = [int(format(k, f"0{p}b")[::-1], 2) for k in range(n)]
    return xr[..., rev], xi[..., rev]


def int_jpl_golden(re, im):
    re = np.asarray(re, np.int64)
    im = np.asarray(im, np.int64)
    u = np.maximum(np.abs(re), np.abs(im))
    v = np.minimum(np.abs(re), np.abs(im))
    return np.maximum(u + (v >> 3), u - (u >> 3) + (v >> 1))


def int_sqr_golden(re, im):
    """Integer square magnitude with int32 saturation (Scala Double.toInt
    clamp — RspChainTesterUtils.scala:205-208)."""
    re = np.asarray(re, np.int64)
    im = np.asarray(im, np.int64)
    return np.minimum(re * re + im * im, 2**31 - 1)


def int_abs_golden(re, im):
    """floor(|re + j·im|) via exact integer sqrt of the saturating square sum
    (the golden menu's default case, RspChainTesterUtils.scala:214)."""
    import math

    s = int_sqr_golden(re, im)
    return np.vectorize(math.isqrt, otypes=[np.int64])(s)


def int_log2_golden(re, im, data_width_log=16, bin_point_log=9,
                    lookup_width=9):
    """LUT log2 of the JPL magnitude on the protoLog grid, index-wise
    (mirrors ops.bit_true.log2_mag_int's documented contract)."""
    j = np.asarray(int_jpl_golden(re, im), np.int64)
    L, B = int(lookup_width), int(bin_point_log)
    lut = np.floor(np.log2(1.0 + np.arange(1 << L) / (1 << L)) * (1 << L)
                   ).astype(np.int64)
    out = np.zeros_like(j)
    lo = -(1 << (data_width_log - 1))
    hi = (1 << (data_width_log - 1)) - 1
    for idx in np.ndindex(j.shape):
        ji = int(j[idx])
        if ji <= 0:
            out[idx] = lo
            continue
        e = ji.bit_length() - 1
        bucket = (ji >> (e - L) if e >= L else ji << (L - e)) - (1 << L)
        bucket = min(max(bucket, 0), (1 << L) - 1)
        raw_l = e * (1 << L) + int(lut[bucket])
        raw_b = raw_l >> (L - B) if L >= B else raw_l << (B - L)
        out[idx] = min(max(raw_b, lo), hi)
    return out


def int_gosca_cfar_golden(mag, *, ref_window, guard_window, div_sum,
                          threshold_scaler, wmax, algorithm=0, mode=0,
                          rank_lagg=0, rank_lead=0, sub_window=2,
                          peak_grouping=0, log_or_linear=1, n_active=None):
    """Index-wise integer GOSCA (+CASH) CFAR (PARTIAL edges): CA sums with
    the truncating divider, GOS rank select over sorted valid window cells,
    CASH min sub-window sum divided once by sub_window. Mirrors
    ``ops.bit_true.cfar_int``'s documented contract."""
    mag = np.asarray(mag, np.int64)
    assert mag.ndim == 1, "golden is 1-D; loop batch frames in the caller"
    n = mag.shape[-1]
    if n_active is None:
        n_active = n
    w, g = int(ref_window), int(guard_window)
    wmax = int(wmax)
    sub_w = int(sub_window)
    thr = np.zeros_like(mag)
    pk = np.zeros(mag.shape, bool)
    scaler_q = int(np.round(threshold_scaler * 64.0))

    def window_cells(i, lag_side):
        # offsets k in [0, wmax): position i-g-w+k (lag) / i+g+1+k (lead);
        # valid iff k < w and inside [0, n_active)
        cells = []
        for k in range(wmax):
            pos = (i - g - w + k) if lag_side else (i + g + 1 + k)
            valid = (k < w) and (0 <= pos < n_active)
            cells.append((int(mag[pos]) if valid else None))
        return cells

    def gos_stat(cells, rank):
        vals = sorted(c for c in cells if c is not None)
        if not vals:
            return 0
        idx = min(max(min(int(rank), len(vals) - 1), 0), wmax - 1)
        return vals[idx]

    def cash_stat(cells):
        best = None
        for t in range(wmax - sub_w + 1):
            sub = cells[t : t + sub_w]
            if any(c is None for c in sub):
                continue
            s = sum(sub)
            best = s if best is None else min(best, s)
        return 0 if best is None else best // max(sub_w, 1)

    for i in range(n_active):
        lag_sum = sum(int(mag[j]) for j in range(max(i - g - w, 0), max(i - g, 0)))
        lead_sum = sum(int(mag[j]) for j in range(min(i + g + 1, n_active),
                                                  min(i + g + 1 + w, n_active)))
        ca_lag = lag_sum >> int(div_sum)
        ca_lead = lead_sum >> int(div_sum)
        lag_cells = window_cells(i, True)
        lead_cells = window_cells(i, False)
        if algorithm == 1:
            s_lag = gos_stat(lag_cells, rank_lagg)
            s_lead = gos_stat(lead_cells, rank_lead)
        else:
            s_lag, s_lead = ca_lag, ca_lead
        if mode == 1:
            noise = max(s_lag, s_lead)
        elif mode == 2:
            noise = min(s_lag, s_lead)
        elif mode == 3:
            noise = max(cash_stat(lag_cells), cash_stat(lead_cells))
        else:
            noise = (s_lag + s_lead) >> 1
        if log_or_linear == 1:
            t = _rhu(noise * scaler_q, 6)
        else:
            t = noise + int(np.round(threshold_scaler))
        thr[..., i] = t
        pk[..., i] = mag[..., i] > t
    if peak_grouping:
        keep = pk.copy()
        for i in range(n_active):
            left = mag[..., i - 1] if i - 1 >= 0 else -(1 << 30)
            right = mag[..., i + 1] if i + 1 < n_active else -(1 << 30)
            keep[..., i] = pk[..., i] & (mag[..., i] >= left) & (mag[..., i] >= right)
        pk = keep
    return thr, pk


def int_ca_cfar_golden(mag, *, ref_window, guard_window, div_sum,
                       threshold_scaler, mode=0, peak_grouping=0,
                       log_or_linear=1, n_active=None):
    """Index-wise integer CA/GO/SO CFAR (PARTIAL edges)."""
    mag = np.asarray(mag, np.int64)
    assert mag.ndim == 1, "golden is 1-D; loop batch frames in the caller"
    n = mag.shape[-1]
    if n_active is None:
        n_active = n
    w, g = int(ref_window), int(guard_window)
    thr = np.zeros_like(mag)
    pk = np.zeros(mag.shape, bool)
    scaler_q = int(np.round(threshold_scaler * 64.0))
    for i in range(n_active):
        lag = sum(int(mag[j]) for j in range(max(i - g - w, 0), max(i - g, 0)))
        lead = sum(int(mag[j]) for j in range(min(i + g + 1, n_active),
                                              min(i + g + 1 + w, n_active)))
        s_lag = lag >> int(div_sum)
        s_lead = lead >> int(div_sum)
        if mode == 1:
            noise = max(s_lag, s_lead)
        elif mode == 2:
            noise = min(s_lag, s_lead)
        else:
            noise = (s_lag + s_lead) >> 1
        if log_or_linear == 1:
            t = _rhu(noise * scaler_q, 6)
        else:
            t = noise + int(np.round(threshold_scaler))
        thr[..., i] = t
        pk[..., i] = mag[..., i] > t
    if peak_grouping:
        keep = pk.copy()
        for i in range(n_active):
            left = mag[..., i - 1] if i - 1 >= 0 else -(1 << 30)
            right = mag[..., i + 1] if i + 1 < n_active else -(1 << 30)
            keep[..., i] = pk[..., i] & (mag[..., i] >= left) & (mag[..., i] >= right)
        pk = keep
    return thr, pk
