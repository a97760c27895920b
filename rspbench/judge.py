"""Whether the timed path's outputs are correct: each sampled output of the
window against the plain reference of its CPI, and every delivered
detection count of the window against the reference's count of its CPI.

The numbers compared, each against the limit that the configuration's
``correct`` table gives it (a number the table does not name is not held):

* exact configurations (bit-true): ``thr_cells_diff`` and
  ``peak_cells_diff``, the cells of the sampled outputs whose threshold or
  peak flag differs from the reference; ``count_cpis_diff``, the delivered
  CPIs whose detection count differs from the reference's;
* float configurations: ``thr_rel_err``, the largest relative gap of a
  sampled threshold from the float64 reference's; ``peak_flip_frac``, the
  share of sampled cells whose peak flag differs; ``count_gap``, the largest
  gap of a delivered detection count from the reference's;
* both: ``undelivered``, the CPIs of the window that the pipeline accepted
  and never delivered, and ``sampled``, which must be above 0 (a run that
  sampled nothing has checked nothing).
"""

from __future__ import annotations

import torch


def reference_outputs(ref, config: dict, regs: dict, ring: list,
                      slots, control: bool = False) -> dict:
    """``{slot: (threshold, peaks, count)}`` of the plain reference (or of
    its lower-precision control) over the ring's CPIs ``slots``."""
    out = {}
    for s in sorted(set(slots)):
        re, im = ring[s]
        if config["numeric_format"] == "bit_true_int16":
            thr, pk = ref.chain(re, im, regs,
                                fft="float_rounded" if control else "bit_true")
        else:
            thr, pk = ref.chain(re, im, regs, dtype=torch.bfloat16
                                if control else torch.float64)
        out[s] = (thr, pk, int(pk.sum()))
    return out


def compare(config: dict, refs: dict, samples: list, counts: dict,
            n_ring: int, undelivered: int) -> list:
    """The checks ``[(name, value, limit)]`` of the configuration's
    ``correct`` table. ``samples`` are ``(seq, threshold, peaks)`` of the
    program, ``counts`` ``{seq: detections}`` of every CPI delivered in the
    window."""
    exact = config["numeric_format"] == "bit_true_int16"
    values = {"undelivered": float(undelivered),
              "sampled": float(len(samples))}
    thr_diff = peak_diff = cells = 0
    rel = 0.0
    for seq, thr, pk in samples:
        r_thr, r_pk, _ = refs[seq % n_ring]
        peak_diff += int((pk != r_pk).sum())
        cells += pk.numel()
        if exact:
            thr_diff += int((thr.long() != r_thr).sum())
        else:
            gap = (thr.double() - r_thr).abs()
            den = r_thr.abs().clamp_min(torch.finfo(torch.float64).tiny)
            rel = max(rel, float((gap / den).max()))
    gaps = [abs(c - refs[seq % n_ring][2]) for seq, c in counts.items()]
    if exact:
        values.update(thr_cells_diff=float(thr_diff),
                      peak_cells_diff=float(peak_diff),
                      count_cpis_diff=float(sum(g != 0 for g in gaps)))
    else:
        values.update(thr_rel_err=rel,
                      peak_flip_frac=peak_diff / max(cells, 1),
                      count_gap=float(max(gaps, default=0)))
    limits = dict(config["correct"])
    checks = [(k, values[k], limits[k]) for k in limits]
    checks.append(("sampled", values["sampled"], "> 0"))
    return checks


def passed(checks: list) -> bool:
    """True where every number lies within its limit (``> 0`` for the
    sample count); a limit not yet set (None) fails."""
    for name, value, limit in checks:
        if limit == "> 0":
            if not value > 0:
                return False
        elif limit is None or not value <= limit:
            return False
    return True
