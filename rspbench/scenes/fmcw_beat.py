"""The scene ``fmcw_beat``: dechirped FMCW returns, the input of a range-FFT
receive chain, and the scene of every configuration that names none.

Each CPI is ``channels x pulses x samples`` of complex Gaussian noise and a
fixed number of point targets, each a beat tone in range (a bin with a
fractional offset), a Doppler phase from pulse to pulse and an angle phase
from channel to channel, at a per-bin SNR drawn from the scene's range.
Every seed gives the same sizes and the same number of targets; only where
they lie changes.
"""

from __future__ import annotations

import math

import torch

from rspbench.inputs import uniform


def make_cpi(config: dict, g: torch.Generator, device) -> tuple:
    """One CPI as float32 ``(re, im)`` planes on ``device``, drawn from
    ``g``."""
    cpi, scene = config["cpi"], config["scene"]
    c, p, n = cpi["channels"], cpi["pulses"], cpi["samples"]
    sigma = float(scene["noise_sigma"])
    re = torch.randn((c, p, n), generator=g, device=device) * sigma
    im = torch.randn((c, p, n), generator=g, device=device) * sigma
    k = int(scene["targets"])
    guard = int(scene["guard_bins"])
    lo_db, hi_db = scene["bin_snr_db"]
    bins = uniform(g, k, guard, n - guard, device)        # fractional bins
    doppler = uniform(g, k, -0.5, 0.5, device)            # cycles a pulse
    angle = uniform(g, k, -0.5, 0.5, device)              # cycles a channel
    phase0 = uniform(g, k, 0.0, 1.0, device)
    snr_db = uniform(g, k, lo_db, hi_db, device)
    # a tone of amplitude a over n samples has a bin power a^2 n against a
    # complex noise power 2 sigma^2 a bin
    amp = torch.sqrt(2.0 * sigma * sigma * 10.0 ** (snr_db / 10.0) / n)
    ci = torch.arange(c, device=device, dtype=torch.float64)[:, None, None]
    pi = torch.arange(p, device=device, dtype=torch.float64)[None, :, None]
    ni = torch.arange(n, device=device, dtype=torch.float64)[None, None, :]
    for t in range(k):
        # cycles of each term, wrapped before the float32 trigonometry
        cyc = torch.remainder(bins[t] / n * ni + doppler[t] * pi
                              + angle[t] * ci + phase0[t], 1.0)
        ph = (2.0 * math.pi * cyc).to(torch.float32)
        a = float(amp[t])
        re += a * torch.cos(ph)
        im += a * torch.sin(ph)
    return re, im
