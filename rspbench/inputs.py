"""The CPI ring: a few distinct CPIs made on the device from the seed.

Each CPI is ``channels x pulses x samples`` of dechirped FMCW returns, the
input of a range-FFT receive chain: complex Gaussian noise and a fixed number
of point targets, each a beat tone in range (a bin with a fractional offset),
a Doppler phase from pulse to pulse and an angle phase from channel to
channel, at a per-bin SNR drawn from the configuration's range. Every seed
gives the same sizes and the same number of targets; only where they lie
changes. A bit-true configuration takes the float CPI scaled, rounded and
clipped to its integer grid, as int32 planes.

The noise comes from ``torch.randn`` with a generator on the CPI's device,
one call a plane, so a CPI costs a few large launches on the card.
"""

from __future__ import annotations

import math

import torch


def _uniform(g: torch.Generator, n: int, lo: float, hi: float,
             device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=g, device=device,
                                       dtype=torch.float64)


def make_cpi(config: dict, g: torch.Generator, device) -> tuple:
    """One CPI as ``(re, im)`` planes on ``device``: float32, or int32 for an
    ``int16`` input."""
    cpi, scene, inp = config["cpi"], config["scene"], config["input"]
    c, p, n = cpi["channels"], cpi["pulses"], cpi["samples"]
    sigma = float(scene["noise_sigma"])
    re = torch.randn((c, p, n), generator=g, device=device) * sigma
    im = torch.randn((c, p, n), generator=g, device=device) * sigma
    k = int(scene["targets"])
    guard = int(scene["guard_bins"])
    lo_db, hi_db = scene["bin_snr_db"]
    bins = _uniform(g, k, guard, n - guard, device)       # fractional bins
    doppler = _uniform(g, k, -0.5, 0.5, device)           # cycles a pulse
    angle = _uniform(g, k, -0.5, 0.5, device)             # cycles a channel
    phase0 = _uniform(g, k, 0.0, 1.0, device)
    snr_db = _uniform(g, k, lo_db, hi_db, device)
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
    if inp["kind"] == "int16":
        scale, clip = float(inp["scale"]), float(inp["clip"])
        re = torch.round(torch.clamp(re * scale, -clip, clip)).to(torch.int32)
        im = torch.round(torch.clamp(im * scale, -clip, clip)).to(torch.int32)
    elif inp["kind"] != "float32":
        raise ValueError(f"unknown input kind {inp['kind']!r}")
    return re.contiguous(), im.contiguous()


def make_ring(config: dict, n_ring: int, seed: int, device) -> list:
    """``n_ring`` distinct CPIs from ``seed``, as ``(re, im)`` planes."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return [make_cpi(config, g, device) for _ in range(n_ring)]
