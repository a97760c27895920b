"""The chain ``fft_mag_cfar``: the port's range-FFT receive chain,
``presets.fft_mag_cfar_chain``, FFT -> magnitude -> CFAR along each frame of
a ``channels x pulses x samples`` CPI, float or bit-true. The chain of every
configuration that names none.

``build`` elaborates it from the configuration's ``elaboration``
(``fft_max_size``, ``cfar``, ``fixed_point``) and its registers with the
mix's writes. ``work`` counts a CPI's work for ``roofline.cpi_work``:

* bytes: each input byte read once and each output byte written once. The
  input is two 32-bit planes (float32, or the integer samples as int32), 8 B
  a sample; the output a 32-bit threshold and a one-byte peak flag, 5 B a
  sample: 13 B a sample whatever kernels implement the chain.
* operations: a float FFT's 5 N log2 N a frame at the float32 peak outside
  the tensor cores; the bit-true chain's butterflies, 8.5 log2 N a sample,
  at the int32 peak (half the float32 issue rate).
"""

from __future__ import annotations

import math

from rspbench import cells, roofline

IN_BYTES = 8
OUT_BYTES = 5


def build(config: dict, mix: dict, device):
    """The program under test: the chain of the configuration's elaboration
    and the register file of its registers with the mix's writes."""
    from rsp_chains_tpu_torch import (
        CfarConfig, CfarVariant, ChainConfig, FftConfig, FixedPointConfig,
        RuntimeConfig, fft_mag_cfar_chain,
    )

    el = config["elaboration"]
    c = el["cfar"]
    cfg = ChainConfig(
        fft=FftConfig(max_size=el["fft_max_size"]),
        cfar=CfarConfig(variant=CfarVariant[c["variant"]],
                        include_cash=c["include_cash"],
                        max_ref_window=c["max_ref_window"],
                        max_guard_window=c["max_guard_window"],
                        max_fft_size=c["max_fft_size"]),
        fixed_point=FixedPointConfig(**el["fixed_point"]))
    rt = RuntimeConfig.make(**cells.registers(config, mix),
                            validate_against=cfg.cfar)
    return fft_mag_cfar_chain(cfg, device=device), rt


def work(config: dict) -> dict:
    """Bytes, operations and the least seconds of one CPI of ``config``."""
    cpi = config["cpi"]
    n = int(cpi["samples"])
    samples = int(cpi["channels"]) * int(cpi["pulses"]) * n
    frames = samples // n
    log2n = math.log2(n)
    nbytes = samples * (IN_BYTES + OUT_BYTES)
    if config["numeric_format"] == "bit_true_int16":
        ops, peak = 8.5 * log2n * samples, roofline.INT32_PER_S
    else:
        ops, peak = 5.0 * n * log2n * frames, roofline.FP32_PER_S
    return roofline.least(samples, nbytes, ops, peak)
