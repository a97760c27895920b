"""Small cells for the CPU tests: the real configuration and traffic files
with the CPI cut to a few frames and a short warm-up."""

from __future__ import annotations

import copy
import dataclasses

from rspbench import cells

SMALL_CPI = {"channels": 2, "pulses": 4}


def small_cell(name: str, **traffic) -> cells.Cell:
    return shrink(cells.resolve(name), **traffic)


def shrink(cell: cells.Cell, **traffic) -> cells.Cell:
    config = copy.deepcopy(cell.config)
    config["cpi"].update(SMALL_CPI)
    mix = {**cell.traffic, "warmup_cpis": 12, **traffic}
    if mix["loop"] == "open":
        mix["rate_cpi_per_s"] = 10.0
    return dataclasses.replace(cell, config=config, traffic=mix)
