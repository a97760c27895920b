"""The readings that the limits of ``correct`` are set from, in one process:
the program's (sound runs of the cell, short windows at the cell's own load,
each on its own seed) and the control's (the configuration's reference in
the next lower precision put in the program's place: bfloat16 for a float32
chain, a float FFT rounded to the integer grid for the bit-true one), judged
by the same comparison on the same CPIs.

    python3 -m rspbench.control --workload float_gosca.gos_sat \\
        --seeds 101,102,...,112 --control-seeds 201,202,203 --seconds 2

Prints one ``reading`` line a seed: the numbers compared, by name.
"""

from __future__ import annotations

import argparse
import json
import time

from . import cells, inputs, judge, run


def control_readings(cell: cells.Cell, seed: int, device: str = "cuda",
                     root=cells.REPO) -> dict:
    """The numbers compared where the control stands in for the program:
    its outputs for each CPI of the ring, judged as a run's samples and
    counts."""
    config, mix = cell.config, cell.traffic
    n_ring = int(mix["ring"])
    ring = inputs.make_ring(config, n_ring, seed, device, root)
    regs = cells.registers(config, mix)
    ref = cells.reference(config, root)
    refs = judge.reference_outputs(ref, config, regs, ring, range(n_ring))
    ctl = judge.reference_outputs(ref, config, regs, ring, range(n_ring),
                                  control=True)
    per = max(1, int(mix["checked_cpis"]) // n_ring)
    samples = [(s, ctl[s][0], ctl[s][1]) for s in range(n_ring)] * per
    counts = {s: ctl[s][2] for s in range(n_ring)}
    checks = judge.compare(config, refs, samples, counts, n_ring, 0)
    return {name: value for name, value, _ in checks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = cells.resolve(args.workload)
    for s in filter(None, args.seeds.split(",")):
        res = run.run_cell(cell, int(s), args.seconds, False,
                           t_start=time.perf_counter())
        vals = {k: c["value"] for k, c in res["checks"].items()}
        print("reading", json.dumps({"side": "program", "seed": int(s),
                                     "attempted": res["attempted"], **vals}),
              flush=True)
    for s in filter(None, args.control_seeds.split(",")):
        vals = control_readings(cell, int(s))
        print("reading", json.dumps({"side": "control", "seed": int(s),
                                     **vals}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
