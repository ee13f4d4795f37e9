#!/usr/bin/env python3
"""The readings that a cell's limits are set from, many seeds in one
process (the benchmark's own runs never run this):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--seconds 2]

Each seed is one `run.run` of the cell, the path the benchmark's runs
take, with a short window at the cell's load; its `look` then reads the
numbers of the comparison for the program (its lower reading) and for
the control (the reference in the program's place in the next precision
down: TF32 for the accurate path's float32, fp8 operands for the fast
path's bf16), and in training for the fault of a step that leaves half of
its batch out and for float32's own rounding: the program and the
float32 reference each against the reference in float64. One JSON line a
seed and kind on standard output.
"""
from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import run  # noqa: E402

CONTROLS = {"train_step": ("tf32", "half"), "register": ("fp8",)}
WITNESS = {"train_step": "float64"}


def readings(name: str, seeds: list, seconds: float, device=None, edit=None) -> list:
    out = []
    for seed in seeds:
        rows = []

        def look(drv, ref):
            rows.append(("program", drv.numbers(drv.program, ref, detail=True)))
            entry = run.load_cell(name).mix["entry"]
            for kind in CONTROLS[entry]:
                rows.append((kind, drv.numbers(drv.reference(kind), ref, detail=True)))
            if entry in WITNESS:
                exact = drv.reference(WITNESS[entry])
                rows.append(("program-vs-float64", drv.numbers(drv.program, exact, detail=True)))
                rows.append(("reference-vs-float64", drv.numbers(ref, exact, detail=True)))

        code, result, _ = run.run(name, seed, seconds, False, device=device, edit=edit, look=look)
        if code != 0:
            raise SystemExit(f"{name} seed {seed}: the run exited with {code}")
        for kind, numbers in rows:
            line = {"cell": name, "seed": seed, "kind": kind, "attempted": result["attempted"],
                    **numbers}
            print(json.dumps(line), flush=True)
            out.append(line)
    return out


def main() -> None:
    import argparse
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    a = ap.parse_args()
    readings(a.workload, [int(s) for s in a.seeds.split(",")], a.seconds)


if __name__ == "__main__":
    main()
