"""Readings that set a cell's limits: the program's over many seeds, the
control's (the reference in TF32, the nearest precision below the
configuration's float32, put in the program's place) and those of
planted faults, each run at the cell's own size in one process.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 \\
        --seconds 3 [--fault altered|unchanged|half_batch] [--no-control]

Prints one JSON line per seed: {"seed", "program": {name: reading},
"control": {name: reading}}. The benchmark's own runs do not run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import faults, harness  # noqa: E402


def readings(cell, seed: int, seconds: float, device="cuda", fault=None,
             control=True, overrides=None) -> dict:
    driver = cell.driver()
    spans = harness.Spans()
    ctx = faults.planted(fault) if fault else contextlib.nullcontext()
    with ctx:
        s = driver.setup(cell, seed, device, spans, overrides)
        result = driver.window(s, seconds, spans)
    driver.release(s)
    out = {"seed": seed, "fault": fault,
           "program": {n: v for n, v, _l in driver.check(s, result)}}
    if control:
        out["control"] = {n: v for n, v, _l in driver.control(s)}
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default=None)
    ap.add_argument("--no-control", action="store_true")
    args = ap.parse_args(argv)
    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.Cell(args.workload, bench)
    for seed in args.seeds:
        r = readings(cell, seed, args.seconds, fault=args.fault,
                     control=not args.no_control)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
