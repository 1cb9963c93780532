"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

One process, one card per chip the cell asks for: set-up (the kernels'
libraries built or found, the inputs and weights made from the seed, every
shape warmed), a window of ``--seconds`` on the cell's traffic, then the
comparison of what the window produced with the plain reference, and a
last line of JSON on standard output (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``; with ``--trace 1`` the per-layer
metrics, ``busy_s``, ``window_s`` and ``breakdown`` of a traced window of
the mix's ``trace_seconds``). The numbers compared
and their limits end standard error and the line. Exits non-zero, with no
result, when the card is missing, when a forbidden module was loaded or
when anything fails.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Caches of the program and of the libraries it might start, at fixed
# places inside the checkout (the kernels' own build directory is
# ``build/torch_kernels`` there already).
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                  "torch_extensions")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def _fail(msg: str, code: int = 1):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(chips)))}


def run(args, device="cuda", overrides=None, out=sys.stdout):
    """One run of the cell; returns the result dict it printed."""
    import torch

    from portbench import compare, harness
    from portbench.trace import Profile

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    cell = harness.Cell(args.workload, bench)
    if device == "cuda":
        if not torch.cuda.is_available():
            _fail("no CUDA device: this benchmark runs only on the card")
        if torch.cuda.device_count() < cell.chips:
            _fail(f"the cell asks for {cell.chips} cards, "
                  f"{torch.cuda.device_count()} present")
        torch.cuda.init()
    driver = cell.driver()
    spans = harness.Spans()
    session = driver.setup(cell, args.seed, device, spans, overrides)
    if device == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - T_START
    spans.times.clear()
    spans.tracing(bool(args.trace))
    prof = Profile() if args.trace else None
    if prof is not None:
        prof.__enter__()
    # A traced run measures a slice of the window's length (the mix's
    # ``trace_seconds``): the profiler's timeline of a whole window of
    # small kernels outgrows the run's time and memory.
    seconds = (min(args.seconds, cell.traffic["trace_seconds"])
               if args.trace else args.seconds)
    try:
        with spans.span("window"):
            result = driver.window(session, seconds, spans)
    finally:
        if prof is not None:
            prof.__exit__(*sys.exc_info())
    spans.tracing(False)
    device_json = (device_info(torch, cell.chips) if device == "cuda" else
                   {"platform": "cpu", "kind": "cpu", "count": 1,
                    "memory_peak_bytes": 0})
    driver.release(session)
    readings = driver.check(session, result)
    correct = compare.passed(readings)

    metrics = {}
    if args.trace:
        tdata = prof.data
        ctx = {"cell": cell, "result": result, "spans": spans,
               "trace": tdata}
        for m in cell.per_layer:
            value = cell.metric_reader(m["name"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_json["busy_s"] = tdata.busy_s
        device_json["window_s"] = tdata.window_s
    else:
        for m in cell.end_to_end:
            if m["name"] == "setup_s":
                metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            else:
                value, unit = result["metrics"][m["name"]]
                metrics[m["name"]] = {"value": value, "unit": unit}

    bad = harness.forbidden_loaded()
    if bad:
        _fail("forbidden modules were loaded in this process: "
              + ", ".join(bad))
    print(f"setup_s {setup_s!r}, of it compiling {session.compile_s!r}",
          file=sys.stderr)
    for name, value, limit in readings:
        print(f"check {name} = {value!r} (limit {limit!r})",
              file=sys.stderr, flush=True)
    line = {"correct": correct, "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics,
            "device": device_json}
    if args.trace:
        line["breakdown"] = tdata.breakdown()
    line["checks"] = {n: {"value": v, "limit": lim}
                      for n, v, lim in readings}
    print(json.dumps(line), file=out, flush=True)
    return line


def main(argv=None):
    args = parse_args(argv)
    if not os.path.exists(os.path.join(ROOT, "bathymetric_gnn_tpu_torch")):
        _fail("the program (bathymetric_gnn_tpu_torch) is not beside the "
              "benchmark")
    run(args)


if __name__ == "__main__":
    main()
