"""Race several processes on the JAX package's graph-kit loader.

Usage (on a copy of the repository without
``bathymetric_gnn_tpu/native/libgraphkit.so``, never on the checkout the
tests run from):

    python tests/jax_kit_race.py COPY [--procs 6] [--rounds 5] [--collect]

Each round deletes the library in COPY and starts ``--procs`` processes
that import the JAX loader and then, at the same instant, ask it for the
library (``native_available()``), as the first k-NN tests of several test
workers do. The JAX loader runs ``native/build.sh`` when the file is
missing, whose g++ writes the library in place, and remembers a failed
load for the rest of the process. With ``--collect`` each process first
imports ``tests/test_torch_knn_graph.py``, as every test worker does while
it collects, whose import builds the library under a file lock and moves
it into place whole. Prints, per round, how many processes found the
library and how many fell back to NumPy.
"""

import argparse
import os
import subprocess
import sys
import time
from pathlib import Path

CHILD = r"""
import os, sys, time
tree, start, collect = sys.argv[1], float(sys.argv[2]), sys.argv[3] == "1"
sys.path[:0] = [tree, os.path.join(tree, "tests")]
os.environ["JAX_PLATFORMS"] = "cpu"
if collect:
    import test_torch_knn_graph  # noqa: F401  (its import builds the kit)
from bathymetric_gnn_tpu import native
while time.time() < start:
    time.sleep(0.001)
print("native" if native.native_available() else "numpy")
"""


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("tree")
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--collect", action="store_true")
    a = ap.parse_args()
    tree = Path(a.tree).resolve()
    so = tree / "bathymetric_gnn_tpu" / "native" / "libgraphkit.so"
    for r in range(a.rounds):
        so.unlink(missing_ok=True)
        # the processes import first (seconds with torch), then all ask
        start = time.time() + (40.0 if a.collect else 8.0)
        procs = [subprocess.Popen(
            [sys.executable, "-c", CHILD, str(tree), repr(start),
             "1" if a.collect else "0"], stdout=subprocess.PIPE, text=True,
            env={**os.environ, "JAX_PLATFORMS": "cpu"})
            for _ in range(a.procs)]
        outs = [p.communicate()[0].strip() for p in procs]
        print(f"round {r + 1}: {outs.count('native')} native, "
              f"{outs.count('numpy')} numpy fallback, "
              f"{len(outs) - outs.count('native') - outs.count('numpy')} "
              f"failed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
