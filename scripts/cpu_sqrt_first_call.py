"""Does the first float32 ``torch.sqrt`` on the CPU in a process give the
bits of the second? Each run is a fresh Python process that imports torch,
sets T intra-op threads and takes ``torch.sqrt`` of the same seeded S
values (uniform in [1e-3, 0.6], the slab's local variances' range) twice;
a run whose two results differ prints where and by how much:

    python3 scripts/cpu_sqrt_first_call.py [--runs 200] [--jobs 4]
        [--threads 2] [--size 21952]

``--jobs`` runs that many processes at once (more load, as pytest workers
give). The port's CPU featurization takes its square roots and arctangents
from NumPy (``ops/features.sqrt``, ``atan_deg``) because such a first call
has returned a block of its values at ~12 bits."""

import argparse
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

CHILD = """
import sys, numpy as np, torch
torch.set_num_threads(int(sys.argv[1]))
v = torch.from_numpy(np.random.default_rng(0).uniform(
    1e-3, 0.6, int(sys.argv[2])).astype(np.float32))
a, b = torch.sqrt(v), torch.sqrt(v)
d = torch.nonzero(a != b).flatten()
exact = torch.sqrt(v.double())
rel = float(((a.double() - exact).abs() / exact).max())
print(f"{d.numel()} {int(d.min()) if d.numel() else -1} "
      f"{int(d.max()) if d.numel() else -1} {rel:.3e}")
"""


def run(args) -> str:
    return subprocess.run(
        [sys.executable, "-c", CHILD, str(args.threads), str(args.size)],
        capture_output=True, text=True, timeout=300).stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=200)
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--threads", type=int, default=2)
    ap.add_argument("--size", type=int, default=21952)
    args = ap.parse_args()
    with ThreadPoolExecutor(args.jobs) as pool:
        outs = list(pool.map(lambda _: run(args), range(args.runs)))
    bad = 0
    for i, out in enumerate(outs):
        n, lo, hi, rel = out.split()
        if int(n):
            bad += 1
            print(f"run {i}: the first call differs from the second at {n} "
                  f"of {args.size} values ({lo}..{hi}); the first call's "
                  f"largest error against the f64 root {rel}")
    print(f"cpu_sqrt_first_call: {bad} of {args.runs} runs differ "
          f"({args.threads} threads, {args.size} values, {args.jobs} at "
          f"once)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
