"""Print what ``test_torch_parallel_dp_local_bn.py`` reads: each port step
with ``exact=False`` against JAX's (the largest difference of a leaf after
the step, of a parameter against the largest change of any parameter, of
a BatchNorm statistic against its largest |value|; the losses' largest
relative difference), and at world 2 how far the two modes' BatchNorm
statistics lie apart, in units of the parity tolerance (rtol 5e-4, atol
1e-6), with each loss's relative difference.

    JAX_PLATFORMS=cpu python tests/torch_dp_local_bn_readings.py

(the CPU; about a minute: gloo worlds of 1, 2 and 4 processes).
"""

import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def step_err(np, got, want, init):
    stat = [k for k in want if k.endswith((".mean", ".var"))]
    scale = max(float(np.abs(want[k] - init[k]).max())
                for k in want if k not in stat)
    return max((float(np.abs(got[k] - w).max())
                / (max(float(np.abs(w).max()), 1e-12) if k in stat
                   else scale), k) for k, w in want.items())


def main():
    import numpy as np

    import test_torch_parallel_dp_local_bn as T

    with tempfile.TemporaryDirectory() as tmp:
        want, port, init = T.compute(Path(tmp))
    for (kind, world), ((wl, _), ws) in want.items():
        ws = {k: v.numpy() for k, v in ws.items()}
        ini = {k: v.numpy() for k, v in init[kind].items()}
        keys = ["coo"] if kind == "coo" else ["sparse_C", "sparse_D"]
        for rank, res in enumerate(port[world]):
            job = res[0 if kind == "coo" else 1][False]
            for key in keys:
                (gl, _), gs = job[key]
                err, leaf = step_err(np, gs, ws, ini)
                lerr = max(abs(gl[k] - wl[k]) / max(abs(wl[k]), 1e-12)
                           for k in wl)
                print(f"{key} world {world} rank {rank} vs JAX exact=False: "
                      f"leaves {err:.3e} of the largest change (at {leaf}), "
                      f"losses rel {lerr:.3e}")
    for key in ("coo", "sparse_C", "sparse_D"):
        for rank, res in enumerate(port[2]):
            job = res[0 if key == "coo" else 1]
            (ll, _), ls = job[False][key]
            (el, _), es = job[True][key]
            stat = [n for n in es if n.endswith((".mean", ".var"))]
            x = max(float(np.max(np.abs(ls[n] - es[n])
                                 / (T.ATOL + T.RTOL * np.abs(es[n]))))
                    for n in stat)
            rel = ", ".join(f"{k} {abs(ll[k] - el[k]) / max(abs(el[k]), 1e-12):.3e}"
                            for k in el)
            print(f"{key} world 2 rank {rank}, exact=False vs True: BatchNorm "
                  f"statistics {x:.1f} x the tolerance; losses rel {rel}")


if __name__ == "__main__":
    main()
