"""The comparisons that decide ``correct``: the numbers read between what
the timed path produced and the reference, each against its limit.

Each limit lies between the largest reading of sound runs and the
smallest reading of the control (the reference in a lower precision put
in the program's place); ``PERF.md`` gives both and the limit. A reading
that is not finite fails.
"""

from __future__ import annotations

import json
import math
from typing import Dict, List, Sequence

import numpy as np


def dims_key(dims: Dict) -> str:
    """A kernel call's dims as a stable string key."""
    return json.dumps(dims, sort_keys=True)


def passed(readings: Sequence[tuple]) -> bool:
    return all(math.isfinite(v) and v <= lim for _n, v, lim in readings)


def _f16_step(x: np.ndarray) -> np.ndarray:
    """The spacing of float16 values at |x| (normal range)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -14)))
    return 2.0 ** (e - 10)


def survey_readings(prog: List[np.ndarray], ref: List[tuple],
                    limits: Dict) -> List[tuple]:
    """Each sampled tile is an answer ([3, B, H, W] f16 batches: class,
    confidence, correction). Per tile, over its valid cells: the share
    whose class differs from the reference's; the share whose f16
    confidence differs from the reference's rounded the same way; and
    the share whose f16 correction lies more than one float16 step from
    the reference's, the step taken at the larger of the cell's value and
    the tile's median |correction| (the correction is near 0 on much of a
    tile, where a float16 step is finer than the f32 arithmetic's own
    rounding, so a plain share of differing cells reads up to 0.43 on
    sound runs). The readings are the worst tile's."""
    worst = {"class_mismatch": 0.0, "confidence_mismatch": 0.0,
             "correction_off": 0.0}
    for got, (valid, want) in zip(prog, ref):
        for t in range(got.shape[1]):
            v = valid[t].astype(bool)
            n = max(int(v.sum()), 1)
            g = [got[c, t][v].astype(np.float32) for c in range(3)]
            w = [want[c, t][v].astype(np.float32) for c in range(3)]
            scale = float(np.median(np.abs(w[2]))) if n > 1 else 0.0
            step = _f16_step(np.maximum(np.abs(w[2]), scale))
            shares = (int((g[0] != w[0]).sum()) / n,
                      int((g[1] != w[1]).sum()) / n,
                      int((np.abs(g[2] - w[2]) > step).sum()) / n)
            for k, share in zip(worst, shares):
                worst[k] = max(worst[k], share)
    return [(k, worst[k], float(limits[k])) for k in worst]


def leaf_gaps(prog: Dict, ref: Dict, names: Sequence[str]) -> np.ndarray:
    """Per leaf, the gap between the program's norm and the reference's,
    over the larger of that leaf's reference norm and the median leaf's."""
    norms = np.array([float(np.linalg.norm(ref[k])) for k in names])
    med = float(np.median(norms))
    got = np.array([float(np.linalg.norm(prog[k])) for k in names])
    return np.abs(got - norms) / np.maximum(np.maximum(norms, med), 1e-30)


def train_readings(prog: Dict, ref: Dict, limits: Dict) -> List[tuple]:
    """``prog`` / ``ref``: {"losses": [3], "grads": {leaf: array} (the
    first step's gradient as the optimizer takes it), "change": {leaf:
    array} (the parameters after three steps less the first)}. Readings:
    the largest relative gap of a step's loss; the worst leaf's and the
    median leaf's gap of the first gradient's norm (the worst leaf, the
    layer-1 and -2 edge weights, sums terms that cancel and swings by
    seed as far as the TF32 control reads; the median leaf is the number
    the control fails); the worst leaf's gap of the change's norm, over
    the leaves whose reference gradient is at least a thousandth of the
    median leaf's (the others, the GAT biases before a BatchNorm, move by
    round-off alone under AdamW)."""
    lg = max(abs(a - b) / max(abs(b), 1e-30)
             for a, b in zip(prog["losses"], ref["losses"]))
    names = sorted(ref["grads"])
    gn = np.array([float(np.linalg.norm(ref["grads"][k])) for k in names])
    moved = [k for k, g in zip(names, gn) if g >= 1e-3 * np.median(gn)]
    grad = leaf_gaps(prog["grads"], ref["grads"], names)
    vals = {"loss_gap": lg, "grad_gap_worst": float(grad.max()),
            "grad_gap_median": float(np.median(grad)),
            "change_gap": float(leaf_gaps(prog["change"], ref["change"],
                                          moved).max())}
    return [(k, v, float(limits[k])) for k, v in vals.items()]
