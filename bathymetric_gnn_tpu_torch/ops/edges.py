"""Grid neighbour offsets and k-NN edges (port of
``bathymetric_gnn_tpu/ops/edges.py``: the offsets, ``morton_order``,
``hilbert_order`` and ``knn_edges``).

The offset enumeration order is part of the weights' meaning: edge
features, attention logits and the kernel's neighbour loop all index
offsets in this order, and it matches the reference's
(data/graph_construction.py:78-89). The space-filling-curve orders and the
k-NN edge list are host-side NumPy with the JAX module's integer
arithmetic, so both packages put the nodes of a k-NN graph in the same
order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

OFFSETS_4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
OFFSETS_8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def offsets_for_connectivity(connectivity: int) -> Tuple[Tuple[int, int], ...]:
    if connectivity == 4:
        return OFFSETS_4
    if connectivity == 8:
        return OFFSETS_8
    raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")


def morton_order(pos: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation sorting 2-D points along a Z-order (Morton) curve."""
    p = np.asarray(pos, np.float64)
    lo = p.min(0)
    span = np.maximum(p.max(0) - lo, 1e-12)
    q = ((p - lo) / span * ((1 << bits) - 1)).astype(np.uint64)

    def spread(v):
        v = v & np.uint64((1 << bits) - 1)
        out = np.zeros_like(v)
        for b in range(bits):
            out |= ((v >> np.uint64(b)) & np.uint64(1)) << np.uint64(2 * b)
        return out

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1))
    return np.argsort(code, kind="stable")


def hilbert_order(pos: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation sorting 2-D points along a Hilbert curve: k-NN
    neighbours get nearby node indices, so a layer's neighbour rows are
    close in memory (on the card: mostly L2 hits)."""
    p = np.asarray(pos, np.float64)
    lo = p.min(0)
    span = np.maximum(p.max(0) - lo, 1e-12)
    q = ((p - lo) / span * ((1 << bits) - 1)).astype(np.int64)
    x, y = q[:, 0].copy(), q[:, 1].copy()
    d = np.zeros(len(x), np.int64)
    s = 1 << (bits - 1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        # rotate the quadrant (vectorized d2xy rotation)
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f = np.where(flip, s - 1 - x, x)
        y_f = np.where(flip, s - 1 - y, y)
        x, y = np.where(swap, y_f, x_f), np.where(swap, x_f, y_f)
        s >>= 1
    return np.argsort(d, kind="stable")


def knn_edges(
    pos: np.ndarray,
    k: int,
    node_valid: Optional[np.ndarray] = None,
) -> np.ndarray:
    """k-NN edge list [2, N*k] (src = neighbour -> dst = node) over the
    valid nodes, by the native C++ k-NN (``native.knn2d``, which raises
    when it cannot be built). Each node's edges are contiguous, nearest
    first."""
    from ..native import knn2d

    n = pos.shape[0]
    if node_valid is None:
        node_valid = np.ones(n, bool)
    live = np.where(node_valid)[0]
    p = np.asarray(pos, np.float32)[live]
    k_eff = min(k, len(live) - 1)
    if k_eff <= 0:
        return np.zeros((2, 0), np.int64)
    nbrs = knn2d(p, k_eff)  # [n_live, k_eff], -1 pads
    ok = nbrs >= 0
    dst = np.repeat(live, k_eff)[ok.reshape(-1)]
    src = live[nbrs.reshape(-1)[ok.reshape(-1)]]
    return np.stack([src, dst], 0)
