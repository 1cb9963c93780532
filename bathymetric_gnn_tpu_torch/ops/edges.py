"""Grid neighbour offsets, grid-graph edges and k-NN edges (port of
``bathymetric_gnn_tpu/ops/edges.py``).

The grid-graph functions (``neighbor_valid_mask``,
``build_node_index_grid``, ``enumerate_nodes``, ``enumerate_edges_coo``,
``compact_edges``) are torch on the device of their inputs; they give
nodes in row-major order (``np.nonzero``'s) and edges in the JAX module's
order: offset-major, then compacted by a stable sort on the destination,
which is the slot order ``ops/ell.coo_to_ell`` keeps and so the order of
a layer's softmax sums.

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
import torch

from .features import edge_features_for_offset

OFFSETS_4 = ((-1, 0), (1, 0), (0, -1), (0, 1))
OFFSETS_8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def offsets_for_connectivity(connectivity: int) -> Tuple[Tuple[int, int], ...]:
    if connectivity == 4:
        return OFFSETS_4
    if connectivity == 8:
        return OFFSETS_8
    raise ValueError(f"connectivity must be 4 or 8, got {connectivity}")


def neighbor_valid_mask(valid_mask: torch.Tensor, dr: int,
                        dc: int) -> torch.Tensor:
    """[H, W] bool: cell (r, c) has a valid neighbour at (r + dr, c + dc)."""
    h, w = valid_mask.shape
    shifted = torch.roll(valid_mask, shifts=(-dr, -dc), dims=(0, 1))
    rows = torch.arange(h, device=valid_mask.device)[:, None]
    cols = torch.arange(w, device=valid_mask.device)[None, :]
    in_bounds = ((rows + dr >= 0) & (rows + dr < h)
                 & (cols + dc >= 0) & (cols + dc < w))
    return valid_mask & shifted & in_bounds


def build_node_index_grid(valid_mask: torch.Tensor, rows: torch.Tensor,
                          cols: torch.Tensor,
                          node_valid: torch.Tensor) -> torch.Tensor:
    """[H, W] int32 grid mapping a cell to its node index (-1: no node);
    padded node slots write nowhere."""
    h, w = valid_mask.shape
    n_pad = rows.shape[0]
    flat = torch.full((h * w,), -1, dtype=torch.int32,
                      device=valid_mask.device)
    lin = (rows * w + cols)[node_valid].long()
    flat[lin] = torch.arange(n_pad, dtype=torch.int32,
                             device=valid_mask.device)[node_valid]
    return flat.reshape(h, w)


def enumerate_nodes(valid_mask: torch.Tensor, n_pad: int):
    """Valid cells compacted to node slots in row-major order (as
    ``np.nonzero``): (rows, cols, node_valid), [n_pad] each; padded slots
    hold cell (0, 0)."""
    rr, cc = torch.nonzero(valid_mask, as_tuple=True)
    n = rr.shape[0]
    if n > n_pad:
        raise ValueError(f"{n} valid cells > n_pad {n_pad}")
    rows = torch.zeros(n_pad, dtype=torch.int32, device=valid_mask.device)
    cols = torch.zeros_like(rows)
    rows[:n] = rr.to(torch.int32)
    cols[:n] = cc.to(torch.int32)
    node_valid = torch.arange(n_pad, device=valid_mask.device) < n
    return rows, cols, node_valid


def enumerate_edges_coo(valid_mask: torch.Tensor, rows: torch.Tensor,
                        cols: torch.Tensor, node_valid: torch.Tensor,
                        depth_filled: torch.Tensor,
                        resolution: Tuple[float, float], connectivity: int,
                        include_self_loops: bool = False):
    """Offset-major COO edges with their features: offset o's edges take
    slots [o * n_pad, (o + 1) * n_pad), edge (o, i) from node i (src) to
    its neighbour in direction o (dst), with the features of
    ``edge_features_for_offset`` at the source cell; the self loops (zero
    features) follow when ``include_self_loops``. Returns (src, dst,
    edge_attr, edge_mask), E_pad = n_offsets * n_pad (+ n_pad)."""
    offsets = offsets_for_connectivity(connectivity)
    n_pad = rows.shape[0]
    h, w = valid_mask.shape
    idx_flat = build_node_index_grid(valid_mask, rows, cols,
                                     node_valid).reshape(-1)
    node_ids = torch.arange(n_pad, dtype=torch.int32, device=rows.device)
    rl, cl = rows.long(), cols.long()
    zero_i = torch.zeros_like(node_ids)
    srcs, dsts, attrs, masks = [], [], [], []
    for dr, dc in offsets:
        nr, nc = rl + dr, cl + dc
        in_bounds = (nr >= 0) & (nr < h) & (nc >= 0) & (nc < w)
        nbr = idx_flat[nr.clamp(0, h - 1) * w + nc.clamp(0, w - 1)]
        ok = node_valid & in_bounds & (nbr >= 0)
        ea = edge_features_for_offset(depth_filled, dr, dc,
                                      resolution)[rl, cl]
        srcs.append(torch.where(ok, node_ids, zero_i))
        dsts.append(torch.where(ok, nbr, zero_i))
        attrs.append(torch.where(ok[:, None], ea, torch.zeros_like(ea)))
        masks.append(ok)
    if include_self_loops:
        srcs.append(torch.where(node_valid, node_ids, zero_i))
        dsts.append(torch.where(node_valid, node_ids, zero_i))
        attrs.append(torch.zeros(n_pad, 3, device=rows.device))
        masks.append(node_valid)
    return (torch.cat(srcs), torch.cat(dsts), torch.cat(attrs),
            torch.cat(masks))


def compact_edges(src: torch.Tensor, dst: torch.Tensor, attr: torch.Tensor,
                  mask: torch.Tensor, e_pad: int, n_pad: int,
                  sort_by_dst: bool = True):
    """Masked offset-major edges compacted into e_pad slots, live edges
    first in a stable sort by destination (``sort_by_dst``); padded slots
    have src 0, dst n_pad - 1 (the destinations stay non-decreasing), zero
    features and a False mask. Returns (src, dst, attr, mask)."""
    (idx,) = torch.nonzero(mask, as_tuple=True)
    n = idx.shape[0]
    if n > e_pad:
        raise ValueError(f"{n} edges > e_pad {e_pad}")
    if sort_by_dst:
        idx = idx[torch.sort(dst[idx], stable=True).indices]
    src_c = torch.zeros(e_pad, dtype=torch.int32, device=src.device)
    dst_c = torch.full((e_pad,), n_pad - 1, dtype=torch.int32,
                       device=src.device)
    attr_c = torch.zeros((e_pad,) + tuple(attr.shape[1:]), dtype=attr.dtype,
                         device=src.device)
    keep = torch.zeros(e_pad, dtype=torch.bool, device=src.device)
    src_c[:n] = src[idx].to(torch.int32)
    dst_c[:n] = dst[idx].to(torch.int32)
    attr_c[:n] = attr[idx]
    keep[:n] = True
    return src_c, dst_c, attr_c, keep


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
