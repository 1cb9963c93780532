"""Padded graph containers, packed on the host (port of
``bathymetric_gnn_tpu/ops/graph.py``: ``round_up_to_bucket``,
``PaddedGraph``, ``make_padded_graph``, ``batch_graphs``,
``merge_stacked``).

Everything stays NumPy here: graphs are built and batched on the host, and
a batch goes to the device once, after ``ops/ell.coo_to_ell``. Sizes are
padded to node buckets so a serving run sees a few shapes only; validity
masks mark live nodes and edges. Edges are stored COO sorted by
destination (stable, so each destination keeps its edges' input order),
and padded edges point at the last node slot so the destination array
stays non-decreasing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np


def round_up_to_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; raises when n exceeds every bucket."""
    for b in buckets:
        if n <= b:
            return int(b)
    raise ValueError(f"size {n} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass
class PaddedGraph:
    """A batch of graph data padded to static shapes (NumPy arrays).

    x [N_pad, F] (zero rows for padding), edge_src / edge_dst [E_pad]
    int32 (dst ascending, pads at N_pad - 1), edge_attr [E_pad, Fe],
    node_mask [N_pad] / edge_mask [E_pad] bool, pos [N_pad, 2] (col, row),
    local_std [N_pad] (the correction normalizer), graph_id [N_pad] int32
    (owning graph of each node in a batch).
    """

    x: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_attr: np.ndarray
    node_mask: np.ndarray
    edge_mask: np.ndarray
    pos: np.ndarray
    local_std: np.ndarray
    graph_id: np.ndarray

    @property
    def num_nodes_padded(self) -> int:
        return self.x.shape[0]

    @property
    def num_edges_padded(self) -> int:
        return self.edge_src.shape[0]


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    out = np.zeros((rows,) + a.shape[1:], dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def make_padded_graph(
    x: np.ndarray,
    edge_index: np.ndarray,
    edge_attr: Optional[np.ndarray],
    *,
    n_pad: int,
    e_pad: int,
    pos: Optional[np.ndarray] = None,
    local_std: Optional[np.ndarray] = None,
    graph_id: Optional[np.ndarray] = None,
    sort_by_dst: bool = True,
) -> PaddedGraph:
    """Pack host arrays (x [N, F], edge_index [2, E] (src, dst), edge_attr
    [E, Fe] or None) into a PaddedGraph of n_pad nodes and e_pad edges."""
    n = x.shape[0]
    e = edge_index.shape[1] if edge_index.size else 0
    if n > n_pad:
        raise ValueError(f"{n} nodes > n_pad {n_pad}")
    if e > e_pad:
        raise ValueError(f"{e} edges > e_pad {e_pad}")
    if edge_attr is None:
        edge_attr = np.zeros((e, 0), np.float32)
    src = edge_index[0].astype(np.int32)
    dst = edge_index[1].astype(np.int32)
    if sort_by_dst and e > 0:
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        edge_attr = edge_attr[order]

    node_mask = np.zeros(n_pad, bool)
    node_mask[:n] = True
    edge_mask = np.zeros(e_pad, bool)
    edge_mask[:e] = True
    dst_pad = np.full(e_pad, n_pad - 1, np.int32)
    dst_pad[:e] = dst
    src_pad = np.zeros(e_pad, np.int32)
    src_pad[:e] = src

    def opt(a, shape, dtype):
        return (_pad_rows(np.asarray(a, dtype), n_pad) if a is not None
                else np.zeros(shape, dtype))

    return PaddedGraph(
        x=_pad_rows(np.asarray(x, np.float32), n_pad),
        edge_src=src_pad,
        edge_dst=dst_pad,
        edge_attr=_pad_rows(np.asarray(edge_attr, np.float32), e_pad),
        node_mask=node_mask,
        edge_mask=edge_mask,
        pos=opt(pos, (n_pad, 2), np.float32),
        local_std=opt(local_std, (n_pad,), np.float32),
        graph_id=opt(graph_id, (n_pad,), np.int32),
    )


def batch_graphs(
    graphs: Sequence[Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]],
    *,
    n_pad: int,
    e_pad: int,
    pos_list: Optional[Sequence[np.ndarray]] = None,
    local_std_list: Optional[Sequence[np.ndarray]] = None,
) -> Tuple[PaddedGraph, np.ndarray]:
    """Concatenate many small graphs (x, edge_index, edge_attr) into one
    PaddedGraph: node indices are offset and graph_id records the owning
    graph of each node. Returns (graph, node count of each graph)."""
    xs, srcs, dsts, attrs, gids, poss, stds = [], [], [], [], [], [], []
    offset = 0
    counts = []
    for gi, (x, edge_index, edge_attr) in enumerate(graphs):
        n = x.shape[0]
        counts.append(n)
        xs.append(np.asarray(x, np.float32))
        if edge_index.size:
            srcs.append(edge_index[0].astype(np.int64) + offset)
            dsts.append(edge_index[1].astype(np.int64) + offset)
        if edge_attr is not None and edge_attr.size:
            attrs.append(np.asarray(edge_attr, np.float32))
        gids.append(np.full(n, gi, np.int32))
        if pos_list is not None:
            poss.append(np.asarray(pos_list[gi], np.float32))
        if local_std_list is not None:
            stds.append(np.asarray(local_std_list[gi], np.float32))
        offset += n

    x = np.concatenate(xs, 0) if xs else np.zeros((0, 1), np.float32)
    if srcs:
        edge_index = np.stack([np.concatenate(srcs), np.concatenate(dsts)], 0)
    else:
        edge_index = np.zeros((2, 0), np.int64)
    g = make_padded_graph(
        x, edge_index, np.concatenate(attrs, 0) if attrs else None,
        n_pad=n_pad, e_pad=e_pad,
        pos=np.concatenate(poss, 0) if poss else None,
        local_std=np.concatenate(stds, 0) if stds else None,
        graph_id=np.concatenate(gids) if gids else None,
    )
    return g, np.asarray(counts, np.int64)


def merge_stacked(batched: PaddedGraph) -> PaddedGraph:
    """Flatten a stacked [B, ...] PaddedGraph (``training/datasets.
    collate_samples``) into one graph of B * N_pad nodes: node arrays
    reshape to [B * N_pad, ...], edge indices are offset by i * N_pad and
    ``graph_id`` records each node's sample. Padded edges of each sample
    target its slot N_pad - 1, so the merged destinations stay
    non-decreasing (``ops/ell.coo_to_ell`` takes them as they are), and a
    BatchNorm sees the live nodes of the whole batch."""
    b, n_pad = np.asarray(batched.node_mask).shape
    offsets = (np.arange(b, dtype=np.int32) * n_pad)[:, None]

    def flat(a):
        a = np.asarray(a)
        return a.reshape((-1,) + a.shape[2:])

    return PaddedGraph(
        x=flat(batched.x),
        edge_src=flat(np.asarray(batched.edge_src) + offsets),
        edge_dst=flat(np.asarray(batched.edge_dst) + offsets),
        edge_attr=flat(batched.edge_attr),
        node_mask=flat(batched.node_mask),
        edge_mask=flat(batched.edge_mask),
        pos=flat(batched.pos),
        local_std=flat(batched.local_std),
        graph_id=np.repeat(np.arange(b, dtype=np.int32), n_pad),
    )
