"""Padded graph containers, packed on the host (port of
``bathymetric_gnn_tpu/ops/graph.py``: ``round_up_to_bucket``,
``PaddedGraph``, ``make_padded_graph``, ``batch_graphs``,
``merge_stacked``, ``csr_row_offsets``).

Graphs are built and batched on the host (NumPy), and a batch goes to the
device once: as an ELL graph (``ops/ell.coo_to_ell``) or, for the COO
model, as a ``CooGraph`` with its edge tables. Sizes are padded to node
buckets so a serving run sees a few shapes only; validity masks mark live
nodes and edges. Edges are stored COO sorted by destination (stable, so
each destination keeps its edges' input order), and padded edges point at
the last node slot so the destination array stays non-decreasing.

``sorted_segments`` groups entries by the node they name (a permutation
and a row pointer): the tables over which kernel F sums in sorted order
(``ops/cuda/segment_reduce``), for the COO model's segment sums and for
the backward of its gathers (``CooGraph``), and for the ELL layouts'
gathers (``ops/ell``, ``ops/ell_banded``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


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


def csr_row_offsets(edge_dst: np.ndarray, num_nodes: int) -> np.ndarray:
    """Row offsets per destination for dst-sorted edges (CSR by
    destination)."""
    counts = np.bincount(edge_dst, minlength=num_nodes)
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def sorted_segments(ids: np.ndarray, live: np.ndarray, n: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """(perm, row_ptr) of the entries of ``ids`` [S] grouped by the node
    (< n) each names: a stable argsort with the entries that ``live`` [S]
    marks dead keyed to n, and each node's range of it. The tables of
    ``src_sorted_slots``, of ``ops/ell_banded.band_ell`` and of
    ``CooGraph``."""
    ids = np.asarray(ids).reshape(-1)
    if ids.size >= 2 ** 31:
        raise ValueError(f"{ids.size} entries exceed int32")
    key = np.where(np.asarray(live, bool).reshape(-1), ids, n
                   ).astype(np.int64)
    perm = np.argsort(key, kind="stable").astype(np.int32)
    row_ptr = np.searchsorted(key[perm], np.arange(n + 1)).astype(np.int32)
    return perm, row_ptr


@dataclasses.dataclass
class CooGraph:
    """A PaddedGraph (the same nine fields) with the edge tables of the COO
    model's segment sums and of its gathers' backward, NumPy arrays as
    ``from_padded`` builds them, tensors after ``to``:

    - ``dst_perm`` / ``dst_row_ptr``: the live edges grouped by destination
      (``sorted_segments``), for every sum into destinations
      (``ops/segment.segment_sum`` and the backward of a gather by
      destination);
    - ``src_perm`` / ``src_row_ptr`` (None when no gradient is wanted):
      the live edges grouped by source (``sorted_segments``, a stable
      argsort), for the backward of a gather by source.

    Dead (padded) edges are in neither table: every layer selects them out
    before they reach an output, so their cotangents are zero."""

    x: object
    edge_src: object
    edge_dst: object
    edge_attr: object
    node_mask: object
    edge_mask: object
    pos: object
    local_std: object
    graph_id: object
    dst_perm: object
    dst_row_ptr: object
    src_perm: object = None
    src_row_ptr: object = None

    @property
    def dst_table(self):
        return self.dst_perm, self.dst_row_ptr

    @property
    def src_table(self):
        return (None if self.src_perm is None
                else (self.src_perm, self.src_row_ptr))

    @classmethod
    def from_padded(cls, g: PaddedGraph, src_table: bool = True
                    ) -> "CooGraph":
        """The tables of ``g`` (NumPy, on the host), the source table only
        with ``src_table`` (training)."""
        n = g.num_nodes_padded
        live = np.asarray(g.edge_mask, bool)
        fields = {f.name: np.asarray(getattr(g, f.name))
                  for f in dataclasses.fields(PaddedGraph)}
        dperm, dptr = sorted_segments(g.edge_dst, live, n)
        sperm = sptr = None
        if src_table:
            sperm, sptr = sorted_segments(g.edge_src, live, n)
        return cls(**fields, dst_perm=dperm, dst_row_ptr=dptr,
                   src_perm=sperm, src_row_ptr=sptr)

    def to(self, device) -> "CooGraph":
        """The same graph as torch tensors on ``device``."""
        return type(self)(**{
            f.name: (None if getattr(self, f.name) is None else
                     torch.as_tensor(getattr(self, f.name)).to(device))
            for f in dataclasses.fields(self)})
