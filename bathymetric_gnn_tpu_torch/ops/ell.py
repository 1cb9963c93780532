"""ELL (padded incidence-list) graph layout (port of
``bathymetric_gnn_tpu/ops/ell.py``).

For bounded-degree graphs (k-NN: degree k) edges are stored
destination-major as [N, K] source indices + mask, so message passing is
gather-only: the segment softmax becomes a masked softmax over the slot
axis and aggregation a weighted sum over K gathered rows. ``coo_to_ell``
packs on the host (NumPy); ``EllGraph.to`` moves a packed graph to the
device in one go. The backward of the gather (the sum over each source's
slots) runs over the source-sorted slot tables of ``src_sorted_slots``,
also built on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .graph import PaddedGraph, sorted_segments


@dataclasses.dataclass
class EllGraph:
    """Destination-major padded incidence list: x [N, F], nbr_src [N, K]
    int32 (0 in dead slots), nbr_mask [N, K] bool, edge_attr [N, K, Fe],
    node_mask [N] bool, pos, local_std, graph_id as in PaddedGraph. NumPy
    arrays as ``coo_to_ell`` builds it, tensors after ``to``."""

    x: object
    nbr_src: object
    nbr_mask: object
    edge_attr: object
    node_mask: object
    pos: object
    local_std: object
    graph_id: object

    @property
    def num_nodes_padded(self) -> int:
        return self.x.shape[0]

    @property
    def max_degree(self) -> int:
        return self.nbr_src.shape[1]

    def to(self, device) -> "EllGraph":
        """The same graph as torch tensors on ``device``."""
        return type(self)(**{
            f.name: torch.as_tensor(getattr(self, f.name)).to(device)
            for f in dataclasses.fields(self)})

    def with_src_sorted_slots(self) -> "EllTrainGraph":
        """This (NumPy) graph with its source-sorted slot tables."""
        perm, row_ptr = src_sorted_slots(self.nbr_src, self.nbr_mask,
                                         self.node_mask)
        return EllTrainGraph(**{f.name: getattr(self, f.name)
                                for f in dataclasses.fields(EllGraph)},
                             slot_perm=perm, slot_row_ptr=row_ptr)


@dataclasses.dataclass
class EllTrainGraph(EllGraph):
    """An EllGraph with the source-sorted slot tables of
    ``src_sorted_slots`` (``slot_perm`` [N * K], ``slot_row_ptr``
    [N + 1]), over which the layer's backward reduces: the trainer builds
    them on the host once per batch."""

    slot_perm: object
    slot_row_ptr: object


def coo_to_ell(g: PaddedGraph, max_degree: Optional[int] = None) -> EllGraph:
    """Host-side conversion from dst-sorted COO to ELL: each destination's
    edges fill its slots in their COO order."""
    src = np.asarray(g.edge_src)
    dst = np.asarray(g.edge_dst)
    mask = np.asarray(g.edge_mask)
    attr = np.asarray(g.edge_attr)
    n = g.num_nodes_padded
    fe = attr.shape[1]

    live_src = src[mask]
    live_dst = dst[mask]
    live_attr = attr[mask]
    deg = np.bincount(live_dst, minlength=n)
    k = int(max_degree if max_degree is not None
            else (deg.max() if deg.size else 1))
    k = max(k, 1)
    if deg.size and deg.max() > k:
        raise ValueError(f"max degree {deg.max()} exceeds ELL width {k}")

    nbr_src = np.zeros((n, k), np.int32)
    nbr_mask = np.zeros((n, k), bool)
    eattr = np.zeros((n, k, fe), np.float32)
    slot = np.arange(len(live_dst)) - np.concatenate(
        [[0], np.cumsum(deg)])[live_dst]
    nbr_src[live_dst, slot] = live_src
    nbr_mask[live_dst, slot] = True
    eattr[live_dst, slot] = live_attr

    return EllGraph(x=g.x, nbr_src=nbr_src, nbr_mask=nbr_mask,
                    edge_attr=eattr, node_mask=g.node_mask, pos=g.pos,
                    local_std=g.local_std, graph_id=g.graph_id)


def src_sorted_slots(nbr_src: np.ndarray, nbr_mask: np.ndarray,
                     node_mask: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Source-sorted view of the live slots of an ELL graph, for the
    backward of its row gather (the counterpart of ``band_ell``'s
    ``spill_perm``/``spill_src_sorted`` and reducer tables in the JAX
    package's ``ops/ell_banded.py``).

    Returns (perm [N * K] int32, row_ptr [N + 1] int32): ``perm`` is a
    stable argsort of the flat slots (slot = dst * K + k) by source node,
    with dead slots (and the slots of padded destinations, when
    ``node_mask`` is given) keyed to N so that they sort past
    ``row_ptr[N]`` and are never read; the slots of source j are
    ``perm[row_ptr[j]:row_ptr[j + 1]]``, in ascending slot order, so a
    reduction over them runs in the same order every time.
    """
    src = np.asarray(nbr_src)
    live = np.asarray(nbr_mask, bool)
    n, k = src.shape
    if node_mask is not None:
        live = live & np.asarray(node_mask, bool)[:, None]
    return sorted_segments(src.reshape(-1), live.reshape(-1), n)


def ell_gather(x: torch.Tensor, nbr_src: torch.Tensor) -> torch.Tensor:
    """[N, ...] gathered at [N, K] -> [N, K, ...]."""
    n, k = nbr_src.shape
    return x.index_select(0, nbr_src.reshape(-1).long()).reshape(
        (n, k) + x.shape[1:])


def ell_masked_softmax(
    logits: torch.Tensor,        # [N, K, ...] per-incoming-edge logits
    mask: torch.Tensor,          # [N, K] bool
    self_logits: Optional[torch.Tensor] = None,   # [N, ...]
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Masked softmax over the slot axis, optionally joined by a per-node
    self term (GAT's self loop). Dead slots are selected out, never
    multiplied, so a non-finite logit there cannot leak in."""
    m_b = mask.reshape(mask.shape + (1,) * (logits.dim() - mask.dim()))
    neg = torch.full_like(logits, -1e30)
    ml = torch.where(m_b, logits, neg)
    m = ml.max(dim=1).values
    if self_logits is not None:
        m = torch.maximum(m, self_logits)
    e = torch.exp(ml - m[:, None])
    e = torch.where(m_b, e, torch.zeros_like(e))
    denom = e.sum(dim=1)
    e_self = None
    if self_logits is not None:
        e_self = torch.exp(self_logits - m)
        denom = denom + e_self
    denom = denom.clamp_min(1e-16)
    return e / denom[:, None], (e_self / denom if e_self is not None
                                else None)
