"""Masked segment reductions over destination-sorted COO edges (port of
``bathymetric_gnn_tpu/ops/segment.py``: ``gather``, ``segment_sum``,
``segment_mean``, ``segment_max``, ``segment_softmax``).

The sums run in sorted order with no scatter-add: ``segment_sum`` is an
autograd Function whose forward is kernel F's mode (a)
(``ops/cuda/segment_reduce.segment_reduce_sorted``: the CUDA kernel for a
tensor on the card, its plain ``index_add_`` version for one on the CPU)
over a table of the entries grouped by segment, and whose backward is a
gather; ``gather``'s backward is the same F call over the table of its
indices (``CooGraph``'s source table for a gather by source). So a sum
never depends on the order the card's atomics happen to take, and a COO
train step on the card repeats bit for bit. ``segment_max`` is
``scatter_reduce`` ("amax"), which no order changes.

A table is ``(perm, row_ptr)`` as ``ops/graph.sorted_segments`` builds
it: the entries of segment j are ``perm[row_ptr[j]:row_ptr[j + 1]]``. The
callers pass the tables a ``CooGraph`` carries. The table of a masked sum
leaves the dead entries out; the table of a gather must hold every entry
whose cotangent may be nonzero, and a gather wants it only when a
gradient flows through it.

Semantics are the JAX functions': masked entries add exactly 0 (selected
out, never multiplied: NaN * 0 is NaN), empty segments of the max get
-inf (masked entries ``fill``) and the softmax makes that max finite
(``m_safe``) before it subtracts it, clamps its denominator at 1e-16 and
lets ``self_logits`` join each segment's group (GAT's self loop). The
softmax's max is taken without gradient: the softmax does not depend on
it, so its exact gradient through the max is 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .cuda import segment_reduce as sr

Table = Tuple[torch.Tensor, torch.Tensor]


def _bcast(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [E] mask against [E, ...] data."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def _sum_rows(data: torch.Tensor, perm, row_ptr, n: int) -> torch.Tensor:
    """Kernel F (mode a) of ``data`` [S, ...] -> [n, ...] in data's
    dtype."""
    out = sr.segment_reduce_sorted(data.reshape(data.shape[0], -1), perm,
                                   row_ptr, n)
    return out.to(data.dtype).reshape((n,) + tuple(data.shape[1:]))


class _SegmentSum(torch.autograd.Function):
    """Forward: kernel F over the table; backward: the output's cotangent
    gathered at each entry's segment (0 at dead entries)."""

    @staticmethod
    def forward(ctx, data, ids, live, perm, row_ptr, n):
        ctx.save_for_backward(ids, live)
        return _sum_rows(data, perm, row_ptr, n)

    @staticmethod
    def backward(ctx, g):
        ids, live = ctx.saved_tensors
        gd = g.index_select(0, ids.reshape(-1))
        if live is not None:
            gd = torch.where(_bcast(live, gd), gd, torch.zeros_like(gd))
        return gd, None, None, None, None, None


class _Gather(torch.autograd.Function):
    """Forward: x[idx]; backward: kernel F of the cotangent over the
    table of idx."""

    @staticmethod
    def forward(ctx, x, idx, perm, row_ptr):
        ctx.save_for_backward(perm, row_ptr)
        ctx.n = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        perm, row_ptr = ctx.saved_tensors
        return _sum_rows(g, perm, row_ptr, ctx.n), None, None, None


def gather(x: torch.Tensor, idx: torch.Tensor,
           table: Optional[Table]) -> torch.Tensor:
    """x[idx]: per-edge gather of node data (idx [E], x [N, ...]). With a
    gradient, its backward sums the cotangent over ``table`` (the
    entries of idx grouped by node), which may be None only when no
    gradient flows into x."""
    idx = idx.reshape(-1)
    if not (torch.is_grad_enabled() and x.requires_grad):
        return x.index_select(0, idx)
    if table is None:
        raise ValueError("a gather with a gradient needs the table of its "
                         "indices")
    return _Gather.apply(x, idx, *table)


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, edge_mask: Optional[torch.Tensor],
                table: Table) -> torch.Tensor:
    """Masked sum of per-edge data into per-node slots, in sorted order
    (kernel F). ``table``: the live entries grouped by segment."""
    return _SegmentSum.apply(data, segment_ids.reshape(-1), edge_mask,
                             *table, num_segments)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int, edge_mask: Optional[torch.Tensor],
                 table: Table) -> torch.Tensor:
    """Masked mean over incoming edges; segments with no edges get 0."""
    s = segment_sum(data, segment_ids, num_segments, edge_mask, table)
    ones = torch.ones(data.shape[0], dtype=data.dtype, device=data.device)
    if edge_mask is not None:
        ones = torch.where(edge_mask, ones, torch.zeros_like(ones))
    cnt = segment_sum(ones, segment_ids, num_segments, edge_mask, table)
    return s / _bcast(cnt.clamp_min(1.0), s)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int, edge_mask: Optional[torch.Tensor] = None,
                fill: float = -float("inf")) -> torch.Tensor:
    """Masked max over incoming edges: masked entries count as ``fill``,
    segments with no entries get -inf."""
    if edge_mask is not None:
        data = torch.where(_bcast(edge_mask, data), data,
                           torch.full_like(data, fill))
    idx = _bcast(segment_ids.reshape(-1).long(), data).expand_as(data)
    out = torch.full((num_segments,) + tuple(data.shape[1:]),
                     -float("inf"), dtype=data.dtype, device=data.device)
    return out.scatter_reduce(0, idx, data, "amax", include_self=True)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    edge_mask: Optional[torch.Tensor],
                    self_logits: Optional[torch.Tensor],
                    table: Table
                    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Numerically stable softmax over incoming edges per destination,
    each node's ``self_logits`` [N, ...] joining its group. Returns
    (edge weights [E, ...], self weights [N, ...] or None)."""
    ids = segment_ids.reshape(-1)
    with torch.no_grad():
        m = segment_max(logits, ids, num_segments, edge_mask)
        if self_logits is not None:
            m = torch.maximum(m, self_logits)
        m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    z = logits - m_safe.index_select(0, ids)
    if edge_mask is not None:
        # a dead entry's exp is selected out before it can overflow (its
        # zero cotangent times inf would be NaN)
        live = _bcast(edge_mask, z)
        z = torch.where(live, z, torch.zeros_like(z))
        e = torch.where(live, torch.exp(z), torch.zeros_like(z))
    else:
        e = torch.exp(z)
    denom = segment_sum(e, ids, num_segments, edge_mask, table)
    e_self = None
    if self_logits is not None:
        e_self = torch.exp(self_logits - m_safe)
        denom = denom + e_self
    denom = denom.clamp_min(1e-16)
    w = e / gather(denom, ids, table)
    return w, (e_self / denom if e_self is not None else None)
