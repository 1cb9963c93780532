"""Message-passing layers on COO graphs (port of
``bathymetric_gnn_tpu/models/conv.py``: ``GATConv``, ``GCNConv``,
``SAGEConv``, ``GINConv``).

The four conv families of the reference, PyG-exact (GATConv's injected
self loop with the mean of the incoming edge attributes included), as
masked segment reductions over destination-sorted padded edges
(``ops/segment``): every sum into destinations and every gather's backward
is kernel F on the card, its plain version on the CPU. Self loops are
never materialized: each node's self term is a dense [N, ...] term folded
into the softmax and the sums. Parameter names and shapes are the JAX
modules'.

The graph ``g`` is an ``ops.graph.CooGraph`` of tensors: the layers read
its destination table for their sums and, when a gradient is wanted, its
source table for the backward of their gathers by source. On the card the
matrix products take ``layers.fixed_rows_matmul`` (a node's result does
not depend on the rows served with it), on the CPU one product.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..ops import segment as seg
from .grid_gat import _glorot
from .layers import TorchLinear, keep_mask, matmul, zero_padded_nodes


class GATConv(nn.Module):
    """Graph attention layer, PyG-GATConv-exact. For an edge j -> i:
    e_ij = LeakyReLU(a_src . W x_j + a_dst . W x_i + a_edge . W_e e_ij),
    alpha_ij = softmax over {j in N(i)} and i itself (the injected self
    loop, whose edge attribute is the mean of i's incoming ones),
    out_i = sum_j alpha_ij W x_j + alpha_ii W x_i, heads concatenated or
    averaged, + bias, 0 on padded nodes."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 4,
                 concat: bool = True, negative_slope: float = 0.2,
                 dropout: float = 0.0, edge_dim: Optional[int] = None,
                 add_self_loops: bool = True, use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        self.concat = concat
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.edge_dim = edge_dim
        self.add_self_loops = add_self_loops
        hc = heads * out_channels
        self.lin_src = _glorot(generator, in_channels, hc)
        self.att_src = _glorot(generator, 1, heads, out_channels)
        self.att_dst = _glorot(generator, 1, heads, out_channels)
        if edge_dim is not None:
            self.lin_edge = _glorot(generator, edge_dim, hc)
            self.att_edge = _glorot(generator, 1, heads, out_channels)
        self.bias = (nn.Parameter(torch.zeros(hc if concat else out_channels))
                     if use_bias else None)

    def forward(self, g, x: torch.Tensor,
                dropout_rng: Optional[torch.Generator] = None,
                attn_keep: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
        """x [N, F] -> [N, HC] (or [N, C] for the head mean). In training
        mode with ``dropout`` > 0 the attention weights w_e [E, heads] and
        w_self [N, heads] are dropped by keep masks drawn from
        ``dropout_rng``, or by the streamed ``attn_keep`` = (keep_e,
        keep_self) bool masks when given."""
        h, c = self.heads, self.out_channels
        n = x.shape[0]
        src, dst, mask = g.edge_src, g.edge_dst, g.edge_mask
        dtab, stab = g.dst_table, g.src_table
        xh = matmul(x, self.lin_src).reshape(n, h, c)
        alpha_src = (xh * self.att_src).sum(-1)                  # [N, H]
        alpha_dst = (xh * self.att_dst).sum(-1)
        alpha_e = (seg.gather(alpha_src, src, stab)
                   + seg.gather(alpha_dst, dst, dtab))
        alpha_self = None
        if self.edge_dim is not None and g.edge_attr.shape[-1] > 0:
            # att_edge . (W_e e) collapsed to e @ M, M [edge_dim, heads]
            m_edge = torch.einsum(
                "fac,ac->fa", self.lin_edge.reshape(self.edge_dim, h, c),
                self.att_edge.reshape(h, c))
            alpha_e = alpha_e + matmul(g.edge_attr, m_edge)
            if self.add_self_loops:
                mean_attr = seg.segment_mean(g.edge_attr, dst, n, mask, dtab)
                alpha_self = alpha_src + alpha_dst + matmul(mean_attr, m_edge)
        elif self.add_self_loops:
            alpha_self = alpha_src + alpha_dst
        alpha_e = nn.functional.leaky_relu(alpha_e, self.negative_slope)
        if alpha_self is not None:
            alpha_self = nn.functional.leaky_relu(alpha_self,
                                                  self.negative_slope)
        w_e, w_self = seg.segment_softmax(alpha_e, dst, n, mask,
                                          self_logits=alpha_self, table=dtab)
        if self.training and self.dropout > 0:
            keep_e, keep_s = attn_keep if attn_keep is not None else \
                self._draw_keep(w_e.shape, n, dropout_rng)
            keep = 1.0 - self.dropout
            w_e = torch.where(keep_e, w_e / keep, torch.zeros_like(w_e))
            if w_self is not None:
                w_self = torch.where(keep_s, w_self / keep,
                                     torch.zeros_like(w_self))
        msgs = seg.gather(xh, src, stab) * w_e[..., None]         # [E, H, C]
        out = seg.segment_sum(msgs, dst, n, mask, dtab)
        if w_self is not None:
            out = out + xh * w_self[..., None]
        out = out.reshape(n, h * c) if self.concat else out.mean(1)
        if self.bias is not None:
            out = out + self.bias
        return zero_padded_nodes(out, g.node_mask)

    def _draw_keep(self, shape_e, n: int, rng: Optional[torch.Generator]):
        if rng is None:
            raise ValueError("attention dropout in training mode needs a "
                             "torch.Generator (dropout_rng)")
        keep = 1.0 - self.dropout
        dev = rng.device
        return (keep_mask(shape_e, keep, rng, dev),
                keep_mask((n, self.heads), keep, rng, dev))


class GCNConv(nn.Module):
    """PyG-exact GCN layer: sym-normalized aggregation with self loops,
    out_i = sum_{j->i} W x_j / sqrt(d_i d_j) + W x_i / d_i + bias,
    d = 1 + in-degree."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = _glorot(generator, in_channels, out_channels)
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def forward(self, g, x: torch.Tensor, dropout_rng=None) -> torch.Tensor:
        n = x.shape[0]
        src, dst, mask = g.edge_src, g.edge_dst, g.edge_mask
        xw = matmul(x, self.kernel)
        ones = mask.to(torch.float32)
        deg = (seg.segment_sum(ones, dst, n, mask, g.dst_table)
               + g.node_mask.to(torch.float32))
        dinv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)),
                           torch.zeros_like(deg))
        norm = (seg.gather(dinv, src, g.src_table)
                * seg.gather(dinv, dst, g.dst_table))
        msgs = seg.gather(xw, src, g.src_table) * norm[:, None]
        out = seg.segment_sum(msgs, dst, n, mask, g.dst_table)
        out = out + xw * (dinv * dinv)[:, None]           # the self loop
        if self.bias is not None:
            out = out + self.bias
        return zero_padded_nodes(out, g.node_mask)


class SAGEConv(nn.Module):
    """PyG-exact GraphSAGE (mean aggregator):
    out_i = W_l mean_{j->i} x_j + b_l + W_r x_i."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin_l = _glorot(generator, in_channels, out_channels)
        self.bias_l = nn.Parameter(torch.zeros(out_channels))
        self.lin_r = _glorot(generator, in_channels, out_channels)

    def forward(self, g, x: torch.Tensor, dropout_rng=None) -> torch.Tensor:
        n = x.shape[0]
        agg = seg.segment_mean(seg.gather(x, g.edge_src, g.src_table),
                               g.edge_dst, n, g.edge_mask, g.dst_table)
        out = matmul(agg, self.lin_l) + self.bias_l + matmul(x, self.lin_r)
        return zero_padded_nodes(out, g.node_mask)


class GINConv(nn.Module):
    """PyG-exact GIN: mlp((1 + eps) x_i + sum_{j->i} x_j), eps 0 fixed,
    the inner MLP Linear-ReLU-Linear (``TorchLinear_0``, ``TorchLinear_1``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 eps: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.eps = eps
        self.TorchLinear_0 = TorchLinear(in_channels, out_channels, generator)
        self.TorchLinear_1 = TorchLinear(out_channels, out_channels,
                                         generator)

    def forward(self, g, x: torch.Tensor, dropout_rng=None) -> torch.Tensor:
        n = x.shape[0]
        agg = seg.segment_sum(seg.gather(x, g.edge_src, g.src_table),
                              g.edge_dst, n, g.edge_mask, g.dst_table)
        z = (1.0 + self.eps) * x + agg
        z = self.TorchLinear_1(torch.relu(self.TorchLinear_0(z)))
        return zero_padded_nodes(z, g.node_mask)
