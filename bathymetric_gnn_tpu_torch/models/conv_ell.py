"""GAT layers on the ELL layout (port of ``bathymetric_gnn_tpu/models/conv_ell.py``:
``GATConvELL`` and ``GATConvEllBanded``).

Both compute the PyG-exact GAT layer of the JAX modules, with their
parameter names and shapes (``lin_src`` [F, HC], ``att_src`` /
``att_dst`` / ``att_edge`` [1, heads, C], ``lin_edge`` [edge_dim, HC],
``bias``), so one state_dict drives either:

- ``GATConvELL``: plain PyTorch gathers, through kernel C's plain version
  ``ell_gat_reference`` on any device (the JAX ``sparse_kernel="xla"``
  route, which is plain XLA there too);
- ``GATConvEllBanded``: the layer of the k-NN path (JAX
  ``sparse_kernel="banded_pallas"``). x @ W and the edge-logit terms are
  computed here; the attention dots, masked softmax, attention dropout
  and weighted gather-sum run in ``ops/cuda/ell_gat_fused`` (kernel C on
  the card, its plain version on the CPU), which also adds the bias and
  applies the node mask. Serving (eval mode, no gradient) takes kernel
  C's inference form; training takes its dropout form with kernel C' as
  the backward, and ``lin_edge``/``att_edge`` get their gradients through
  autograd from C''s d el / d el_self. The port needs no band layout, so
  the JAX module's ``banded`` argument has no counterpart.

The GCN, GraphSAGE and GIN ELL layers of the JAX module are not ported.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.cuda import ell_gat_fused
from ..ops.ell import EllTrainGraph
from .grid_gat import _glorot
from .layers import keep_mask


def make_ell_dropout_mask(generator: torch.Generator, p: float, n: int,
                          k: int, heads: int) -> torch.Tensor:
    """Streamed post-softmax attention-dropout multipliers [N, K+1, heads]
    (slot K is the self loop), each 0 or 1/(1-p), drawn from
    ``generator`` on its device: the port's layout of the JAX
    ``make_banded_dropout_masks``. Draws are iid, so the layout changes
    only which weight each draw multiplies."""
    keep = 1.0 - p
    return keep_mask((n, k + 1, heads), keep, generator, generator.device
                     ).to(torch.float32) / keep


class _EllGATParams(nn.Module):
    """The parameters and the edge-logit matrix shared by both layers."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 4,
                 concat: bool = True, negative_slope: float = 0.2,
                 edge_dim: Optional[int] = None, add_self_loops: bool = True,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0):
        super().__init__()
        self.heads, self.out_channels = heads, out_channels
        self.concat = concat
        self.dropout = dropout
        self.negative_slope = negative_slope
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

    def _edge_terms(self, g):
        """(el [N, K, heads] or None, el_self [N, heads] or None): the edge
        attributes' logit terms, e @ M_edge with M_edge = att_edge .
        (W_edge e) collapsed to [edge_dim, heads], and the self loop's
        term from the mean of the live incoming attributes."""
        if self.edge_dim is None or g.edge_attr.shape[-1] == 0:
            return None, None
        h, c = self.heads, self.out_channels
        m_edge = torch.einsum(
            "fac,ac->fa", self.lin_edge.reshape(self.edge_dim, h, c),
            self.att_edge.reshape(h, c))
        el = g.edge_attr @ m_edge
        el_self = None
        if self.add_self_loops:
            mask = g.nbr_mask.to(torch.bool)
            cnt = mask.to(torch.float32).sum(1).clamp_min(1.0)
            mean_attr = torch.where(mask[..., None], g.edge_attr,
                                    torch.zeros_like(g.edge_attr)
                                    ).sum(1) / cnt[:, None]
            el_self = mean_attr @ m_edge
        return el, el_self

    def _finish(self, out: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
        """[N, heads, C] -> concat or head mean, + bias, node mask."""
        n = out.shape[0]
        out = (out.reshape(n, -1) if self.concat else out.mean(1))
        if self.bias is not None:
            out = out + self.bias
        return torch.where(node_mask[:, None], out, torch.zeros_like(out))


class GATConvELL(_EllGATParams):
    """PyG-exact GAT on the ELL layout in plain PyTorch (the plain version
    of kernel C, then concat or head mean, bias and the node mask). The
    JAX ``sparse_kernel="xla"`` route. It has no attention dropout: the
    COO/XLA training path comes with ROADMAP queue 1 item 11, so training
    mode with ``dropout`` > 0 raises."""

    def forward(self, g, x: torch.Tensor,
                dropout_rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """As ``GATConvEllBanded.forward``; ``dropout_rng`` is unused (no
        attention dropout here)."""
        if self.training and self.dropout > 0:
            raise NotImplementedError(
                "attention dropout on the plain ELL layer (the COO/XLA "
                "training path, ROADMAP.md queue 1 item 11) is not ported; "
                "train with sparse_kernel='banded_pallas'")
        el, el_self = self._edge_terms(g)
        out = ell_gat_fused.ell_gat_reference(
            x @ self.lin_src, self.att_src, self.att_dst, g.nbr_src,
            g.nbr_mask, el, el_self, self_loop=self.add_self_loops,
            negative_slope=self.negative_slope)
        return self._finish(
            out.reshape(x.shape[0], self.heads, self.out_channels),
            g.node_mask.to(torch.bool))


class GATConvEllBanded(_EllGATParams):
    """The k-NN layer: kernel C (``ell_gat_fused``) when serving, kernels C
    and C' (``ell_gat_fused_train``) when training or when a gradient is
    wanted."""

    def forward(self, g, x: torch.Tensor,
                dropout_rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """g: an ``ops.ell.EllGraph`` of tensors, x [N, F] -> [N, HC] (or
        [N, C] for the head mean). In training mode with ``dropout`` > 0
        the attention dropout draws from ``dropout_rng``: on the card one
        Philox seed per call (kernels C and C' draw the multipliers from
        it), on the CPU the streamed mask itself."""
        h, c = self.heads, self.out_channels
        xh = x.to(torch.float32) @ self.lin_src             # [N, HC]
        el, el_self = self._edge_terms(g)
        node_mask = g.node_mask.to(torch.bool)
        fold = self.concat or h == 1   # bias and mask fold into the kernel
        kw = dict(self_loop=self.add_self_loops,
                  bias=self.bias if fold else None, node_mask=node_mask,
                  negative_slope=self.negative_slope)
        args = (xh, self.att_src, self.att_dst, g.nbr_src, g.nbr_mask, el,
                el_self)
        if self.training or (torch.is_grad_enabled() and any(
                p.requires_grad for p in self.parameters())):
            out = ell_gat_fused.ell_gat_fused_train(
                *args, **kw, **self._dropout_args(g, dropout_rng),
                slot_tables=(g.slot_perm, g.slot_row_ptr)
                if isinstance(g, EllTrainGraph) else None)
        else:
            out = ell_gat_fused.ell_gat_fused(*args, **kw)
        if fold:
            return out
        return self._finish(out.reshape(x.shape[0], h, c), node_mask)

    def _dropout_args(self, g, dropout_rng) -> dict:
        if not (self.training and self.dropout > 0):
            return {}
        if dropout_rng is None:
            raise ValueError("attention dropout in training mode needs a "
                             "torch.Generator (dropout_rng)")
        keep = 1.0 - self.dropout
        n, k = g.nbr_src.shape
        if g.nbr_src.device.type == "cuda":
            seed = torch.randint(0, 2 ** 62, (1,), generator=dropout_rng,
                                 device=g.nbr_src.device, dtype=torch.int64)
            return dict(drop_seed=seed, keep_prob=keep)
        return dict(dmask=make_ell_dropout_mask(
            dropout_rng, self.dropout, n, k, self.heads), keep_prob=keep)
