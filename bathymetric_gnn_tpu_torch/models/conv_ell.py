"""Message-passing layers on the ELL layout (port of
``bathymetric_gnn_tpu/models/conv_ell.py``: ``GATConvELL``,
``GATConvEllBanded``, ``GCNConvELL``, ``SAGEConvELL``, ``GINConvELL``,
``make_banded_dropout_masks`` and ``banded_masks_wide_to_khn``).

Both layers compute the PyG-exact GAT layer of the JAX modules, with their
parameter names and shapes (``lin_src`` [F, HC], ``att_src`` /
``att_dst`` / ``att_edge`` [1, heads, C], ``lin_edge`` [edge_dim, HC],
``bias``), so one state_dict drives either:

- ``GATConvELL``: the JAX ``sparse_kernel="xla"`` route (plain XLA there),
  whose function, the true-max softmax over the live slots and the self
  loop, is kernel C's: kernel C serving and kernels C and C' with a
  gradient (``ops/cuda/ell_gat_fused``) on the card, their plain version
  on the CPU;
- ``GATConvEllBanded``: the layer of the k-NN path, on the routes of the
  JAX module. Route C (JAX ``sparse_kernel="banded_pallas"``, the wide
  kernel): x @ W and the edge-logit terms are computed here; the attention
  dots, masked softmax, attention dropout and weighted gather-sum run in
  ``ops/cuda/ell_gat_fused`` (kernel C, and C' as its backward), which
  also adds the bias and applies the node mask; it needs no band layout.
  Routes D (``wide_kernel=False``: kernels D and D') and E (JAX
  ``sparse_kernel="banded"``: kernel E and the spill fold when serving,
  the JAX route's plain band part and spill pass when a gradient is
  wanted) run in ``ops/cuda/ell_gat_banded`` on the band/spill
  decomposition (``ops/ell_banded.band_ell``) passed as ``banded``.

``compute_dtype="bfloat16"`` (the JAX module's): x @ W runs on bf16
operands with a bf16 result, the kernels take their bf16 forms, and the
layer's output is bf16 on routes C and D and f32 on route E (its spill
fold works in f32), the bias added in the output's dtype, as in JAX.

On the card the kernels run, on the CPU their plain versions. The GCN,
GraphSAGE and GIN layers (the JAX module's, which run no kernel either) are
gathers over the slots and masked sums over the slot axis in torch ops on
both devices, their products through ``layers.matmul`` (fixed-row
products on the card); the serving paths run them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.cuda import ell_gat_banded, ell_gat_fused
from ..ops.ell import EllTrainGraph, ell_gather
from ..ops.ell_banded import (NEG_BIG, banded_gat_band_part_xla,
                              banded_gat_spill_pass,
                              banded_gat_spill_pass_flat)
from .grid_gat import _glorot
from .layers import TorchLinear, keep_mask, matmul, zero_padded_nodes

BANDED_DROPOUT_NEEDS_FUSED = (
    "attention dropout on the banded path needs the fused kernel "
    "(use_pallas=True, spill_in_kernel=True); train with GATConvELL "
    "otherwise (same parameters)")
COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


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


def make_banded_dropout_masks(generator: torch.Generator, dropout: float,
                              n: int, k: int, heads: int, spill_shape):
    """Streamed post-softmax attention-dropout multipliers for kernels D
    and D': ([(K+1) * heads, N] in-band slots and self loop (row k * heads
    + h; the self loop at k = K), [T, heads, S] spill entries), each 0 or
    1/(1-p), drawn from ``generator`` on its device (``spill_shape`` is
    ``spill_dst_local_b``'s [T, 1, S]). The JAX function's ``wide=False``
    layout; the same draw feeds forward and backward."""
    t_count, _, s_max = spill_shape
    keep = 1.0 - dropout
    dm = keep_mask(((k + 1) * heads, n), keep, generator, generator.device)
    dm_sp = keep_mask((t_count, heads, s_max), keep, generator,
                      generator.device)
    return dm.to(torch.float32) / keep, dm_sp.to(torch.float32) / keep


def banded_masks_wide_to_khn(dm_w: torch.Tensor, k: int,
                             heads: int) -> torch.Tensor:
    """[T, H, (K+1) * R] wide-layout mask -> [(K+1) * H, N]: element
    (t, h, kk * R + r) maps to (kk * H + h, t * R + r)."""
    t_count, h_dim, _ = dm_w.shape
    r_band = dm_w.shape[-1] // (k + 1)
    return (dm_w.reshape(t_count, h_dim, k + 1, r_band)
            .permute(2, 1, 0, 3).reshape((k + 1) * heads, t_count * r_band))


class _EllGATParams(nn.Module):
    """The parameters and the edge-logit matrix shared by both layers."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 4,
                 concat: bool = True, negative_slope: float = 0.2,
                 edge_dim: Optional[int] = None, add_self_loops: bool = True,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0, compute_dtype: str = "float32"):
        super().__init__()
        if compute_dtype not in COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype {compute_dtype!r}: float32 or "
                             "bfloat16")
        self.compute_dtype = compute_dtype
        self.cd = COMPUTE_DTYPES[compute_dtype]
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

    def _grad_wanted(self) -> bool:
        return self.training or (torch.is_grad_enabled() and any(
            p.requires_grad for p in self.parameters()))

    def _forward_c(self, g, x: torch.Tensor,
                   dropout_rng: Optional[torch.Generator] = None
                   ) -> torch.Tensor:
        """Route C: x @ W and the edge-logit terms here; the attention
        dots, masked softmax, attention dropout and weighted gather-sum in
        ``ops/cuda/ell_gat_fused`` (kernel C serving; kernels C and C'
        when a gradient is wanted), which also adds the bias and applies
        the node mask when the heads concatenate."""
        h, c = self.heads, self.out_channels
        xh = x.to(self.cd) @ self.lin_src.to(self.cd)        # [N, HC]
        el, el_self = self._edge_terms(g)
        node_mask = g.node_mask.to(torch.bool)
        fold = self.concat or h == 1   # bias and mask fold into the kernel
        kw = dict(self_loop=self.add_self_loops,
                  bias=self.bias if fold else None, node_mask=node_mask,
                  negative_slope=self.negative_slope)
        args = (xh, self.att_src, self.att_dst, g.nbr_src, g.nbr_mask, el,
                el_self)
        if self._grad_wanted():
            out = ell_gat_fused.ell_gat_fused_train(
                *args, **kw, **self._dropout_args(g, dropout_rng),
                slot_tables=(g.slot_perm, g.slot_row_ptr)
                if isinstance(g, EllTrainGraph) else None)
        else:
            out = ell_gat_fused.ell_gat_fused(*args, **kw)
        if fold:
            return out
        return self._finish(out.reshape(x.shape[0], h, c), node_mask)

    def _dropout_rng(self, dropout_rng):
        """The generator of the attention dropout, or None without it."""
        if not (self.training and self.dropout > 0):
            return None
        if dropout_rng is None:
            raise ValueError("attention dropout in training mode needs a "
                             "torch.Generator (dropout_rng)")
        return dropout_rng

    def _dropout_args(self, g, dropout_rng) -> dict:
        dropout_rng = self._dropout_rng(dropout_rng)
        if dropout_rng is None:
            return {}
        keep = 1.0 - self.dropout
        n, k = g.nbr_src.shape
        if g.nbr_src.device.type == "cuda":
            seed = torch.randint(0, 2 ** 62, (1,), generator=dropout_rng,
                                 device=g.nbr_src.device, dtype=torch.int64)
            return dict(drop_seed=seed, keep_prob=keep)
        return dict(dmask=make_ell_dropout_mask(
            dropout_rng, self.dropout, n, k, self.heads), keep_prob=keep)

    def _finish(self, out: torch.Tensor,
                node_mask: torch.Tensor) -> torch.Tensor:
        """[N, heads, C] -> concat or head mean, + bias (in the output's
        dtype, as JAX's ``b.astype(out.dtype)``), node mask."""
        n = out.shape[0]
        out = (out.reshape(n, -1) if self.concat else out.mean(1))
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return torch.where(node_mask[:, None], out, torch.zeros_like(out))


class GATConvELL(_EllGATParams):
    """PyG-exact GAT on the ELL layout, the JAX ``sparse_kernel="xla"``
    route (then concat or head mean, bias and the node mask): kernel C
    (``ell_gat_fused``) when serving, kernels C and C'
    (``ell_gat_fused_train``) when a gradient is wanted, on the card; their
    plain version on the CPU. In training mode with ``dropout`` > 0 the
    attention weights and the self weight are dropped after the softmax,
    as the JAX layer's Bernoulli masks do: on the card by kernel C's
    dropout form (one Philox seed a call, regenerated by C'), on the CPU
    by a streamed mask."""

    def forward(self, g, x: torch.Tensor,
                dropout_rng: Optional[torch.Generator] = None,
                banded=None) -> torch.Tensor:
        """As ``GATConvEllBanded.forward`` on route C; ``banded`` is
        unused (no band layout here)."""
        return self._forward_c(g, x, dropout_rng)


class GATConvEllBanded(_EllGATParams):
    """The k-NN layer, on one of three routes picked as the JAX module
    picks them (``use_pallas``, ``spill_in_kernel``, ``wide_kernel``, with
    its defaults; the device, not ``use_pallas``, decides between a kernel
    and its plain version):

    - C (``use_pallas``, ``spill_in_kernel`` and ``wide_kernel``): kernel C
      (``ell_gat_fused``) when serving, kernels C and C'
      (``ell_gat_fused_train``) when training or when a gradient is wanted;
      no band layout needed;
    - D (``use_pallas`` and ``spill_in_kernel``, not ``wide_kernel``):
      kernel D (``ell_gat_banded.ell_gat_fused_v2``), with D' as its
      backward and streamed attention dropout;
    - E (otherwise; JAX's XLA form when ``use_pallas`` is off): kernel E
      (``ell_gat_band_part``) and the spill fold
      (``ops/ell_banded.banded_gat_spill_pass_flat``) when serving; when a
      gradient is wanted (training, dropout 0), the JAX XLA route's own
      math (``banded_gat_band_part_xla`` and ``banded_gat_spill_pass``),
      differentiated by autograd. That is no fallback: the JAX route runs
      no Pallas kernel there either (kernel E has no VJP).

    D and E read the ``banded`` decomposition (``ops/ell_banded.band_ell``
    of the same graph) passed to ``forward``.
    """

    def __init__(self, *args, use_pallas: bool = False,
                 spill_in_kernel: bool = True, wide_kernel: bool = True,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.use_pallas = use_pallas
        self.spill_in_kernel = spill_in_kernel
        self.wide_kernel = wide_kernel

    @property
    def route(self) -> str:
        """"C", "D" or "E": the kernels this layer runs."""
        if self.use_pallas and self.spill_in_kernel:
            return "C" if self.wide_kernel else "D"
        return "E"

    def forward(self, g, x: torch.Tensor,
                dropout_rng: Optional[torch.Generator] = None,
                banded=None) -> torch.Tensor:
        """g: an ``ops.ell.EllGraph`` of tensors, x [N, F] -> [N, HC] (or
        [N, C] for the head mean); ``banded``: its ``BandedEll`` of tensors
        (routes D and E). In training mode with ``dropout`` > 0 the
        attention dropout draws from ``dropout_rng``: on route C on the
        card one Philox seed per call (kernels C and C' draw the
        multipliers from it), else the streamed masks themselves."""
        if (self.training and self.dropout > 0
                and not (self.use_pallas and self.spill_in_kernel)):
            raise NotImplementedError(BANDED_DROPOUT_NEEDS_FUSED)
        if self.route != "C":
            return self._forward_banded(g, x, dropout_rng, banded)
        return self._forward_c(g, x, dropout_rng)

    def banded_inputs(self, g, banded, x: torch.Tensor,
                      fold_dots: bool = False) -> dict:
        """The inputs of kernels D and E for x [N, F] on g and its
        ``banded`` decomposition, as the JAX module builds them: xh
        [N, heads, C] (in the compute dtype), the attention dots a_src /
        a_dst [N, heads] (f32; with ``fold_dots`` as x @ (W . att), the JAX
        serving form), the block-diagonal a_cat_mat [HC, 2 * heads], el_t
        [K * heads, N] (the edge logits of banded's static attributes plus
        the NEG_BIG mask of dead and spilled slots, the mask in x's dtype
        as JAX casts it), el_self_t [heads, N] or None, m_edge [edge_dim,
        heads] or None. Mixed products compute as jnp promotes them: in
        f32, from the bf16 values."""
        h, c = self.heads, self.out_channels
        n, k = g.nbr_src.shape
        x_dtype = x.dtype
        x = x.to(torch.float32)
        xh2 = x.to(self.cd) @ self.lin_src.to(self.cd)        # [N, HC]
        if fold_dots:
            w3 = self.lin_src.reshape(x.shape[-1], h, c)
            a_src = x @ torch.einsum("fhc,hc->fh", w3,
                                     self.att_src.reshape(h, c))
            a_dst = x @ torch.einsum("fhc,hc->fh", w3,
                                     self.att_dst.reshape(h, c))
        else:
            x3 = xh2.reshape(n, h, c).to(torch.float32)
            a_src = (x3 * self.att_src).sum(-1)               # [N, H]
            a_dst = (x3 * self.att_dst).sum(-1)
        m_edge = None
        if self.edge_dim is not None and g.edge_attr.shape[-1] > 0:
            m_edge = torch.einsum(
                "fac,ac->fa", self.lin_edge.reshape(self.edge_dim, h, c),
                self.att_edge.reshape(h, c))
        if banded.negmask_t.shape[0] == k * h:
            negmask_t = banded.negmask_t.to(x_dtype)
        else:  # banded built for another head count: rebuild
            negmask_t = torch.where(
                banded.loc_t < 0, torch.full_like(banded.loc_t, NEG_BIG,
                                                  dtype=torch.float32),
                torch.zeros_like(banded.loc_t, dtype=torch.float32)
            ).repeat_interleave(h, dim=0).to(x_dtype)
        if m_edge is not None:
            el_t = torch.einsum("kfn,fh->khn", banded.eattr_t, m_edge
                                ).reshape(k * h, n) + negmask_t
            el_self_t = (m_edge.T @ banded.mean_attr_t
                         if self.add_self_loops else None)
        else:
            el_t = negmask_t.to(torch.float32)
            el_self_t = (torch.zeros(h, n, device=x.device)
                         if self.add_self_loops else None)
        col_head = torch.arange(h * c, device=x.device)[:, None] // c
        diag = (col_head == torch.arange(h, device=x.device)[None, :]
                ).to(torch.float32)
        a_cat_mat = torch.cat([diag * self.att_src.reshape(h * c)[:, None],
                               diag * self.att_dst.reshape(h * c)[:, None]],
                              dim=1)
        return dict(xh=xh2.reshape(n, h, c), a_src=a_src, a_dst=a_dst,
                    a_cat_mat=a_cat_mat, el_t=el_t, el_self_t=el_self_t,
                    m_edge=m_edge)

    def _forward_banded(self, g, x, dropout_rng, banded) -> torch.Tensor:
        """Routes D and E (as the JAX module's ``use_pallas`` branches,
        ``conv_ell.py:200-352``)."""
        if banded is None:
            raise ValueError(
                "sparse_kernel=banded* needs the BandedEll structure "
                "(pass banded=band_ell(g))")
        route = self.route
        h, c = self.heads, self.out_channels
        n, k = g.nbr_src.shape
        # serving on route D folds W into the attention dots, as JAX does
        kw = self.banded_inputs(g, banded, x,
                                fold_dots=route == "D" and not self.training)
        if route == "E" and self._grad_wanted():
            return self._finish(self._xla_band_spill(g, banded, kw),
                                g.node_mask.to(torch.bool))
        if route == "D":
            rng = self._dropout_rng(dropout_rng)
            masks = None if rng is None else make_banded_dropout_masks(
                rng, self.dropout, n, k, h,
                tuple(banded.spill_dst_local_b.shape))
            out2 = ell_gat_banded.ell_gat_fused_v2(
                **kw, banded=banded, negative_slope=self.negative_slope,
                dropout_masks=masks)
        else:
            y2, m, denom = ell_gat_banded.ell_gat_band_part(
                kw["xh"], kw["a_cat_mat"], kw["el_t"], kw["el_self_t"],
                banded, negative_slope=self.negative_slope)
            out2 = banded_gat_spill_pass_flat(
                y2, m, denom, kw["xh"].reshape(n, h * c),
                torch.cat([kw["a_src"], kw["a_dst"]], dim=1), kw["m_edge"],
                banded, heads=h, negative_slope=self.negative_slope)
        return self._finish(out2.reshape(n, h, c),
                            g.node_mask.to(torch.bool))

    def _xla_band_spill(self, g, banded, kw) -> torch.Tensor:
        """Route E when a gradient is wanted: the JAX XLA route
        (``conv_ell.py:336-352``), the band part over the in-band slots
        then the spill pass, in plain torch that autograd differentiates;
        returns [N, heads, C] f32."""
        n, k = g.nbr_src.shape
        h = self.heads
        m_edge = kw["m_edge"]
        if m_edge is not None:
            el_e = g.edge_attr @ m_edge                       # [N, K, H]
            el_self = (banded.mean_attr_t.T @ m_edge
                       if self.add_self_loops else None)
        else:
            el_e = torch.zeros(n, k, h, device=g.nbr_src.device)
            el_self = (torch.zeros(n, h, device=g.nbr_src.device)
                       if self.add_self_loops else None)
        y, m, denom = banded_gat_band_part_xla(
            kw["xh"], kw["a_src"], kw["a_dst"], el_e, el_self, banded,
            negative_slope=self.negative_slope)
        return banded_gat_spill_pass(
            y, m, denom, kw["xh"], kw["a_src"], kw["a_dst"], m_edge, banded,
            negative_slope=self.negative_slope)


def _slot_mask(g, like: torch.Tensor) -> torch.Tensor:
    """g's [N, K] slot mask against [N, K, ...] data."""
    m = g.nbr_mask.to(torch.bool)
    return m.reshape(m.shape + (1,) * (like.dim() - 2))


class GCNConvELL(nn.Module):
    """PyG-exact GCN layer on the ELL layout (``models/conv.GCNConv``'s
    function and parameters): d = 1 + live slots, each live slot's row
    W x_j scaled by 1 / sqrt(d_i d_j), summed over the slots, plus the self
    loop W x_i / d_i and the bias."""

    def __init__(self, in_channels: int, out_channels: int,
                 use_bias: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.kernel = _glorot(generator, in_channels, out_channels)
        self.bias = (nn.Parameter(torch.zeros(out_channels)) if use_bias
                     else None)

    def forward(self, g, x: torch.Tensor, dropout_rng=None,
                banded=None) -> torch.Tensor:
        xw = matmul(x, self.kernel)
        m = g.nbr_mask.to(torch.bool)
        deg = m.to(torch.float32).sum(1) + g.node_mask.to(torch.float32)
        dinv = torch.where(deg > 0, torch.rsqrt(deg.clamp_min(1e-12)),
                           torch.zeros_like(deg))
        nbr = ell_gather(xw, g.nbr_src)                         # [N, K, C]
        msgs = nbr * ell_gather(dinv, g.nbr_src)[..., None] \
            * dinv[:, None, None]
        msgs = torch.where(_slot_mask(g, msgs), msgs, torch.zeros_like(msgs))
        out = msgs.sum(1) + xw * (dinv * dinv)[:, None]
        if self.bias is not None:
            out = out + self.bias
        return zero_padded_nodes(out, g.node_mask)


class SAGEConvELL(nn.Module):
    """PyG-exact GraphSAGE (mean aggregator) on the ELL layout:
    out_i = W_l mean of the live slots' x_j + b_l + W_r x_i."""

    def __init__(self, in_channels: int, out_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.lin_l = _glorot(generator, in_channels, out_channels)
        self.bias_l = nn.Parameter(torch.zeros(out_channels))
        self.lin_r = _glorot(generator, in_channels, out_channels)

    def forward(self, g, x: torch.Tensor, dropout_rng=None,
                banded=None) -> torch.Tensor:
        nbr = ell_gather(x, g.nbr_src)
        live = _slot_mask(g, nbr)
        cnt = g.nbr_mask.to(x.dtype).sum(1).clamp_min(1.0)
        agg = torch.where(live, nbr, torch.zeros_like(nbr)).sum(1) \
            / cnt[:, None]
        out = matmul(agg, self.lin_l) + self.bias_l + matmul(x, self.lin_r)
        return zero_padded_nodes(out, g.node_mask)


class GINConvELL(nn.Module):
    """PyG-exact GIN on the ELL layout: mlp((1 + eps) x_i + the sum of the
    live slots' x_j), eps 0 fixed (``TorchLinear_0``, ReLU,
    ``TorchLinear_1``)."""

    def __init__(self, in_channels: int, out_channels: int,
                 eps: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.eps = eps
        self.TorchLinear_0 = TorchLinear(in_channels, out_channels, generator)
        self.TorchLinear_1 = TorchLinear(out_channels, out_channels,
                                         generator)

    def forward(self, g, x: torch.Tensor, dropout_rng=None,
                banded=None) -> torch.Tensor:
        nbr = ell_gather(x, g.nbr_src)
        agg = torch.where(_slot_mask(g, nbr), nbr,
                          torch.zeros_like(nbr)).sum(1)
        z = (1.0 + self.eps) * x + agg
        z = self.TorchLinear_1(torch.relu(self.TorchLinear_0(z)))
        return zero_padded_nodes(z, g.node_mask)
