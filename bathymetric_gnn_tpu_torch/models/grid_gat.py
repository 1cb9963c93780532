"""Dense-grid GAT model (port of ``bathymetric_gnn_tpu/models/grid_gat.py``).

Message passing on a 4/8-connected grid is a set of dense shifts: each
neighbour direction is one shift, attention is a masked softmax over <=9
direction channels per cell, and aggregation is a shifted weighted sum.
Each GAT layer runs through ``ops/cuda/grid_gat_fused``: for inference
``fused_grid_gat_infer`` (kernel A with the BatchNorm folded into its
epilogue), for training ``fused_grid_gat`` (kernel A with attention
dropout, kernel B backward); the CUDA kernels for tensors on the card,
their plain versions on the CPU.

Module and parameter names are the flax ones (``GridGATConv_0.lin_src``,
``MaskedBatchNorm_0.mean``, ``MLPFeatureExtractor_0.TorchLinear_0.kernel``,
...), so a flax ``params``/``batch_stats`` tree maps onto the
``state_dict`` key for key (``utils/weights.py``).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops.cuda import grid_gat_fused
from ..ops.features import atan_deg
from .layers import (ClassificationHead, ConfidenceHead, CorrectionHead,
                     MLPFeatureExtractor, MaskedBatchNorm, keep_mask)


def shift(a: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """a_shifted[b, r, c] = a[b, r + dr, c + dc] over dims 1, 2 of a
    batched tensor (wraps, like ``jnp.roll``; masked later)."""
    return torch.roll(a, shifts=(-dr, -dc), dims=(1, 2))


def neighbor_masks(valid: torch.Tensor,
                   offsets: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """[B, K, H, W] bool: cell has a valid in-bounds neighbour at offset k.
    The explicit in-bounds test removes what ``shift`` wraps."""
    _, h, w = valid.shape
    rows = torch.arange(h, device=valid.device)[:, None]
    cols = torch.arange(w, device=valid.device)[None, :]
    masks = []
    for dr, dc in offsets:
        inb = ((rows + dr >= 0) & (rows + dr < h)
               & (cols + dc >= 0) & (cols + dc < w))
        masks.append(valid & shift(valid, dr, dc) & inb)
    return torch.stack(masks, dim=1)


def incoming_edge_attrs(depth_filled: torch.Tensor,
                        offsets: Sequence[Tuple[int, int]],
                        resolution: Tuple[float, float]) -> torch.Tensor:
    """[B, K, H, W, 3] features of the incoming edge from each offset:
    (distance, depth[i] - depth[neighbour], slope in degrees)."""
    res_x, res_y = resolution
    feats = []
    for dr, dc in offsets:
        dist = math.sqrt((dc * res_x) ** 2 + (dr * res_y) ** 2)
        ddiff = depth_filled - shift(depth_filled, dr, dc)
        slope = (atan_deg(ddiff / dist) if dist > 0
                 else torch.zeros_like(ddiff))
        feats.append(torch.stack(
            [torch.full_like(ddiff, dist), ddiff, slope], -1))
    return torch.stack(feats, dim=1)


def _glorot(generator: Optional[torch.Generator], *shape) -> nn.Parameter:
    """flax ``glorot_uniform`` (fan over the last dim vs the rest)."""
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    fan_in, fan_out = shape[-2] * receptive, shape[-1] * receptive
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(*shape, generator=generator)
    return nn.Parameter((2.0 * u - 1.0) * limit)


class GridGATConv(nn.Module):
    """GAT layer on dense [B, H, W, F] grids, PyG-GATConv semantics
    (self loop with the per-destination mean of incoming edge attrs).
    Parameter names and shapes are those of the JAX ``GridGATConv``.

    Heads are concatenated; ``concat=False`` (the head mean) is taken only
    with one head, where the two agree, as in the model's last layer.
    ``dropout`` is the attention dropout of training mode."""

    def __init__(self, in_channels: int, out_channels: int, heads: int = 4,
                 concat: bool = True, negative_slope: float = 0.2,
                 edge_dim: Optional[int] = 3, connectivity: int = 8,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0):
        super().__init__()
        if not concat and heads > 1:
            raise ValueError("the head mean of several heads (concat=False, "
                             f"heads={heads}) is not ported")
        self.heads, self.out_channels = heads, out_channels
        self.negative_slope = negative_slope
        self.dropout = dropout
        self.edge_dim = edge_dim
        self.connectivity = connectivity
        self.compute_dtype = compute_dtype
        hc = heads * out_channels
        self.lin_src = _glorot(generator, in_channels, hc)
        self.att_src = _glorot(generator, 1, heads, out_channels)
        self.att_dst = _glorot(generator, 1, heads, out_channels)
        if edge_dim is not None:
            self.lin_edge = _glorot(generator, edge_dim, hc)
            self.att_edge = _glorot(generator, 1, heads, out_channels)
        self.bias = nn.Parameter(torch.zeros(hc))

    def forward(self, x: torch.Tensor, valid: torch.Tensor,
                nbr_mask: torch.Tensor, edge_attr: torch.Tensor,
                bn_scale: Optional[torch.Tensor] = None,
                bn_bias: Optional[torch.Tensor] = None,
                fuse_relu: bool = False,
                dropout_rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        """x [B, H, W, F], valid [B, H, W], nbr_mask [B, K, H, W],
        edge_attr [B, K, H, W, edge_dim] -> [B, H, W, HC], in
        ``compute_dtype``. ``bn_scale``/``bn_bias`` (+ ``fuse_relu``) fold
        the following BatchNorm's running-stats affine into the layer
        (inference, no gradient). Otherwise the layer is differentiable;
        in training mode with ``dropout`` > 0 it draws its attention
        dropout from ``dropout_rng``: on the card one Philox seed per call
        (kernels A and B draw the mask from it), on the CPU the streamed
        mask itself."""
        params = {n: p for n, p in self.named_parameters(recurse=False)}
        w_lin, a_src, a_dst, m_edge, bias = grid_gat_fused.gat_param_matrices(
            params, self.heads, self.out_channels, self.edge_dim)
        args = (x, w_lin, a_src, a_dst, m_edge, edge_attr,
                nbr_mask.to(torch.float32), valid.to(torch.float32), bias,
                self.connectivity, self.negative_slope,
                self.edge_dim is not None)
        if bn_scale is not None:
            return grid_gat_fused.fused_grid_gat_infer(
                *args, bn_scale=bn_scale, bn_bias=bn_bias,
                fuse_relu=fuse_relu, compute_dtype=self.compute_dtype)
        dmask = seed = None
        keep_prob = 1.0 - self.dropout
        if self.training and self.dropout > 0:
            if dropout_rng is None:
                raise ValueError("attention dropout in training mode needs "
                                 "a torch.Generator (dropout_rng)")
            if x.device.type == "cuda":
                seed = torch.randint(0, 2 ** 62, (1,), generator=dropout_rng,
                                     device=x.device, dtype=torch.int64)
            else:
                b, k, h, w = nbr_mask.shape
                dmask = keep_mask((b, k + 1, self.heads, h, w), keep_prob,
                                  dropout_rng, x.device
                                  ).to(torch.float32) / keep_prob
        return grid_gat_fused.fused_grid_gat(
            *args, dmask=dmask, drop_seed=seed, keep_prob=keep_prob,
            compute_dtype=self.compute_dtype)


def params_from_coo(coo_params: Dict, num_layers: int) -> Dict:
    """Translate BathymetricGNN (COO) params to the GridBathymetricGNN
    layout: same layer math and shapes; only the nesting differs (COO
    nests convs/norms under GNNBackbone_0). GAT layers become
    ``GridGATConv_i``; the GCN, GraphSAGE and GIN layers, which have no
    grid model, keep their names (``GCNConv_i``, ``SAGEConv_i``,
    ``GINConv_i``) at the top, beside the norms."""
    out = {k: v for k, v in coo_params.items() if k != "GNNBackbone_0"}
    bb = coo_params.get("GNNBackbone_0", {})
    for i in range(num_layers):
        if f"GATConv_{i}" in bb:
            out[f"GridGATConv_{i}"] = bb[f"GATConv_{i}"]
        for name in (f"GCNConv_{i}", f"SAGEConv_{i}", f"GINConv_{i}",
                     f"MaskedBatchNorm_{i}"):
            if name in bb:
                out[name] = bb[name]
    return out


class GridBathymetricGNN(nn.Module):
    """Dense-grid multi-task model: MLP extractor, ``num_layers`` GAT
    layers (``heads`` heads, concat; the last one heads 1) each followed
    by a masked BatchNorm (+ ReLU but on the last), then the
    classification, confidence and correction heads.

    In eval mode, when no gradient is wanted, each BatchNorm's running-stats
    affine (+ ReLU) is folded into the preceding GAT layer's epilogue, as
    the JAX model does on its Pallas path. Otherwise the GAT layers run the
    differentiable training form (kernels A and B on the card). In train
    mode the BatchNorm uses masked batch moments and updates its running
    stats, and ``dropout`` (0 here; ``grid_batched.BatchedGridGNN`` turns
    it on) applies to the extractor, the attention weights, the BatchNorm
    output of every layer but the last, and the heads, drawing from the
    ``dropout_rng`` passed to ``forward``."""

    def __init__(self, in_channels: int, hidden_channels: int = 64,
                 num_layers: int = 4, heads: int = 4, num_classes: int = 3,
                 predict_correction: bool = True,
                 feature_extractor_layers: int = 2,
                 edge_dim: Optional[int] = 3, connectivity: int = 8,
                 compute_dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        self.predict_correction = predict_correction
        self.dropout = dropout
        self.MLPFeatureExtractor_0 = MLPFeatureExtractor(
            in_channels, hidden_channels, feature_extractor_layers, generator,
            dropout)
        width_in = hidden_channels
        for i in range(num_layers):
            last = i == num_layers - 1
            hds = 1 if last else heads
            self.add_module(f"GridGATConv_{i}", GridGATConv(
                width_in, hidden_channels, heads=hds, concat=not last,
                edge_dim=edge_dim, connectivity=connectivity,
                compute_dtype=compute_dtype, generator=generator,
                dropout=dropout))
            width_in = hidden_channels * hds
            self.add_module(f"MaskedBatchNorm_{i}", MaskedBatchNorm(width_in))
        self.ClassificationHead_0 = ClassificationHead(
            hidden_channels, num_classes, generator, dropout)
        self.ConfidenceHead_0 = ConfidenceHead(hidden_channels, generator,
                                               dropout)
        if predict_correction:
            self.CorrectionHead_0 = CorrectionHead(hidden_channels, generator,
                                                   dropout)

    def forward(self, features: torch.Tensor, valid: torch.Tensor,
                nbr_mask: torch.Tensor, edge_attr: torch.Tensor,
                dropout_rng: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """features [B, H, W, F], valid [B, H, W] bool, nbr_mask
        [B, K, H, W], edge_attr [B, K, H, W, 3] -> per-cell outputs.
        ``dropout_rng``: the generator dropout draws from in training
        mode (needed when ``dropout`` > 0)."""
        drop = self.training and self.dropout > 0
        fold = not self.training and not (
            torch.is_grad_enabled()
            and any(p.requires_grad for p in self.parameters()))
        x = self.MLPFeatureExtractor_0(features.to(torch.float32),
                                       dropout_rng)
        flat_valid = valid.reshape(-1)
        for i in range(self.num_layers):
            last = i == self.num_layers - 1
            conv = getattr(self, f"GridGATConv_{i}")
            norm = getattr(self, f"MaskedBatchNorm_{i}")
            if fold:
                sc2, bi2 = norm.affine()
                x = conv(x, valid, nbr_mask, edge_attr, bn_scale=sc2,
                         bn_bias=bi2, fuse_relu=not last)
                continue
            x = conv(x, valid, nbr_mask, edge_attr, dropout_rng=dropout_rng)
            shape = x.shape
            flat = x.reshape(-1, shape[-1])
            keep, keep_prob = None, 1.0
            if drop and not last:
                # ReLU + feature dropout fold into the norm's pass
                keep_prob = 1.0 - self.dropout
                keep = keep_mask(flat.shape, keep_prob, dropout_rng, x.device)
            x = norm(flat, flat_valid, fuse_relu=not last, keep=keep,
                     keep_prob=keep_prob).reshape(shape)
        x = x.to(torch.float32)
        logits = self.ClassificationHead_0(x, dropout_rng)
        out = {
            "class_logits": logits,
            "class_probs": torch.softmax(logits, -1),
            "predicted_class": torch.argmax(logits, -1),
            "confidence": self.ConfidenceHead_0(x, dropout_rng),
        }
        if self.predict_correction:
            out["correction"] = self.CorrectionHead_0(x, dropout_rng)
        return out
