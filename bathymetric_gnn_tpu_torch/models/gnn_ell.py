"""ELL-layout full model (port of ``bathymetric_gnn_tpu/models/gnn_ell.py``:
``EllGNNBackbone``, ``EllBathymetricGNN``, ``make_ell_model``).

Submodules carry the JAX model's names (``MLPFeatureExtractor_0``,
``GNNBackbone_0.GATConv_i``, ``GNNBackbone_0.MaskedBatchNorm_i``, the
heads), so a graph-trained (COO-layout) checkpoint applies unchanged;
``utils/weights.coo_state_dict`` renames a port checkpoint's grid-named
state_dict to these keys. ``sparse_kernel`` picks the GAT layer, as the
JAX model does: ``"xla"`` ``GATConvELL`` (kernel C serving, C and C' with
a gradient, C's dropout form in training mode);
``"banded_pallas"`` ``GATConvEllBanded(use_pallas=True)``, whose attention
runs in kernel C and, when training, kernel C' (or, with ``wide_kernel``
switched off on its layers, kernels D and D'); ``"banded"``
``GATConvEllBanded(use_pallas=False)``, kernel E and the spill fold when
serving, the JAX XLA route's plain math when training (dropout 0, as
JAX's layer refuses attention dropout there). The banded routes but C read
the ``banded`` decomposition
(``ops/ell_banded.band_ell`` of the graph) passed to ``forward``, and
raise the JAX model's ValueError without it. In training mode the
BatchNorms normalize with the masked moments of the batch's live nodes
and update their running statistics, and ``dropout`` applies to the
extractor, the attention weights, the BatchNorm output of every layer but
the last (fused with its ReLU) and the heads, drawing from the
``dropout_rng`` passed to ``forward``, as the port's grid model does.
``compute_dtype="bfloat16"`` (the JAX models' flag; no CLI or trainer sets
it, in either package) runs the banded GAT layers in their bf16 forms: a
bf16 layer output reaches its BatchNorm, which then computes in f32 and
returns bf16, and a bf16 activation reaching the heads is cast to f32
first, as jnp promotes bf16 @ f32. GCN, GraphSAGE and GIN backbones
(``GCNConv_i``, ``SAGEConv_i``, ``GINConv_i``) take the plain ELL layers
of ``conv_ell`` whatever ``sparse_kernel`` says, as the JAX model does.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
from torch import nn

from .conv_ell import (GATConvELL, GATConvEllBanded, GCNConvELL,
                       GINConvELL, SAGEConvELL)
from .gnn import CONV_NAMES, conv_width, make_conv
from .layers import (ClassificationHead, ConfidenceHead, CorrectionHead,
                     MaskedBatchNorm, MLPFeatureExtractor, keep_mask)

SPARSE_KERNELS = ("xla", "banded", "banded_pallas")
ELL_CONVS = {"GCN": GCNConvELL, "GraphSAGE": SAGEConvELL, "GIN": GINConvELL}


class EllGNNBackbone(nn.Module):
    """``num_layers`` conv layers (GAT: ``heads`` heads concatenated, the
    last one 1 head), each followed by a masked BatchNorm (+ ReLU but on
    the last)."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_layers: int, gnn_type: str = "GAT", heads: int = 4,
                 edge_dim: Optional[int] = None, sparse_kernel: str = "xla",
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0, compute_dtype: str = "float32"):
        super().__init__()
        if sparse_kernel not in SPARSE_KERNELS:
            raise ValueError(f"unknown sparse_kernel {sparse_kernel!r}")
        if gnn_type != "GAT":
            families = ELL_CONVS
        elif sparse_kernel == "xla":
            families = {"GAT": GATConvELL}
        else:
            families = {"GAT": functools.partial(
                GATConvEllBanded, use_pallas=sparse_kernel == "banded_pallas",
                compute_dtype=compute_dtype)}
        self.num_layers = num_layers
        self.dropout = dropout
        # the process group of the sync-BN moments (the JAX model's
        # bn_axis_name); the sharded train steps set it for their call
        self.bn_group = None
        self.conv_name = CONV_NAMES.get(gnn_type, gnn_type)
        width = in_channels
        for i in range(num_layers):
            last = i == num_layers - 1
            self.add_module(f"{self.conv_name}_{i}", make_conv(
                gnn_type, width, hidden_channels, last, heads, edge_dim,
                generator, dropout, families))
            width = conv_width(gnn_type, hidden_channels, heads, last)
            self.add_module(f"MaskedBatchNorm_{i}", MaskedBatchNorm(width))

    def forward(self, g, x: torch.Tensor,
                dropout_rng: Optional[torch.Generator] = None,
                banded=None) -> torch.Tensor:
        node_mask = g.node_mask.to(torch.bool)
        drop = self.training and self.dropout > 0
        for i in range(self.num_layers):
            last = i == self.num_layers - 1
            conv = getattr(self, f"{self.conv_name}_{i}")
            x = conv(g, x, dropout_rng, banded)
            keep, keep_prob = None, 1.0
            if drop and not last:
                # ReLU + feature dropout fold into the norm's pass
                keep_prob = 1.0 - self.dropout
                keep = keep_mask(x.shape, keep_prob, dropout_rng, x.device)
            x = getattr(self, f"MaskedBatchNorm_{i}")(
                x, node_mask, fuse_relu=not last, keep=keep,
                keep_prob=keep_prob, group=self.bn_group)
        return x


class EllBathymetricGNN(nn.Module):
    """BathymetricGNN on ELL graphs: MLP extractor, backbone, then the
    classification, confidence and correction heads."""

    def __init__(self, in_channels: int, hidden_channels: int = 64,
                 num_layers: int = 4, gnn_type: str = "GAT", heads: int = 4,
                 num_classes: int = 3, predict_correction: bool = True,
                 feature_extractor_layers: int = 2,
                 edge_dim: Optional[int] = 3, sparse_kernel: str = "xla",
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0, compute_dtype: str = "float32"):
        super().__init__()
        self.predict_correction = predict_correction
        self.MLPFeatureExtractor_0 = MLPFeatureExtractor(
            in_channels, hidden_channels, feature_extractor_layers, generator,
            dropout)
        self.GNNBackbone_0 = EllGNNBackbone(
            hidden_channels, hidden_channels, num_layers, gnn_type, heads,
            edge_dim=edge_dim if gnn_type == "GAT" else None,
            sparse_kernel=sparse_kernel,
            generator=generator, dropout=dropout,
            compute_dtype=compute_dtype)
        self.ClassificationHead_0 = ClassificationHead(
            hidden_channels, num_classes, generator, dropout)
        self.ConfidenceHead_0 = ConfidenceHead(hidden_channels, generator,
                                               dropout)
        if predict_correction:
            self.CorrectionHead_0 = CorrectionHead(hidden_channels,
                                                   generator, dropout)

    def forward(self, g, dropout_rng: Optional[torch.Generator] = None,
                banded=None) -> Dict[str, torch.Tensor]:
        """g: an ``ops.ell.EllGraph`` of tensors -> per-node outputs.
        ``dropout_rng``: the generator dropout draws from in training mode
        (needed when ``dropout`` > 0); ``banded``: g's ``BandedEll`` of
        tensors, for the banded routes that read it."""
        x = self.MLPFeatureExtractor_0(g.x.to(torch.float32), dropout_rng)
        x = self.GNNBackbone_0(g, x, dropout_rng, banded).to(torch.float32)
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


def make_ell_model(model_cfg, in_channels: int, edge_dim: int = 3,
                   sparse_kernel: str = "xla", dropout: float = 0.0,
                   generator: Optional[torch.Generator] = None,
                   compute_dtype: str = "float32") -> EllBathymetricGNN:
    """The ELL model of ``model_cfg``'s widths; ``dropout`` is the
    training model's (the JAX config's ``model.dropout``), 0 to serve;
    ``compute_dtype`` the JAX function's ("float32" or "bfloat16")."""
    return EllBathymetricGNN(
        in_channels=in_channels,
        hidden_channels=model_cfg.hidden_channels,
        num_layers=model_cfg.num_layers,
        gnn_type=model_cfg.gnn_type,
        heads=model_cfg.heads,
        num_classes=model_cfg.num_classes,
        predict_correction=model_cfg.predict_correction,
        feature_extractor_layers=model_cfg.feature_extractor_layers,
        edge_dim=edge_dim,
        sparse_kernel=sparse_kernel,
        generator=generator,
        dropout=dropout,
        compute_dtype=compute_dtype,
    )
