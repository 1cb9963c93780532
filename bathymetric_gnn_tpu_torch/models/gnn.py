"""The multi-task bathymetric GNN on COO graphs (port of
``bathymetric_gnn_tpu/models/gnn.py``: ``GNNBackbone``,
``BathymetricGNN``, ``predict_with_thresholds``, ``make_model``).

MLP feature extractor -> GNN backbone (GAT, GCN, GraphSAGE or GIN from
``models/conv``) -> classification, confidence and correction heads, on an
``ops.graph.CooGraph`` of tensors with masked statistics everywhere. The
submodules carry the flax names (``MLPFeatureExtractor_0``,
``GNNBackbone_0.GATConv_i`` / ``GCNConv_i`` / ``SAGEConv_i`` /
``GINConv_i``, ``GNNBackbone_0.MaskedBatchNorm_i``, the heads), the same
tree as the ELL model's (``models/gnn_ell``), so one checkpoint drives
both. In training mode the BatchNorms normalize with the masked moments of
the batch's live nodes and update their running statistics, and
``dropout`` applies to the extractor, GAT's attention weights, the
BatchNorm output of every layer but the last (fused with its ReLU) and
the heads, drawing from the ``dropout_rng`` passed to ``forward``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..config.constants import (ACTION_AUTO_CORRECT, ACTION_KEEP,
                                ACTION_REVIEW, CLASS_NOISE)
from .conv import GATConv, GCNConv, GINConv, SAGEConv
from .layers import (ClassificationHead, ConfidenceHead, CorrectionHead,
                     MaskedBatchNorm, MLPFeatureExtractor, keep_mask)

GNN_TYPES = ("GAT", "GCN", "GraphSAGE", "GIN")
CONV_NAMES = {"GAT": "GATConv", "GCN": "GCNConv", "GraphSAGE": "SAGEConv",
              "GIN": "GINConv"}


def make_conv(gnn_type: str, in_channels: int, hidden_channels: int,
              last: bool, heads: int, edge_dim: Optional[int],
              generator: Optional[torch.Generator], dropout: float,
              families) -> nn.Module:
    """Layer i of a backbone: ``families`` maps each gnn_type to its conv
    class (the COO or the ELL ones); GAT takes ``heads`` heads
    concatenated, one head on the last layer."""
    if gnn_type not in GNN_TYPES:
        raise ValueError(f"unknown gnn_type {gnn_type!r}")
    if gnn_type == "GAT":
        return families["GAT"](in_channels, hidden_channels,
                               heads=1 if last else heads, concat=not last,
                               edge_dim=edge_dim, generator=generator,
                               dropout=dropout)
    return families[gnn_type](in_channels, hidden_channels,
                              generator=generator)


def conv_width(gnn_type: str, hidden_channels: int, heads: int,
               last: bool) -> int:
    """The output width of layer i."""
    return hidden_channels * (heads if gnn_type == "GAT" and not last else 1)


COO_CONVS = {"GAT": GATConv, "GCN": GCNConv, "GraphSAGE": SAGEConv,
             "GIN": GINConv}


class GNNBackbone(nn.Module):
    """``num_layers`` conv layers, each followed by a masked BatchNorm
    (+ ReLU and feature dropout but on the last)."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_layers: int, gnn_type: str = "GAT", heads: int = 4,
                 dropout: float = 0.0, edge_dim: Optional[int] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
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
                generator, dropout, COO_CONVS))
            width = conv_width(gnn_type, hidden_channels, heads, last)
            self.add_module(f"MaskedBatchNorm_{i}", MaskedBatchNorm(width))

    def forward(self, g, x: torch.Tensor,
                dropout_rng: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        node_mask = g.node_mask.to(torch.bool)
        drop = self.training and self.dropout > 0
        for i in range(self.num_layers):
            last = i == self.num_layers - 1
            x = getattr(self, f"{self.conv_name}_{i}")(g, x, dropout_rng)
            keep, keep_prob = None, 1.0
            if drop and not last:
                keep_prob = 1.0 - self.dropout
                keep = keep_mask(x.shape, keep_prob, dropout_rng, x.device)
            x = getattr(self, f"MaskedBatchNorm_{i}")(
                x, node_mask, fuse_relu=not last, keep=keep,
                keep_prob=keep_prob, group=self.bn_group)
        return x


class BathymetricGNN(nn.Module):
    """Multi-task GNN: per-node class logits, confidence and correction."""

    def __init__(self, in_channels: int, hidden_channels: int = 64,
                 num_layers: int = 4, gnn_type: str = "GAT", heads: int = 4,
                 num_classes: int = 3, dropout: float = 0.1,
                 predict_correction: bool = True,
                 feature_extractor_layers: int = 2,
                 edge_dim: Optional[int] = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.gnn_type = gnn_type
        self.predict_correction = predict_correction
        self.MLPFeatureExtractor_0 = MLPFeatureExtractor(
            in_channels, hidden_channels, feature_extractor_layers, generator,
            dropout)
        self.GNNBackbone_0 = GNNBackbone(
            hidden_channels, hidden_channels, num_layers, gnn_type, heads,
            dropout=dropout,
            edge_dim=edge_dim if gnn_type == "GAT" else None,
            generator=generator)
        self.ClassificationHead_0 = ClassificationHead(
            hidden_channels, num_classes, generator, dropout)
        self.ConfidenceHead_0 = ConfidenceHead(hidden_channels, generator,
                                               dropout)
        if predict_correction:
            self.CorrectionHead_0 = CorrectionHead(hidden_channels,
                                                   generator, dropout)

    def forward(self, g, dropout_rng: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """g: a ``CooGraph`` of tensors -> per-node outputs.
        ``dropout_rng``: the generator dropout draws from in training mode
        (needed when ``dropout`` > 0)."""
        x = self.MLPFeatureExtractor_0(g.x, dropout_rng)
        x = self.GNNBackbone_0(g, x, dropout_rng)
        logits = self.ClassificationHead_0(x, dropout_rng)
        out = {
            "class_logits": logits,
            "class_probs": torch.softmax(logits, -1),
            "predicted_class": torch.argmax(logits, -1),
            "confidence": self.ConfidenceHead_0(x, dropout_rng),
            "node_embedding": x,
        }
        if self.predict_correction:
            out["correction"] = self.CorrectionHead_0(x, dropout_rng)
        return out


def predict_with_thresholds(outputs: Dict[str, torch.Tensor],
                            auto_correct_threshold: float = 0.85,
                            review_threshold: float = 0.6
                            ) -> Dict[str, torch.Tensor]:
    """Deployment thresholding: auto-correct confident noise, review low
    confidence, keep the rest."""
    conf = outputs["confidence"]
    cls = outputs["predicted_class"]
    auto = (cls == CLASS_NOISE) & (conf > auto_correct_threshold)
    review = conf < review_threshold
    action = torch.where(
        auto, torch.full_like(cls, ACTION_AUTO_CORRECT),
        torch.where(review, torch.full_like(cls, ACTION_REVIEW),
                    torch.full_like(cls, ACTION_KEEP)))
    return {**outputs, "action": action, "auto_correct": auto,
            "needs_review": review}


def make_model(model_cfg, in_channels: int, edge_dim: int = 3,
               dropout: Optional[float] = None,
               generator: Optional[torch.Generator] = None
               ) -> BathymetricGNN:
    """The COO model of ``model_cfg`` (checkpoints record in_channels and
    edge_dim); ``dropout`` defaults to the config's, which applies only in
    training mode."""
    return BathymetricGNN(
        in_channels=in_channels,
        hidden_channels=model_cfg.hidden_channels,
        num_layers=model_cfg.num_layers,
        gnn_type=model_cfg.gnn_type,
        heads=model_cfg.heads,
        num_classes=model_cfg.num_classes,
        dropout=model_cfg.dropout if dropout is None else dropout,
        predict_correction=model_cfg.predict_correction,
        feature_extractor_layers=model_cfg.feature_extractor_layers,
        edge_dim=edge_dim,
        generator=generator,
    )
