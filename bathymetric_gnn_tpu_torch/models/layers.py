"""Shared neural building blocks (port of ``bathymetric_gnn_tpu/models/layers.py``).

Parameter names and layouts follow the JAX modules so that one set of
weights drives both packages (``utils/weights.py``): a ``TorchLinear``
keeps its ``kernel`` as [in, out] and computes ``x @ kernel + bias``.
Dropout is absent: this slice serves inference only.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over nodes with padding-masked statistics.

    torch BatchNorm1d semantics (eps 1e-5, momentum 0.1, affine, running
    stats; biased variance to normalize, unbiased for the running update),
    but the moments are taken over live nodes only, so padded or invalid
    cells never pollute them. Not ``nn.BatchNorm1d``, which cannot mask.
    Parameters ``scale``/``bias``, buffers ``mean``/``var``.
    """

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.features = features
        self.momentum = momentum
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def affine(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """Running-stats normalization folded into (scale2, bias2), so a
        producer kernel can apply y = x * scale2 + bias2 (inference)."""
        scale2 = self.scale * torch.rsqrt(self.var + self.eps)
        return scale2, self.bias - self.mean * scale2

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                fuse_relu: bool = False) -> torch.Tensor:
        """x [N, F], mask [N] bool. Training mode normalizes with the
        masked batch moments and updates the running stats; eval mode
        uses the running stats."""
        x = x.to(torch.float32)
        if self.training:
            m = mask.to(torch.float32)[:, None]
            n = m.sum().clamp_min(1.0)
            mean = (x * m).sum(0) / n
            var = (((x - mean) ** 2) * m).sum(0) / n
            with torch.no_grad():
                unbiased = var * n / (n - 1.0).clamp_min(1.0)
                self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
                self.var.mul_(1 - self.momentum).add_(
                    self.momentum * unbiased)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        if fuse_relu:
            y = torch.relu(y)
        return torch.where(mask[:, None], y, torch.zeros_like(y))


class TorchLinear(nn.Module):
    """Dense layer with torch's default init, U(-1/sqrt(in), 1/sqrt(in)),
    for both kernel and bias. ``kernel`` is [in, out] (JAX layout)."""

    def __init__(self, in_features: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)

        def uniform(*shape):
            u = torch.rand(*shape, generator=generator)
            return nn.Parameter((2.0 * u - 1.0) * bound)

        self.kernel = uniform(in_features, features)
        self.bias = uniform(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.kernel + self.bias


class MLPFeatureExtractor(nn.Module):
    """Per-node pre-GNN MLP: (Linear, ReLU) x (num_layers-1), then a final
    Linear with no activation."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_layers: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n = max(num_layers - 1, 0) + 1
        widths = [in_channels] + [hidden_channels] * self.n
        for i in range(self.n):
            self.add_module(f"TorchLinear_{i}", TorchLinear(
                widths[i], widths[i + 1], generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"TorchLinear_{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
        return x


class _TwoLayerHead(nn.Module):
    """hidden -> hidden//2 -> out, ReLU between."""

    def __init__(self, hidden_channels: int, out: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.TorchLinear_0 = TorchLinear(hidden_channels,
                                         hidden_channels // 2, generator)
        self.TorchLinear_1 = TorchLinear(hidden_channels // 2, out,
                                         generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.TorchLinear_1(torch.relu(self.TorchLinear_0(x)))


class ClassificationHead(_TwoLayerHead):
    """hidden -> hidden//2 -> num_classes logits."""

    def __init__(self, hidden_channels: int, num_classes: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__(hidden_channels, num_classes, generator)


class ConfidenceHead(_TwoLayerHead):
    """hidden -> hidden//2 -> 1, sigmoid."""

    def __init__(self, hidden_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(hidden_channels, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(super().forward(x))[..., 0]


class CorrectionHead(_TwoLayerHead):
    """hidden -> hidden//2 -> 1, linear."""

    def __init__(self, hidden_channels: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__(hidden_channels, 1, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x)[..., 0]
