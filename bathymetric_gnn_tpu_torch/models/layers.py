"""Shared neural building blocks (port of ``bathymetric_gnn_tpu/models/layers.py``).

Parameter names and layouts follow the JAX modules so that one set of
weights drives both packages (``utils/weights.py``): a ``TorchLinear``
keeps its ``kernel`` as [in, out] and computes ``x @ kernel + bias``.
Dropout draws from the ``torch.Generator`` the caller passes
(``dropout_rng``, on the device of the activations), never from torch's
global generator.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn


def dropout(x: torch.Tensor, rate: float,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 - rate and
    scale it by 1 / (1 - rate), drawing from ``rng``."""
    if rate <= 0.0:
        return x
    if rng is None:
        raise ValueError("dropout in training mode needs a torch.Generator "
                         "(dropout_rng)")
    keep = keep_mask(x.shape, 1.0 - rate, rng, x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def keep_mask(shape, keep_prob: float, rng: torch.Generator,
              device) -> torch.Tensor:
    """Bernoulli(keep_prob) keep mask drawn from ``rng``."""
    return torch.rand(shape, generator=rng, device=device) < keep_prob


def _bn_lowp_impl(x, mask_f, scale, bias, keep, eps, relu, keep_prob):
    m = mask_f[:, None] > 0
    n = mask_f.sum().clamp_min(1.0)
    xz = torch.where(m, x, torch.zeros((), dtype=x.dtype, device=x.device))
    s1 = xz.sum(0, dtype=torch.float32)
    s2 = xz.to(torch.float32).square().sum(0)
    mean = s1 / n
    var = (s2 / n - mean * mean).clamp_min(0.0)
    r = torch.rsqrt(var + eps)
    y32 = (x.to(torch.float32) - mean) * (r * scale) + bias
    if relu:
        y32 = torch.relu(y32)
    if keep_prob < 1.0:
        y32 = torch.where(keep, y32 / keep_prob, torch.zeros_like(y32))
    y = torch.where(m, y32, torch.zeros_like(y32)).to(x.dtype)
    return y, mean, var, r, n


class _BnLowp(torch.autograd.Function):
    """Low-precision masked BatchNorm (+ fused ReLU and feature dropout)
    with the hand-written backward of the JAX ``_bn_lowp``: one-pass f32
    moments (E[x^2] - mean^2) from bf16 reads, the normalize computing
    (x - mean) in f32, and a backward that is one elementwise pass plus
    two reductions. Returns (y in x's dtype, mean, var); the moments feed
    only the running-stats update and get no gradient."""

    @staticmethod
    def forward(ctx, x, mask_f, scale, bias, keep, eps, relu, keep_prob):
        y, mean, var, r, n = _bn_lowp_impl(x, mask_f, scale, bias, keep,
                                           eps, relu, keep_prob)
        ctx.save_for_backward(x, mask_f, scale, bias, mean, r, n, keep)
        ctx.relu, ctx.keep_prob = relu, keep_prob
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, mask_f, scale, bias, mean, r, n, keep = ctx.saved_tensors
        m = mask_f[:, None] > 0
        f32 = torch.float32
        dy32 = torch.where(m, dy, torch.zeros_like(dy)).to(f32)
        xhat = (x.to(f32) - mean) * r
        xhat = torch.where(m, xhat, torch.zeros_like(xhat))
        if ctx.keep_prob < 1.0:
            dy32 = torch.where(keep, dy32 / ctx.keep_prob,
                               torch.zeros_like(dy32))
        if ctx.relu:
            # the ReLU gate with the forward's exact factoring
            # ((x32 - mean) * (r * scale) + bias): the equal
            # xhat * scale + bias rounds differently and can flip the gate
            # at the f32 rounding boundary
            gate = (x.to(f32) - mean) * (r * scale) + bias
            dy32 = torch.where(gate > 0, dy32, torch.zeros_like(dy32))
        db = dy32.sum(0)
        ds = (dy32 * xhat).sum(0)
        dx32 = (r * scale) * (dy32 - (db + xhat * ds) / n)
        dx = torch.where(m, dx32, torch.zeros_like(dx32)).to(x.dtype)
        return dx, None, ds, db, None, None, None, None


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

    def _update_running(self, mean, var, n):
        with torch.no_grad():
            unbiased = var * n / (n - 1.0).clamp_min(1.0)
            self.mean.mul_(1 - self.momentum).add_(self.momentum * mean)
            self.var.mul_(1 - self.momentum).add_(self.momentum * unbiased)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                fuse_relu: bool = False, keep: Optional[torch.Tensor] = None,
                keep_prob: float = 1.0) -> torch.Tensor:
        """x [N, F], mask [N] bool. Training mode normalizes with the
        masked batch moments and updates the running stats; eval mode
        uses the running stats. ``fuse_relu`` and the feature-dropout keep
        mask ``keep`` [N, F] (with ``keep_prob`` < 1) apply the layer's
        activation and dropout in the same pass. A bf16 ``x`` returns bf16:
        in training mode through ``_BnLowp``, in eval mode through the JAX
        module's affine-folded pass (x32 * g2 + b2, g2 = rsqrt(var + eps) *
        scale, b2 = bias - mean * g2, computed in f32). An f32 ``x``
        computes and returns f32."""
        if keep_prob < 1.0 and keep is None:
            raise ValueError("keep_prob < 1 needs a keep mask")
        if x.dtype != torch.float32:
            if self.training:
                mask_f = mask.to(torch.float32)
                y, mean, var = _BnLowp.apply(x, mask_f, self.scale,
                                             self.bias, keep, self.eps,
                                             fuse_relu, keep_prob)
                self._update_running(mean, var, mask_f.sum().clamp_min(1.0))
                return y
            g2 = torch.rsqrt(self.var + self.eps) * self.scale
            y = x.to(torch.float32) * g2 + (self.bias - self.mean * g2)
            if fuse_relu:
                y = torch.relu(y)
            if keep_prob < 1.0:
                y = torch.where(keep, y / keep_prob, torch.zeros_like(y))
            return torch.where(mask[:, None], y, torch.zeros_like(y)
                               ).to(x.dtype)
        if self.training:
            m = mask.to(torch.float32)[:, None]
            n = m.sum().clamp_min(1.0)
            mean = (x * m).sum(0) / n
            var = (((x - mean) ** 2) * m).sum(0) / n
            self._update_running(mean, var, n)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.eps) * self.scale + self.bias
        if fuse_relu:
            y = torch.relu(y)
        if keep_prob < 1.0:
            y = torch.where(keep, y / keep_prob, torch.zeros_like(y))
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
    """Per-node pre-GNN MLP: (Linear, ReLU, Dropout) x (num_layers-1), then
    a final Linear with no activation."""

    def __init__(self, in_channels: int, hidden_channels: int,
                 num_layers: int = 2,
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.n = max(num_layers - 1, 0) + 1
        widths = [in_channels] + [hidden_channels] * self.n
        for i in range(self.n):
            self.add_module(f"TorchLinear_{i}", TorchLinear(
                widths[i], widths[i + 1], generator))

    def forward(self, x: torch.Tensor,
                dropout_rng: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"TorchLinear_{i}")(x)
            if i < self.n - 1:
                x = torch.relu(x)
                if self.training:
                    x = dropout(x, self.dropout, dropout_rng)
        return x


class _TwoLayerHead(nn.Module):
    """hidden -> hidden//2 -> out, ReLU and Dropout between."""

    def __init__(self, hidden_channels: int, out: int,
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        self.TorchLinear_0 = TorchLinear(hidden_channels,
                                         hidden_channels // 2, generator)
        self.TorchLinear_1 = TorchLinear(hidden_channels // 2, out,
                                         generator)

    def forward(self, x: torch.Tensor,
                dropout_rng: Optional[torch.Generator] = None) -> torch.Tensor:
        x = torch.relu(self.TorchLinear_0(x))
        if self.training:
            x = dropout(x, self.dropout, dropout_rng)
        return self.TorchLinear_1(x)


class ClassificationHead(_TwoLayerHead):
    """hidden -> hidden//2 -> num_classes logits."""

    def __init__(self, hidden_channels: int, num_classes: int = 3,
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0):
        super().__init__(hidden_channels, num_classes, generator, dropout)


class ConfidenceHead(_TwoLayerHead):
    """hidden -> hidden//2 -> 1, sigmoid."""

    def __init__(self, hidden_channels: int,
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0):
        super().__init__(hidden_channels, 1, generator, dropout)

    def forward(self, x: torch.Tensor,
                dropout_rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return torch.sigmoid(super().forward(x, dropout_rng))[..., 0]


class CorrectionHead(_TwoLayerHead):
    """hidden -> hidden//2 -> 1, linear."""

    def __init__(self, hidden_channels: int,
                 generator: Optional[torch.Generator] = None,
                 dropout: float = 0.0):
        super().__init__(hidden_channels, 1, generator, dropout)

    def forward(self, x: torch.Tensor,
                dropout_rng: Optional[torch.Generator] = None) -> torch.Tensor:
        return super().forward(x, dropout_rng)[..., 0]
