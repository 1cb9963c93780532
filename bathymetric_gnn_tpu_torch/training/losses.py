"""Multi-task loss for bathymetric GNN training (port of ``bathymetric_gnn_tpu/training/losses.py``).

The 5-component objective as fully masked dense reductions: padded or
invalid nodes contribute exactly zero, with no boolean indexing. Every
component is a masked mean, numerator sum / max(denominator, 1); the
``*_terms`` functions expose the (num, den) pairs, as the JAX module does
for its sharded callers.

Masks select (``torch.where``) rather than multiply. The JAX code writes
``per_node * mask``, but XLA rewrites a product with a converted boolean
into a select, so a NaN at a masked node (the correction target of a cell
inside a NaN hole of the clean survey) drops out of the JAX loss. In eager
PyTorch NaN * 0 is NaN; the select gives the JAX result.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config.constants import CLASS_FEATURE, CLASS_NOISE, CLASS_SEAFLOOR

LossTerms = Dict[str, Tuple[torch.Tensor, torch.Tensor]]


def _mean(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / torch.clamp_min(den, 1.0)


def _masked_sum(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.where(mask, values, torch.zeros_like(values)))


def classification_loss_terms(
    logits: torch.Tensor,  # [N, C]
    targets: torch.Tensor,  # [N] int
    node_mask: torch.Tensor,  # [N] bool
    class_weights: Optional[torch.Tensor] = None,  # [C]
    label_smoothing: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    num_classes = logits.shape[-1]
    t = torch.clamp(targets.long(), 0, num_classes - 1)
    onehot = F.one_hot(t, num_classes).to(logits.dtype)
    if label_smoothing > 0:
        onehot = onehot * (1.0 - label_smoothing) + label_smoothing / num_classes
    logp = torch.log_softmax(logits, dim=-1)
    if class_weights is not None:
        # torch applies per-class weights inside the smoothed sum and
        # normalizes by the sum of target-class weights
        per_node = -torch.sum(onehot * logp * class_weights[None, :], dim=-1)
        denom_w = class_weights[t]
    else:
        per_node = -torch.sum(onehot * logp, dim=-1)
        denom_w = torch.ones_like(per_node)
    return (_masked_sum(per_node, node_mask),
            _masked_sum(denom_w, node_mask))


def classification_loss(logits, targets, node_mask, class_weights=None,
                        label_smoothing: float = 0.0) -> torch.Tensor:
    """Weighted CE with label smoothing, torch ``F.cross_entropy``'s
    weighted-mean normalization (sum of losses / sum of sample weights)."""
    return _mean(*classification_loss_terms(
        logits, targets, node_mask, class_weights, label_smoothing))


def huber(x: torch.Tensor, delta: float) -> torch.Tensor:
    a = torch.abs(x)
    return torch.where(a <= delta, 0.5 * x * x, delta * (a - 0.5 * delta))


def correction_loss_terms(predicted, target, mask, delta: float = 1.0):
    # select before the Huber: its gradient at a NaN would reach the
    # prediction through the select's zero branch as 0 * NaN
    diff = predicted - target
    diff = torch.where(mask, diff, torch.zeros_like(diff))
    return torch.sum(huber(diff, delta)), torch.sum(mask.to(predicted.dtype))


def correction_loss(predicted, target, mask,
                    delta: float = 1.0) -> torch.Tensor:
    """Masked Huber on normalized corrections; 0 when the mask is empty."""
    return _mean(*correction_loss_terms(predicted, target, mask, delta))


def confidence_calibration_loss_terms(confidence, predicted_class,
                                      true_class, node_mask):
    correct = (predicted_class == true_class).to(confidence.dtype)
    c = torch.clamp(confidence, 1e-7, 1.0 - 1e-7)
    per = -(correct * torch.log(c) + (1.0 - correct) * torch.log(1.0 - c))
    return (_masked_sum(per, node_mask),
            torch.sum(node_mask.to(confidence.dtype)))


def confidence_calibration_loss(confidence, predicted_class, true_class,
                                node_mask) -> torch.Tensor:
    """BCE(confidence, 1[pred == true])."""
    return _mean(*confidence_calibration_loss_terms(
        confidence, predicted_class, true_class, node_mask))


def feature_preservation_loss_terms(predicted_class, true_class, node_mask,
                                    penalty_weight: float = 2.0):
    bad = ((true_class == CLASS_FEATURE) & (predicted_class == CLASS_NOISE)
           & node_mask).to(torch.float32)
    m = node_mask.to(torch.float32)
    return penalty_weight * torch.sum(bad), torch.sum(m)


def feature_preservation_loss(predicted_class, true_class, node_mask,
                              penalty_weight: float = 2.0) -> torch.Tensor:
    """Penalty for erasing real features: weight * mean(true == feature &
    pred == noise)."""
    return _mean(*feature_preservation_loss_terms(
        predicted_class, true_class, node_mask, penalty_weight))


def shoal_safety_loss_terms(predicted_class, true_class, correction_targets,
                            node_mask, shoal_penalty: float = 3.0,
                            deep_penalty: float = 1.0):
    fpf = ((true_class == CLASS_SEAFLOOR) & (predicted_class == CLASS_NOISE)
           & node_mask).to(torch.float32)
    is_shoal = correction_targets < 0
    shoal_fp = torch.sum(fpf * is_shoal.to(torch.float32))
    deep_fp = torch.sum(fpf * (~is_shoal).to(torch.float32))
    # num / max(den, 1) == where(total_fp > 0, penalty, 0): num == 0
    # whenever den == 0
    return shoal_penalty * shoal_fp + deep_penalty * deep_fp, torch.sum(fpf)


def shoal_safety_loss(predicted_class, true_class, correction_targets,
                      node_mask, shoal_penalty: float = 3.0,
                      deep_penalty: float = 1.0) -> torch.Tensor:
    """Asymmetric penalty on seafloor -> noise false positives:
    shoal-direction (correction < 0) x3 vs deep x1, normalized by the FP
    count."""
    return _mean(*shoal_safety_loss_terms(
        predicted_class, true_class, correction_targets, node_mask,
        shoal_penalty, deep_penalty))


def combined_loss(outputs: Dict[str, torch.Tensor],
                  targets: Dict[str, torch.Tensor], node_mask: torch.Tensor,
                  *, class_weights: Optional[torch.Tensor] = None,
                  classification_weight: float = 1.0,
                  correction_weight: float = 0.5,
                  confidence_weight: float = 0.2,
                  feature_preservation_weight: float = 0.3,
                  shoal_safety_weight: float = 0.5,
                  label_smoothing: float = 0.0,
                  correction_delta: float = 1.0) -> Dict[str, torch.Tensor]:
    """Weighted 5-component objective. targets: {'labels': [N] int,
    'correction': [N], 'noise_mask': [N] bool}."""
    terms = combined_loss_terms(
        outputs, targets, node_mask, class_weights=class_weights,
        label_smoothing=label_smoothing, correction_delta=correction_delta)
    return finalize_loss_terms(
        terms, classification_weight=classification_weight,
        correction_weight=correction_weight,
        confidence_weight=confidence_weight,
        feature_preservation_weight=feature_preservation_weight,
        shoal_safety_weight=shoal_safety_weight)


def combined_loss_terms(outputs: Dict[str, torch.Tensor],
                        targets: Dict[str, torch.Tensor],
                        node_mask: torch.Tensor, *,
                        class_weights: Optional[torch.Tensor] = None,
                        label_smoothing: float = 0.0,
                        correction_delta: float = 1.0) -> LossTerms:
    """Per-component (numerator, denominator) sums of the objective."""
    logits = outputs["class_logits"]
    pred = outputs["predicted_class"]
    labels = targets["labels"]
    terms = {
        "classification": classification_loss_terms(
            logits, labels, node_mask, class_weights, label_smoothing),
        "confidence": confidence_calibration_loss_terms(
            outputs["confidence"], pred, labels, node_mask),
        "feature_preservation": feature_preservation_loss_terms(
            pred, labels, node_mask),
        "shoal_safety": shoal_safety_loss_terms(
            pred, labels, targets["correction"], node_mask),
    }
    if "correction" in outputs and "correction" in targets:
        noise = targets.get("noise_mask")
        if noise is None:
            noise = labels == CLASS_NOISE
        terms["correction"] = correction_loss_terms(
            outputs["correction"], targets["correction"], noise & node_mask,
            correction_delta)
    else:
        zero = torch.zeros((), device=logits.device)
        terms["correction"] = (zero, zero)
    return terms


def finalize_loss_terms(terms: LossTerms, *,
                        classification_weight: float = 1.0,
                        correction_weight: float = 0.5,
                        confidence_weight: float = 0.2,
                        feature_preservation_weight: float = 0.3,
                        shoal_safety_weight: float = 0.5
                        ) -> Dict[str, torch.Tensor]:
    """Divide the (num, den) pairs and combine into the weighted total."""
    losses = {k: _mean(num, den) for k, (num, den) in terms.items()}
    losses["total"] = (
        classification_weight * losses["classification"]
        + correction_weight * losses["correction"]
        + confidence_weight * losses["confidence"]
        + feature_preservation_weight * losses["feature_preservation"]
        + shoal_safety_weight * losses["shoal_safety"]
    )
    return losses


def compute_class_weights(class_counts: np.ndarray,
                          smoothing: float = 0.1) -> np.ndarray:
    """Inverse-frequency class weights, smoothed, normalized to sum = C."""
    counts = np.asarray(class_counts, np.float64)
    total = counts.sum()
    freq = counts / max(total, 1.0)
    w = 1.0 / (freq + smoothing)
    w = w / w.sum() * len(counts)
    return w.astype(np.float32)


def compute_correction_delta(corrections: np.ndarray, min_delta: float = 1.0,
                             percentile: float = 95.0) -> float:
    """Huber delta = max(p95 of |corrections|, min_delta)."""
    if corrections.size == 0:
        return min_delta
    return float(max(np.percentile(np.abs(corrections), percentile),
                     min_delta))
