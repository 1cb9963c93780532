"""Model-quality metrics (copy of
``bathymetric_gnn_tpu/training/evaluation.py``, the reference's quality
gate).

Overall accuracy, per-class precision/recall/F1/support, the confusion
matrix and confidence calibration (accuracy and coverage at thresholds),
with the JAX module's JSON keys and rounding. NumPy only.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

CLASS_NAMES = ("seafloor", "feature", "noise")


def compute_metrics(
    predictions: np.ndarray,
    labels: np.ndarray,
    confidence: Optional[np.ndarray] = None,
    valid_mask: Optional[np.ndarray] = None,
    num_classes: int = 3,
    thresholds: Sequence[float] = (0.5, 0.6, 0.7, 0.8, 0.9),
) -> Dict:
    """Reference: scripts/evaluate_model.py:57-120."""
    predictions = np.asarray(predictions).ravel()
    labels = np.asarray(labels).ravel()
    if valid_mask is None:
        valid_mask = labels >= 0
    else:
        valid_mask = np.asarray(valid_mask).ravel() & (labels >= 0)
    p = predictions[valid_mask].astype(np.int64)
    y = labels[valid_mask].astype(np.int64)
    n = len(y)
    out: Dict = {"n_cells": int(n)}
    if n == 0:
        return out

    out["accuracy"] = float((p == y).mean())

    conf_mat = np.zeros((num_classes, num_classes), np.int64)
    np.add.at(conf_mat, (y, p), 1)
    out["confusion_matrix"] = conf_mat.tolist()

    per_class = {}
    for c in range(num_classes):
        tp = int(conf_mat[c, c])
        fp = int(conf_mat[:, c].sum() - tp)
        fn = int(conf_mat[c, :].sum() - tp)
        prec = tp / max(tp + fp, 1)
        rec = tp / max(tp + fn, 1)
        f1 = 2 * prec * rec / max(prec + rec, 1e-12)
        per_class[CLASS_NAMES[c] if c < len(CLASS_NAMES) else str(c)] = {
            "precision": round(prec, 4), "recall": round(rec, 4),
            "f1": round(f1, 4), "support": int(conf_mat[c, :].sum()),
        }
    out["per_class"] = per_class
    out["macro_f1"] = round(
        float(np.mean([v["f1"] for v in per_class.values()])), 4
    )

    if confidence is not None:
        conf = np.asarray(confidence).ravel()[valid_mask]
        calibration = {}
        for t in thresholds:
            sel = conf >= t
            calibration[f"{t:.1f}"] = {
                "coverage": round(float(sel.mean()), 4),
                "accuracy": round(float((p[sel] == y[sel]).mean()), 4)
                if sel.any() else None,
            }
        out["calibration"] = calibration
        out["mean_confidence"] = round(float(conf.mean()), 4)
        out["mean_confidence_correct"] = round(
            float(conf[p == y].mean()), 4) if (p == y).any() else None
        out["mean_confidence_wrong"] = round(
            float(conf[p != y].mean()), 4) if (p != y).any() else None
    return out


def print_metrics(metrics: Dict) -> str:
    """Human-readable report (reference: scripts/evaluate_model.py:123-188)."""
    lines = []
    lines.append(f"cells evaluated: {metrics.get('n_cells', 0):,}")
    if "accuracy" in metrics:
        lines.append(f"overall accuracy: {metrics['accuracy']:.4f}")
        lines.append(f"macro F1: {metrics['macro_f1']:.4f}")
        lines.append("per-class:")
        for name, m in metrics["per_class"].items():
            lines.append(
                f"  {name:10s} P={m['precision']:.3f} R={m['recall']:.3f} "
                f"F1={m['f1']:.3f} n={m['support']:,}"
            )
        cm = np.array(metrics["confusion_matrix"])
        lines.append("confusion (rows=true, cols=pred):")
        for row in cm:
            lines.append("  " + " ".join(f"{v:>10,}" for v in row))
        if "calibration" in metrics:
            lines.append("confidence calibration:")
            for t, m in metrics["calibration"].items():
                acc = f"{m['accuracy']:.3f}" if m["accuracy"] is not None else "n/a"
                lines.append(f"  conf>={t}: coverage={m['coverage']:.3f} "
                             f"accuracy={acc}")
    report = "\n".join(lines)
    print(report)
    return report
