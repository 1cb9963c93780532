"""Training-target helpers (port of ``bathymetric_gnn_tpu/training/datasets.py``:
``normalize_correction``). The COO graph datasets are ported with the COO
path (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import numpy as np

from ..config.constants import CORRECTION_NORM_CAP, CORRECTION_NORM_FLOOR


def normalize_correction(raw_correction: np.ndarray,
                         local_std: np.ndarray) -> np.ndarray:
    """correction / max(local_std, FLOOR), clipped to +-CAP."""
    denom = np.maximum(local_std, CORRECTION_NORM_FLOOR)
    return np.clip(raw_correction / denom, -CORRECTION_NORM_CAP,
                   CORRECTION_NORM_CAP).astype(np.float32)
