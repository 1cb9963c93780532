"""Ground-truth preparation from clean/noisy survey pairs (copy of
``bathymetric_gnn_tpu/data/ground_truth.py``; NumPy on the host).

Geographic intersection, region extraction, median systematic-offset
removal, |diff| noise labels, an optional S-57 overlay of class-1 discs
(an ENC cell or a features GeoJSON), and the 5-band GT raster (labels /
difference / noisy / clean / uncertainty) with its stats JSON.
"""

from __future__ import annotations

import json
import logging
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

from ..io.loaders import BathymetricGrid, BathymetricLoader
from ..io.geotiff import write_geotiff

logger = logging.getLogger(__name__)

GT_BANDS = ("labels", "difference", "noisy", "clean", "uncertainty")
GT_NODATA_LABEL = -1.0


def find_intersection(a: BathymetricGrid, b: BathymetricGrid
                      ) -> Optional[Tuple[float, float, float, float]]:
    """Overlapping geographic bounds (reference: :39-53)."""
    ba, bb = a.bounds, b.bounds
    if ba is None or bb is None:
        return None
    min_x = max(ba[0], bb[0])
    min_y = max(ba[1], bb[1])
    max_x = min(ba[2], bb[2])
    max_y = min(ba[3], bb[3])
    if min_x >= max_x or min_y >= max_y:
        return None
    return (min_x, min_y, max_x, max_y)


def extract_region(grid: BathymetricGrid,
                   bounds: Tuple[float, float, float, float]
                   ) -> Tuple[np.ndarray, Optional[np.ndarray], Tuple]:
    """Geo bounds -> pixel window (reference: :55-97)."""
    gt = grid.geotransform
    col0 = int(round((bounds[0] - gt[0]) / gt[1]))
    row0 = int(round((bounds[3] - gt[3]) / gt[5]))
    col1 = int(round((bounds[2] - gt[0]) / gt[1]))
    row1 = int(round((bounds[1] - gt[3]) / gt[5]))
    h, w = grid.depth.shape
    row0, row1 = max(row0, 0), min(row1, h)
    col0, col1 = max(col0, 0), min(col1, w)
    depth = grid.depth[row0:row1, col0:col1]
    unc = (grid.uncertainty[row0:row1, col0:col1]
           if grid.uncertainty is not None else None)
    new_gt = (gt[0] + col0 * gt[1], gt[1], 0.0,
              gt[3] + row0 * gt[5], 0.0, gt[5])
    return depth, unc, new_gt


def compute_ground_truth(
    clean_path,
    noisy_path,
    output_dir,
    noise_threshold: float = 0.15,
    vr_bag_mode: str = "resampled",
    remove_systematic_offset: bool = True,
    s57_path=None,
) -> Dict:
    """Clean/noisy pair -> labeled 5-band GT raster (reference: :99-287).

    ``s57_path`` (the reference's unshipped Phase 3, reference
    docs/TRAINING_PLAN.md:894): an S-57 .000 cell or a
    features GeoJSON (from ``extract-s57-features``) whose wreck/rock/
    obstruction points are rasterized as class-1 discs and overlaid on
    the 0/2 labels (data/s57.py create_feature_labels /
    merge_feature_labels) — real-data feature-class training signal."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    loader = BathymetricLoader(vr_bag_mode)
    clean = loader.load(clean_path)
    noisy = loader.load(noisy_path)

    # resolution sanity (reference: :134-140)
    if abs(clean.resolution[0] - noisy.resolution[0]) > 1e-6:
        raise ValueError(
            f"resolution mismatch: clean {clean.resolution} vs noisy "
            f"{noisy.resolution} — resample first"
        )

    inter = find_intersection(clean, noisy)
    if inter is not None:
        c_depth, _, gt = extract_region(clean, inter)
        n_depth, n_unc, _ = extract_region(noisy, inter)
    else:
        if clean.depth.shape != noisy.depth.shape:
            raise ValueError("no georeferencing and shapes differ")
        c_depth, n_depth = clean.depth, noisy.depth
        n_unc = noisy.uncertainty
        gt = noisy.geotransform or (0.0, noisy.resolution[0], 0.0,
                                    noisy.depth.shape[0] * noisy.resolution[1],
                                    0.0, -noisy.resolution[1])

    h = min(c_depth.shape[0], n_depth.shape[0])
    w = min(c_depth.shape[1], n_depth.shape[1])
    c_depth, n_depth = c_depth[:h, :w], n_depth[:h, :w]
    n_unc = n_unc[:h, :w] if n_unc is not None else np.zeros((h, w), np.float32)

    c_valid = np.isfinite(c_depth) & (np.abs(c_depth) < 1e5)
    if clean.nodata is not None:
        c_valid &= c_depth != clean.nodata
    n_valid = np.isfinite(n_depth) & (np.abs(n_depth) < 1e5)
    if noisy.nodata is not None:
        n_valid &= n_depth != noisy.nodata
    valid = c_valid & n_valid

    diff = np.where(valid, n_depth - c_depth, 0.0).astype(np.float32)

    offset = 0.0
    if remove_systematic_offset and valid.any():
        offset = float(np.median(diff[valid]))
        diff = np.where(valid, diff - offset, 0.0).astype(np.float32)
        logger.info("systematic offset removed: %.4f m", offset)

    labels = np.where(np.abs(diff) > noise_threshold, 2.0, 0.0)
    labels = np.where(valid, labels, GT_NODATA_LABEL).astype(np.float32)

    feature_cells = 0
    if s57_path is not None:
        from .s57 import (create_feature_labels, extract_features_from_s57,
                          load_features_geojson, merge_feature_labels)

        s57_path = str(s57_path)
        if s57_path.endswith((".json", ".geojson")):
            feats = load_features_geojson(s57_path)
        else:
            feats = extract_features_from_s57(s57_path)
        fl = create_feature_labels(feats, (h, w), gt)
        labels = merge_feature_labels(
            labels.astype(np.int32), fl).astype(np.float32)
        labels = np.where(valid, labels, GT_NODATA_LABEL).astype(np.float32)
        feature_cells = int((labels == 1).sum())
        logger.info("S-57 overlay: %d features -> %d class-1 cells",
                    len(feats), feature_cells)

    stem = Path(noisy_path).stem
    out_raster = output_dir / f"{stem}_ground_truth.tif"
    bands = np.stack([
        labels, diff,
        np.where(valid, n_depth, np.nan).astype(np.float32),
        np.where(valid, c_depth, np.nan).astype(np.float32),
        np.where(valid, n_unc, 0.0).astype(np.float32),
    ])
    write_geotiff(
        out_raster, bands,
        pixel_scale=(abs(gt[1]), abs(gt[5])) if gt else None,
        origin=(gt[0], gt[3]) if gt else None,
        nodata=GT_NODATA_LABEL, crs_wkt=noisy.crs,
        band_descriptions=list(GT_BANDS),
    )

    nv = max(int(valid.sum()), 1)
    noise_cells = int((labels == 2).sum())
    seafloor_diff = diff[valid & (labels == 0)]
    stats = {
        "output": str(out_raster),
        "valid_cells": int(valid.sum()),
        "noise_cells": noise_cells,
        "noise_pct": round(100.0 * noise_cells / nv, 2),
        "feature_cells": feature_cells,
        "systematic_offset_m": round(offset, 4),
        "noise_threshold_m": noise_threshold,
        "diff_stats": {
            "mean": round(float(diff[valid].mean()), 4) if valid.any() else 0,
            "std": round(float(diff[valid].std()), 4) if valid.any() else 0,
            "p95_abs": round(float(np.percentile(np.abs(diff[valid]), 95)), 4)
            if valid.any() else 0,
        },
        "seafloor_mean_diff": round(float(seafloor_diff.mean()), 4)
        if seafloor_diff.size else 0,
    }
    with open(output_dir / f"{stem}_gt_stats.json", "w") as f:
        json.dump(stats, f, indent=2)
    logger.info("ground truth written: %s (%.1f%% noise)", out_raster,
                stats["noise_pct"])
    return stats
