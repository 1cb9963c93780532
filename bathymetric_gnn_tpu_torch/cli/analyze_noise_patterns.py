"""Noise-pattern analysis CLI (port of
``bathymetric_gnn_tpu/cli/analyze_noise_patterns.py``): characterize the
real noise of a GT raster (magnitudes, sign split, rates by depth, the
swath pattern, clusters, roughness) to tune the synthetic generator.

    python -m bathymetric_gnn_tpu_torch.cli.analyze_noise_patterns gt.tif \\
        [--output-json report.json]

NumPy and SciPy on the host: no card. ``main(argv)`` returns
{raster: report}.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
from scipy import ndimage

from ..io.geotiff import read_geotiff
from .common import for_caller, setup_logging


def analyze_ground_truth(gt_path) -> dict:
    bands, _ = read_geotiff(gt_path)
    labels, diff, noisy = bands[0], bands[1], bands[2]
    valid = labels >= 0
    noise = labels == 2
    out: dict = {
        "valid_cells": int(valid.sum()),
        "noise_cells": int(noise.sum()),
        "noise_pct": round(100.0 * noise.sum() / max(valid.sum(), 1), 2),
    }
    if noise.any():
        mags = np.abs(diff[noise])
        out["magnitude_percentiles"] = {
            str(p): round(float(np.percentile(mags, p)), 4)
            for p in (50, 75, 90, 95, 99)
        }
        out["sign_split"] = {
            "shallow_pct": round(100.0 * float((diff[noise] < 0).mean()), 1),
            "deep_pct": round(100.0 * float((diff[noise] > 0).mean()), 1),
        }
        # depth-binned noise rates
        depths = noisy[valid]
        bins = np.percentile(depths, [0, 25, 50, 75, 100])
        rates = []
        for lo, hi in zip(bins[:-1], bins[1:]):
            sel = valid & (noisy >= lo) & (noisy <= hi)
            rates.append({
                "depth_range": [round(float(lo), 1), round(float(hi), 1)],
                "noise_rate_pct": round(
                    100.0 * float(noise[sel].mean()), 2) if sel.any() else 0,
            })
        out["noise_rate_by_depth"] = rates
        # swath pattern: per-column noise rate averaged over column
        # quartiles (multibeam outer-beam noise shows up at the swath
        # edges — reference: scripts/analyze_noise_patterns.py:103-112)
        col_valid = np.maximum(np.sum(valid, axis=0), 1)
        noise_by_col = np.sum(noise, axis=0) / col_valid
        q = np.array_split(noise_by_col, 4)
        out["swath_pattern"] = {
            "left_quarter_noise_rate": round(float(np.mean(q[0])), 4),
            "center_left_noise_rate": round(float(np.mean(q[1])), 4),
            "center_right_noise_rate": round(float(np.mean(q[2])), 4),
            "right_quarter_noise_rate": round(float(np.mean(q[3])), 4),
        }
        # cluster statistics (connected components)
        lbl, n_clusters = ndimage.label(noise)
        if n_clusters:
            sizes = np.bincount(lbl.ravel())[1:]
            out["clusters"] = {
                "count": int(n_clusters),
                "mean_size": round(float(sizes.mean()), 1),
                "max_size": int(sizes.max()),
                "isolated_pct": round(100.0 * float((sizes == 1).mean()), 1),
            }
        # roughness context: local std at noise vs clean cells
        filled = np.where(valid, noisy, np.nanmean(noisy[valid]))
        m = ndimage.uniform_filter(filled.astype(np.float64), 9)
        sq = ndimage.uniform_filter(filled.astype(np.float64) ** 2, 9)
        lstd = np.sqrt(np.maximum(sq - m * m, 0))
        out["roughness"] = {
            "noise_mean_local_std": round(float(lstd[noise].mean()), 4),
            "seafloor_mean_local_std": round(
                float(lstd[valid & ~noise].mean()), 4),
        }
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Analyze GT noise patterns")
    p.add_argument("ground_truth", nargs="+")
    p.add_argument("--output-json")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    setup_logging(args.verbose)
    results = {g: analyze_ground_truth(g) for g in args.ground_truth}
    print(json.dumps(results, indent=2))
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(results, f, indent=2)
    return for_caller(results, argv)


if __name__ == "__main__":
    main()
