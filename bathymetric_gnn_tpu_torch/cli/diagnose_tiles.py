"""Tile diagnostics CLI (port of ``bathymetric_gnn_tpu/cli/diagnose_tiles.py``):
cell validity breakdown, per-tile valid ratios and the alternate-nodata
hunt, as JSON.

    python -m bathymetric_gnn_tpu_torch.cli.diagnose_tiles survey.tif \\
        [--tile-size 1024] [--overlap 128]

NumPy on the host: no card. ``main(argv)`` returns
{survey: report}.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..data.tiling import TileManager
from ..io.loaders import BathymetricLoader
from .common import for_caller, setup_logging


def diagnose(path, tile_size=1024, overlap=128, vr_bag_mode="resampled"):
    grid = BathymetricLoader(vr_bag_mode).load(path)
    d = grid.depth
    finite = np.isfinite(d)
    out = {
        "shape": list(d.shape),
        "cells": int(d.size),
        "nan": int(np.isnan(d).sum()),
        "inf": int(np.isinf(d).sum()),
        "nodata": int((d == grid.nodata).sum()) if grid.nodata is not None else 0,
        "finite": int(finite.sum()),
        "valid": int(grid.valid_mask.sum()),
        "valid_ratio": round(grid.valid_ratio, 4),
    }
    # most-common values among finite cells — alternate-nodata hunt
    if finite.any():
        vals, counts = np.unique(np.round(d[finite], 3), return_counts=True)
        top = np.argsort(counts)[::-1][:5]
        out["most_common_values"] = [
            {"value": float(vals[i]), "count": int(counts[i]),
             "pct": round(100.0 * counts[i] / finite.sum(), 2)}
            for i in top
        ]
    tm = TileManager(tile_size, overlap, min_valid_ratio=0.0)
    _, _, specs = tm.compute_tile_grid(d.shape)
    ratios = []
    vm = grid.valid_mask
    for s in specs:
        ratios.append(float(vm[s.row_start:s.row_end,
                              s.col_start:s.col_end].mean()))
    ratios = np.array(ratios)
    out["tiles"] = {
        "total": len(specs),
        "kept_at_threshold": {
            str(t): int((ratios >= t).sum()) for t in (0.01, 0.05, 0.1, 0.3, 0.5)
        },
        "mean_valid_ratio": round(float(ratios.mean()), 4),
    }
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Diagnose tile validity")
    p.add_argument("survey", nargs="+")
    p.add_argument("--tile-size", type=int, default=1024)
    p.add_argument("--overlap", type=int, default=128)
    p.add_argument("--vr-bag-mode", default="resampled")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    setup_logging(args.verbose)
    results = {}
    for s in args.survey:
        results[s] = diagnose(s, args.tile_size, args.overlap,
                              args.vr_bag_mode)
        print(json.dumps({s: results[s]}, indent=2))
    return for_caller(results, argv)


if __name__ == "__main__":
    main()
