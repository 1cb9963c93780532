"""Ground-truth preparation CLI (port of
``bathymetric_gnn_tpu/cli/prepare_ground_truth.py``).

    python -m bathymetric_gnn_tpu_torch.cli.prepare_ground_truth \\
        --clean clean.tif --noisy noisy.tif --output-dir gt [--s57 cell.000]

Writes ``<noisy stem>_ground_truth.tif`` and ``<noisy stem>_gt_stats.json``
and prints the stats; ``main(argv)`` returns them. Host only: no card.
"""

from __future__ import annotations

import argparse
import json

from ..data.ground_truth import compute_ground_truth
from .common import for_caller, setup_logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Build labeled GT raster from a clean/noisy survey pair")
    p.add_argument("--clean", required=True)
    p.add_argument("--noisy", required=True)
    p.add_argument("--output-dir", required=True)
    p.add_argument("--noise-threshold", type=float, default=0.15)
    p.add_argument("--vr-bag-mode", default="resampled",
                   choices=["refinements", "resampled", "base"])
    p.add_argument("--keep-systematic-offset", action="store_true")
    p.add_argument("--s57", help="S-57 .000 cell or features GeoJSON "
                                 "(from extract-s57-features): overlay "
                                 "wreck/rock/obstruction points as "
                                 "class-1 labels")
    p.add_argument("--verbose", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    setup_logging(args.verbose)
    stats = compute_ground_truth(
        args.clean, args.noisy, args.output_dir,
        noise_threshold=args.noise_threshold,
        vr_bag_mode=args.vr_bag_mode,
        remove_systematic_offset=not args.keep_systematic_offset,
        s57_path=args.s57,
    )
    print(json.dumps(stats, indent=2))
    return for_caller(stats, argv)


if __name__ == "__main__":
    main()
