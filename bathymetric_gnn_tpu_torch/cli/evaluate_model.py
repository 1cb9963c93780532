"""Model evaluation CLI (port of ``bathymetric_gnn_tpu/cli/evaluate_model.py``):
score predictions (the classification and confidence bands of an
inference output or sidecar) against a ground-truth raster.

    python -m bathymetric_gnn_tpu_torch.cli.evaluate_model \\
        --predictions out.tif --ground-truth gt.tif [--output-json m.json]

NumPy only: it runs no model and needs no card. ``main(argv)`` returns
the metrics it printed.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..io.geotiff import read_geotiff
from ..training.evaluation import compute_metrics, print_metrics
from .common import for_caller, setup_logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate predictions vs GT")
    p.add_argument("--predictions", required=True,
                   help="raster with classification+confidence bands "
                        "(inference extras / sidecar)")
    p.add_argument("--ground-truth", required=True,
                   help="5-band GT raster (band 1 = labels)")
    p.add_argument("--class-band", type=int, default=2,
                   help="1-indexed classification band in predictions "
                        "(default 2: depth,class,conf,...)")
    p.add_argument("--confidence-band", type=int, default=3)
    p.add_argument("--output-json")
    p.add_argument("--verbose", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    setup_logging(args.verbose)

    pred_bands, _ = read_geotiff(args.predictions)
    gt_bands, _ = read_geotiff(args.ground_truth)
    labels = gt_bands[0]
    pred = pred_bands[args.class_band - 1]
    conf = (pred_bands[args.confidence_band - 1]
            if pred_bands.shape[0] >= args.confidence_band else None)

    h = min(labels.shape[0], pred.shape[0])
    w = min(labels.shape[1], pred.shape[1])
    valid = (labels[:h, :w] >= 0) & np.isfinite(pred[:h, :w])
    metrics = compute_metrics(
        np.nan_to_num(pred[:h, :w], nan=-1), labels[:h, :w],
        conf[:h, :w] if conf is not None else None, valid,
    )
    print_metrics(metrics)
    if args.output_json:
        with open(args.output_json, "w") as f:
            json.dump(metrics, f, indent=2)
    return for_caller(metrics, argv)


if __name__ == "__main__":
    main()
