"""Native BAG inference CLI on the PyTorch port (port of
``bathymetric_gnn_tpu/cli/inference_native.py``): auto VR/SR detection,
bucketed refinement batching, in-place copy-and-modify output,
finest-resolution sidecar GeoTIFF.

    python -m bathymetric_gnn_tpu_torch.cli.inference_native \\
        --input in.bag --output out.bag --model CHECKPOINT_DIR \\
        [--knn-k 8] [--device cpu]

``--model`` is a port checkpoint directory (``utils/weights.py``) of
graph-trained weights (``trained_layout`` "coo"). Without ``--knn-k`` the
configuration's ``graph.knn_k`` (default 0) picks the route: 0 is the
default VR route (small refinements in slabs through the dense grid model,
bf16 on the card; larger grids on grid-connectivity graphs), > 0 the k-NN
route (``inference/native_vr``). Runs on the CUDA card unless ``--device
cpu`` is given; fails without a card. Prints the stats JSON on stdout;
``main(argv)`` returns the stats.
"""

from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np

from .common import for_caller, resolve_config, setup_logging

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Native VR/SR BAG inference")
    p.add_argument("--input", required=True, help="input .bag")
    p.add_argument("--output", required=True, help="output .bag (copy-modify)")
    p.add_argument("--model", required=True, help="checkpoint directory")
    p.add_argument("--config")
    p.add_argument("--min-valid-ratio", type=float, default=0.05)
    p.add_argument("--confidence-threshold", type=float, default=0.85)
    p.add_argument("--confidence-temperature", type=float,
                   help="override the checkpoint's fitted confidence "
                        "temperature (calibration.json); 1.0 disables "
                        "calibration")
    p.add_argument("--batch-node-budget", type=int, default=50000)
    p.add_argument("--knn-k", type=int,
                   help="override graph.knn_k: >0 builds k-NN graphs over "
                        "valid cells; 0 is the default VR route")
    p.add_argument("--sparse-kernel",
                   choices=["auto", "xla", "banded", "banded_pallas"],
                   help="override model.sparse_kernel (auto = "
                        "banded_pallas, kernel C, for k-NN GAT; banded = "
                        "kernel E and the spill fold on 128-row bands; xla "
                        "= GATConvELL, also kernel C; knn_k 0 takes xla)")
    p.add_argument("--no-sidecar", action="store_true")
    p.add_argument("--no-uncertainty-scaling", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (fails "
                        "without one). 'cpu' runs the plain version")
    p.add_argument("--verbose", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    setup_logging(args.verbose)
    if not (0.0 <= args.confidence_threshold <= 1.0):
        raise SystemExit("confidence-threshold must be in [0, 1]")
    cfg = resolve_config(args.config, args.model)

    from ..config.constants import CLASS_NOISE
    from ..inference.pipeline import (apply_confidence_calibration,
                                      load_confidence_calibration)
    from ..utils.weights import load_state_dict

    state_dict, meta = load_state_dict(args.model)
    if args.confidence_temperature is not None:
        conf_cal = (1.0 / args.confidence_temperature, 0.0)
    else:
        cal = load_confidence_calibration(args.model)
        conf_cal = (cal["scale"], cal["bias"])
    if conf_cal != (1.0, 0.0):
        logger.info("confidence calibration scale=%.4f bias=%.4f "
                    "(calibration.json)", *conf_cal)
    if meta.get("trained_layout", "grid") == "grid":
        raise SystemExit("native VR inference needs a COO-layout checkpoint "
                         "(trained with the graph Trainer)")
    # the model's widths are the checkpoint's, whatever --config says
    cfg.model = resolve_config(None, args.model).model
    if args.knn_k is not None:
        cfg.graph.knn_k = args.knn_k
    if args.sparse_kernel is not None:
        cfg.model.sparse_kernel = args.sparse_kernel

    from ..inference.native_vr import NativeVRProcessor
    from ..io.bag import (SidecarBuilder, SRBagHandler, VRBagHandler,
                          detect_bag_type)

    proc = NativeVRProcessor(state_dict, cfg,
                             node_budget=args.batch_node_budget,
                             device=args.device)

    kind = detect_bag_type(args.input)
    handler = (VRBagHandler(args.input) if kind == "VR"
               else SRBagHandler(args.input))
    logger.info("%s BAG: %s", kind, handler.get_refinement_info())
    writer = handler.copy_and_open_for_writing(args.output)
    sidecar = None if args.no_sidecar else SidecarBuilder(handler)

    stats = {"grids": 0, "cells_corrected": 0, "total_nodes": 0,
             "confidences": []}

    def apply_results(grid, out):
        """Subtract corrections on confident noise, scale uncertainty by
        2 - confidence there."""
        valid = grid.valid_mask
        conf = apply_confidence_calibration(out["confidence"], *conf_cal)
        m = (valid & (out["classification"] == CLASS_NOISE)
             & (conf >= args.confidence_threshold))
        corrected = grid.depth.copy()
        corrected[m] -= out["correction"][m]
        unc = grid.uncertainty.copy()
        if not args.no_uncertainty_scaling:
            unc[m] *= (2.0 - conf[m])
        writer.update_refinement_batch(grid, corrected, unc)
        if sidecar is not None:
            sidecar.add_refinement_results(
                grid, out["classification"].astype(np.float32),
                conf, out["correction"])
        stats["grids"] += 1
        stats["cells_corrected"] += int(m.sum())
        stats["total_nodes"] += int(valid.sum())
        if valid.any():
            stats["confidences"].append(float(conf[valid].mean()))

    try:
        for grid in handler.iterate_refinements(args.min_valid_ratio):
            proc.add_to_batch(grid.depth, grid.uncertainty, grid.resolution,
                              context=grid)
            if proc.batch_ready():
                for out in proc.flush_batch():
                    apply_results(out["context"], out)
            if stats["grids"] and stats["grids"] % 100 == 0:
                logger.info("processed %d grids", stats["grids"])
        for out in proc.drain():
            apply_results(out["context"], out)
    finally:
        writer.close()

    if sidecar is not None:
        sidecar_path = Path(args.output).with_name(
            Path(args.output).stem + "_gnn_outputs.tif")
        sidecar.save(sidecar_path)
        stats["sidecar"] = str(sidecar_path)

    confs = stats.pop("confidences")
    stats["mean_confidence"] = (round(float(np.mean(confs)), 4)
                                if confs else 0.0)
    print(json.dumps(stats, indent=2))
    return for_caller(stats, argv)


if __name__ == "__main__":
    main()
