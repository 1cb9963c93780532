"""Tiled inference CLI on the PyTorch port.

    python -m bathymetric_gnn_tpu_torch.cli.inference --input in.tif \\
        --output out.tif --model CHECKPOINT_DIR [--streaming] [--device cpu]

``--model`` is a port checkpoint directory (``utils/weights.py``). Without
``--streaming`` the survey is loaded whole (``BathymetricPipeline.process``);
with it, it is read, served and written band by band in host memory that
grows with the tile band, not with the survey
(``StreamingPipeline.process_streaming``: a GeoTIFF, SR BAG or VR BAG in,
a five-band GeoTIFF out). Runs on the CUDA card unless ``--device cpu`` is
given; fails without a card.
"""

from __future__ import annotations

import argparse
import json
import logging

from .common import for_caller, resolve_config, setup_logging

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Tiled GNN inference on a survey")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--model", required=True, help="checkpoint directory")
    p.add_argument("--config")
    p.add_argument("--tile-size", type=int)
    p.add_argument("--overlap", type=int)
    p.add_argument("--min-valid-ratio", type=float)
    p.add_argument("--confidence-threshold", type=float)
    p.add_argument("--vr-bag-mode", default="resampled",
                   choices=["refinements", "resampled", "base"])
    p.add_argument("--no-export-extras", action="store_true")
    p.add_argument("--streaming", action="store_true",
                   help="row-streaming mode for surveys larger than RAM "
                        "(GeoTIFF in/out)")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (fails "
                        "without one). 'cpu' runs the plain version")
    p.add_argument("--stats-json")
    p.add_argument("--verbose", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    setup_logging(args.verbose)
    cfg = resolve_config(args.config, args.model)
    if args.tile_size:
        cfg.tile.tile_size = args.tile_size
    if args.overlap is not None:
        cfg.tile.overlap = args.overlap
    if args.min_valid_ratio is not None:
        cfg.tile.min_valid_ratio = args.min_valid_ratio
    if args.confidence_threshold is not None:
        cfg.inference.auto_correct_threshold = args.confidence_threshold
    cfg.validate()

    if args.streaming:
        from ..inference.streaming import StreamingPipeline

        pipe = StreamingPipeline(cfg, vr_bag_mode=args.vr_bag_mode,
                                 device=args.device)
        pipe.load_model(args.model)
        stats = pipe.process_streaming(args.input, args.output)
    else:
        from ..inference.pipeline import BathymetricPipeline

        pipe = BathymetricPipeline(cfg, vr_bag_mode=args.vr_bag_mode,
                                   device=args.device)
        pipe.load_model(args.model)
        stats = pipe.process(args.input, args.output,
                             export_extras=not args.no_export_extras)
    print(json.dumps(stats, indent=2))
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=2)
    return for_caller(stats, argv)


if __name__ == "__main__":
    main()
