"""S-57/ENC feature extraction CLI (port of
``bathymetric_gnn_tpu/cli/extract_s57_features.py``): parse local .000 ENC
cells (ISO 8211, no OGR), load a GeoJSON, or, with ``--bounds`` alone,
query NOAA's ENC REST service (needs the network); export GeoJSON;
rasterize class-1 label discs aligned to a survey raster.

    python -m bathymetric_gnn_tpu_torch.cli.extract_s57_features \\
        --enc cell.000 [--bounds MINX MINY MAXX MAXY] \\
        [--output-geojson f.json] [--survey s.tif --output-labels l.tif]
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from ..data import s57
from ..io.geotiff import write_geotiff
from ..io.loaders import BathymetricLoader
from .common import setup_logging


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Extract S-57 nav features")
    src = p.add_mutually_exclusive_group(required=False)
    src.add_argument("--geojson", help="load features from GeoJSON")
    src.add_argument("--enc", nargs="+",
                     help="local S-57 ENC cell(s) (.000), parsed natively")
    p.add_argument("--bounds", nargs=4, type=float,
                   metavar=("MINX", "MINY", "MAXX", "MAXY"),
                   help="envelope: REST query region when used alone, "
                        "spatial filter when combined with --enc "
                        "(reference supports both together)")
    p.add_argument("--survey", help="survey raster to align labels to")
    p.add_argument("--output-geojson")
    p.add_argument("--output-labels", help="write label raster (.tif)")
    p.add_argument("--wreck-radius", type=float, default=50.0)
    p.add_argument("--rock-radius", type=float, default=25.0)
    p.add_argument("--obstruction-radius", type=float, default=30.0)
    p.add_argument("--verbose", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    setup_logging(args.verbose)

    if not (args.geojson or args.enc or args.bounds):
        raise SystemExit("one of --geojson, --enc, or --bounds is required")
    bounds = tuple(args.bounds) if args.bounds else None
    if args.geojson:
        features = s57.load_features_geojson(args.geojson)
    elif args.enc:
        features = []
        for cell in args.enc:
            features.extend(s57.extract_features_from_s57(
                cell, bounds=bounds))
        features = s57.dedupe_by_position(features)
    else:
        features = s57.query_features_from_rest(bounds)

    print(json.dumps(s57.summarize_features(features), indent=2))
    if args.output_geojson:
        s57.features_to_geojson(features, args.output_geojson)

    if args.output_labels:
        if not args.survey:
            raise SystemExit("--output-labels requires --survey for alignment")
        grid = BathymetricLoader().load(args.survey)
        radii = {"WRECKS": args.wreck_radius, "UWTROC": args.rock_radius,
                 "OBSTRN": args.obstruction_radius}
        labels = s57.create_feature_labels(
            features, grid.depth.shape, grid.geotransform,
            feature_radius=radii,
        )
        gt = grid.geotransform
        write_geotiff(
            args.output_labels, labels.astype(np.float32)[None],
            pixel_scale=(abs(gt[1]), abs(gt[5])), origin=(gt[0], gt[3]),
            nodata=-1.0, crs_wkt=grid.crs,
            band_descriptions=["feature_labels"],
        )


if __name__ == "__main__":
    main()
