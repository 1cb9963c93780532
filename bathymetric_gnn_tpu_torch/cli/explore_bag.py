"""BAG/HDF5 structure explorer CLI (port of
``bathymetric_gnn_tpu/cli/explore_bag.py``): a recursive dump of the HDF5
tree plus refinement summaries.

    python -m bathymetric_gnn_tpu_torch.cli.explore_bag survey.bag

Needs h5py (imported with the module); no card. ``main(argv)`` returns
{bag: report}.
"""

from __future__ import annotations

import argparse
import json

import h5py
import numpy as np

from .common import for_caller, setup_logging


def explore_hdf5(path) -> dict:
    out = {}

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            out[name] = {
                "shape": list(obj.shape),
                "dtype": str(obj.dtype),
                "attrs": {k: str(v) for k, v in obj.attrs.items()},
            }
        else:
            out[name] = {"group": True,
                         "attrs": {k: str(v) for k, v in obj.attrs.items()}}

    with h5py.File(str(path), "r") as f:
        f.visititems(visit)
    return out


def analyze_bag(path) -> dict:
    from ..io.bag import SRBagHandler, VRBagHandler, detect_bag_type

    kind = detect_bag_type(path)
    out = {"type": kind, "structure": explore_hdf5(path)}
    handler = VRBagHandler(path) if kind == "VR" else SRBagHandler(path)
    info = handler.get_refinement_info()
    info["base_shape"] = list(info["base_shape"])
    if "unique_dimensions" in info:
        info["unique_dimensions"] = [list(map(int, d))
                                     for d in info["unique_dimensions"]]
    if "unique_resolutions" in info:
        info["unique_resolutions"] = [float(r)
                                      for r in info["unique_resolutions"]]
    out["refinement_info"] = info
    out["bounds"] = list(handler.bounds)
    if kind == "VR":
        out["finest_resolution"] = handler.finest_resolution
        out["resampled_shape"] = list(handler.resampled_shape)
        # sample a few refinement grids
        samples = []
        for i, g in enumerate(handler.iterate_refinements()):
            if i >= 3:
                break
            samples.append({
                "base_cell": [g.base_row, g.base_col],
                "dimensions": list(g.dimensions),
                "resolution": list(g.resolution),
                "valid_cells": g.num_valid,
                "depth_range": [float(np.min(g.depth[g.valid_mask])),
                                float(np.max(g.depth[g.valid_mask]))]
                if g.num_valid else None,
            })
        out["sample_refinements"] = samples
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description="Explore BAG/HDF5 structure")
    p.add_argument("bag", nargs="+")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    setup_logging(args.verbose)
    results = {}
    for b in args.bag:
        results[b] = analyze_bag(b)
        print(json.dumps({b: results[b]}, indent=2))
    return for_caller(results, argv)


if __name__ == "__main__":
    main()
