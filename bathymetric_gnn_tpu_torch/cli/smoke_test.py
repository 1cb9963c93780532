"""Staged pipeline smoke test on the PyTorch port (port of
``bathymetric_gnn_tpu/cli/smoke_test.py``).

    python -m bathymetric_gnn_tpu_torch.cli.smoke_test [--survey FILE] \\
        [--device cpu]

Runs each component in dependency order against synthetic (or real) data
and aborts on the first failure with exit code 1: imports, data loading,
tiling, graph construction, synthetic noise, the COO model's forward
(``models/gnn.BathymetricGNN``, hidden 16, 2 layers, 2 heads, with
``predict_with_thresholds``: kernel F's segment sums on the card), the
dense grid path (``GridBathymetricGNN``: kernel A on the card) and a
memory estimate. The models run on the CUDA card unless ``--device cpu``
is given; without a card the first stage that needs one fails.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from .common import setup_logging


def stage(name):
    def deco(fn):
        fn._stage_name = name
        return fn
    return deco


@stage("imports")
def check_imports(ctx):
    import torch

    from .. import (config, data, inference, io, models, ops,  # noqa: F401
                    parallel, training, utils)
    from ..parallel import (collectives, data_parallel, halo,  # noqa: F401
                            halo2d, mesh)
    from ..inference.pipeline import resolve_device

    ctx["dev"] = dev = resolve_device(ctx["device"])
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return f"torch {torch.__version__}, device: {dev} ({name})"


@stage("data loading")
def test_data_loading(ctx):
    from ..io.loaders import BathymetricGrid, BathymetricLoader

    if ctx["survey"]:
        grid = BathymetricLoader(ctx["vr_bag_mode"]).load(ctx["survey"])
    else:
        h = w = 128
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        depth = 30 + 0.05 * xx + 0.3 * np.sin(yy / 5)
        grid = BathymetricGrid(depth=depth)
    ctx["grid"] = grid
    s = grid.get_statistics()
    return (f"{grid.depth.shape} grid, {s.get('count', 0):,} valid cells, "
            f"depth {s.get('min', 0):.1f}..{s.get('max', 0):.1f}")


@stage("tiling")
def test_tiling(ctx):
    from ..data.tiling import TileManager

    grid = ctx["grid"]
    ts = min(64, min(grid.depth.shape))
    tm = TileManager(ts, ts // 8, 0.05)
    tiles = list(tm.iterate_tiles(grid.depth, valid_mask=grid.valid_mask))
    ctx["tile"] = tiles[0]
    return f"{len(tiles)} tiles of {ts}x{ts}"


@stage("graph construction")
def test_graph_construction(ctx):
    from ..data.graph_build import GraphBuilder

    t = ctx["tile"]
    bg = GraphBuilder().build_graph(np.nan_to_num(t.data), t.valid_mask)
    x = np.asarray(bg.graph.x)
    if not np.isfinite(x).all():
        raise ValueError("non-finite node features")
    ctx["built_graph"] = bg
    return (f"{bg.num_nodes} nodes, "
            f"{int(np.asarray(bg.graph.edge_mask).sum())} edges, "
            f"{x.shape[1]} features")


@stage("synthetic noise")
def test_synthetic_noise(ctx):
    from ..data.synthetic_noise import SyntheticNoiseGenerator

    t = ctx["tile"]
    lbl = SyntheticNoiseGenerator(seed=0).generate(
        np.nan_to_num(t.data), t.valid_mask)
    pct = 100.0 * lbl.noise_mask.sum() / max(t.valid_mask.sum(), 1)
    if not lbl.noise_mask.any():
        raise ValueError("no noise generated")
    return f"{lbl.noise_mask.sum()} noisy cells ({pct:.1f}% of valid)"


@stage("model forward")
def test_model_forward(ctx):
    import torch

    from ..models.gnn import BathymetricGNN, predict_with_thresholds
    from ..ops.graph import CooGraph

    bg = ctx["built_graph"]
    g = CooGraph.from_padded(bg.graph, src_table=False).to(ctx["dev"])
    model = BathymetricGNN(
        g.x.shape[-1], hidden_channels=16, num_layers=2, heads=2,
        edge_dim=g.edge_attr.shape[-1],
        generator=torch.Generator().manual_seed(0)).to(ctx["dev"]).eval()
    with torch.no_grad():
        out = predict_with_thresholds(model(g))
    n = bg.num_nodes
    cls = out["predicted_class"].cpu().numpy()[:n]
    dist = {int(c): int((cls == c).sum()) for c in np.unique(cls)}
    if not torch.isfinite(out["class_logits"]).all():
        raise ValueError("non-finite class logits")
    return f"untrained class distribution: {dist}"


@stage("dense grid path")
def test_grid_path(ctx):
    import torch

    from ..data.graph_build import build_grid_inputs
    from ..models.grid_gat import GridBathymetricGNN

    t = ctx["tile"]
    dev = ctx["dev"]
    feats, v, nbr, eattr, _ = build_grid_inputs(
        torch.from_numpy(np.nan_to_num(t.data).astype(np.float32)[None]
                         ).to(dev),
        torch.from_numpy(np.asarray(t.valid_mask)[None]).to(dev))
    model = GridBathymetricGNN(
        feats.shape[-1], hidden_channels=16, num_layers=2, heads=2,
        generator=torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.no_grad():
        out = model(feats, v, nbr, eattr)
    if not torch.isfinite(out["class_logits"]).all():
        raise ValueError("non-finite class logits")
    return f"grid forward ok: {tuple(out['class_logits'].shape)}"


@stage("memory estimate")
def test_memory_estimate(ctx):
    grid = ctx["grid"]
    n = int(grid.valid_mask.sum())
    edges = n * 8
    feat_bytes = n * 8 * 4
    model_act = n * 64 * 4 * 4 * 4  # hidden*heads*layers*f32
    total_mb = (feat_bytes + edges * 3 * 4 + model_act) / 1e6
    return f"~{total_mb:.0f} MB activations for full survey at once"


STAGES = [check_imports, test_data_loading, test_tiling,
          test_graph_construction, test_synthetic_noise, test_model_forward,
          test_grid_path, test_memory_estimate]


def main(argv=None):
    p = argparse.ArgumentParser(description="Staged pipeline smoke test")
    p.add_argument("--survey", help="optional real survey file")
    p.add_argument("--vr-bag-mode", default="resampled")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (fails "
                        "without one). 'cpu' runs the plain versions")
    p.add_argument("--verbose", action="store_true")
    args = p.parse_args(argv)
    setup_logging(args.verbose)

    ctx = {"survey": args.survey, "vr_bag_mode": args.vr_bag_mode,
           "device": args.device}
    for fn in STAGES:
        name = fn._stage_name
        t0 = time.time()
        try:
            msg = fn(ctx)
        except Exception as e:  # abort on the first failure
            print(f"[FAIL] {name}: {e}")
            sys.exit(1)
        print(f"[ ok ] {name} ({time.time() - t0:.1f}s): {msg}")
    print("all stages passed")


if __name__ == "__main__":
    main()
