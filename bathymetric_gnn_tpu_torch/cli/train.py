"""Training CLI on the PyTorch port (port of ``bathymetric_gnn_tpu/cli/train.py``).

    python -m bathymetric_gnn_tpu_torch.cli.train --trainer graph --knn-k 8 \\
        --data-dir SURVEYS --output-dir RUN [--device cpu]
    python -m bathymetric_gnn_tpu_torch.cli.train --trainer grid \\
        --data-dir SURVEYS --output-dir RUN [--device cpu]

The flags and defaults are the JAX CLI's, plus ``--device``. Two data
modes: ``--ground-truth-dir`` (5-band GT rasters) or ``--data-dir`` (clean
surveys + synthetic noise). Two trainers: ``--trainer graph`` with
``--knn-k K`` (K > 0) trains the ELL model on k-NN tile graphs
(``training/trainer.Trainer``); ``--trainer grid`` trains the batched
dense-grid model. Not ported: the graph trainer on grid-connectivity
graphs (``knn_k == 0``) or with ``--sparse-kernel xla`` (the COO path),
k-NN graphs with the grid trainer, and the non-GAT layer types; they exit
naming ROADMAP queue 1 item 11. Runs on the CUDA card unless ``--device
cpu`` is given; fails without a card.
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

import numpy as np

from .common import resolve_config, setup_logging

logger = logging.getLogger(__name__)

SURVEY_EXTS = (".bag", ".tif", ".tiff", ".asc")
NOT_PORTED = ("{what} is not ported to the PyTorch port yet (ROADMAP queue 1 "
              "item 11: the COO graph path); use --trainer graph --knn-k 8 "
              "or --trainer grid, with GAT, or the JAX package")


def find_survey_files(directory):
    d = Path(directory)
    return sorted(p for p in d.rglob("*") if p.suffix.lower() in SURVEY_EXTS)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train the bathymetric GNN")
    p.add_argument("--data-dir", help="clean surveys for synthetic-noise mode")
    p.add_argument("--ground-truth-dir", help="5-band GT rasters")
    p.add_argument("--val-split", type=float, default=0.2)
    p.add_argument("--config", help="YAML config")
    p.add_argument("--output-dir", default="checkpoints")
    p.add_argument("--epochs", type=int)
    p.add_argument("--batch-size", type=int)
    p.add_argument("--learning-rate", type=float)
    p.add_argument("--tile-size", type=int, default=256)
    p.add_argument("--overlap", type=int, default=32)
    p.add_argument("--vr-bag-mode", default="resampled",
                   choices=["refinements", "resampled", "base"])
    p.add_argument("--gnn-type", choices=["GAT", "GCN", "GraphSAGE", "GIN"])
    p.add_argument("--hidden-channels", type=int)
    p.add_argument("--num-layers", type=int)
    p.add_argument("--heads", type=int)
    p.add_argument("--seed", type=int)
    p.add_argument("--num-workers", type=int,
                   help="host input-pipeline worker processes (kept for the "
                        "config; the trainers prefetch in a thread)")
    p.add_argument("--knn-k", type=int,
                   help=">0: train on k-NN graphs over valid cells (the "
                        "graph trainer; kernels C, C' and F on the card)")
    p.add_argument("--sparse-kernel",
                   choices=["auto", "xla", "banded", "banded_pallas"],
                   help="sparse message-passing kernel for knn graphs")
    p.add_argument("--trainer", choices=["graph", "grid"], default="graph",
                   help="graph: batched-graph trainer (k-NN graphs only); "
                        "grid: batched dense-grid trainer")
    p.add_argument("--resume", action="store_true",
                   help="resume from output-dir/last")
    p.add_argument("--synthetic-features", action="store_true",
                   help="inject class-1 seafloor features (wreck/rock "
                        "shoals) into the synthetic training surfaces")
    p.add_argument("--device", default=None,
                   help="torch device; default: the CUDA card (fails "
                        "without one). 'cpu' runs the plain versions")
    p.add_argument("--verbose", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    """Returns the trained ``TrainState`` (the model and its optimizer)."""
    args = parse_args(argv)
    setup_logging(args.verbose)
    cfg = resolve_config(args.config)

    for sec, key, val in [
        ("training", "epochs", args.epochs),
        ("training", "batch_size", args.batch_size),
        ("training", "learning_rate", args.learning_rate),
        ("training", "seed", args.seed),
        ("training", "num_workers", args.num_workers),
        ("model", "gnn_type", args.gnn_type),
        ("model", "hidden_channels", args.hidden_channels),
        ("model", "num_layers", args.num_layers),
        ("model", "heads", args.heads),
        ("graph", "knn_k", args.knn_k),
        ("model", "sparse_kernel", args.sparse_kernel),
    ]:
        if val is not None:
            setattr(getattr(cfg, sec), key, val)
    if args.synthetic_features:
        cfg.synthetic_noise.feature_enabled = True
    cfg.validate()

    if cfg.model.gnn_type != "GAT":
        raise SystemExit(NOT_PORTED.format(
            what=f"--gnn-type {cfg.model.gnn_type}"))
    if args.trainer == "graph":
        if cfg.graph.knn_k <= 0:
            raise SystemExit(NOT_PORTED.format(
                what="--trainer graph on grid-connectivity graphs (knn_k 0)"))
        if cfg.model.sparse_kernel == "xla":
            raise SystemExit(NOT_PORTED.format(
                what="--trainer graph --sparse-kernel xla"))
        return _train_graph(args, cfg)
    if cfg.graph.knn_k > 0:
        raise SystemExit(NOT_PORTED.format(what="--trainer grid --knn-k > 0"))

    from ..training.grid_trainer import (GridTrainer, GroundTruthGridDataset,
                                         SyntheticGridDataset)

    if args.ground_truth_dir:
        files = [str(p_) for p_ in
                 sorted(Path(args.ground_truth_dir).glob("*.tif"))]
        if not files:
            raise SystemExit(f"no GT rasters in {args.ground_truth_dir}")
        n_val = (max(1, int(len(files) * args.val_split))
                 if len(files) > 1 else 0)
        train_ds = GroundTruthGridDataset(
            files[:-n_val] if n_val else files,
            tile_size=args.tile_size, overlap=args.overlap)
        val_ds = (GroundTruthGridDataset(files[-n_val:],
                                         tile_size=args.tile_size,
                                         overlap=args.overlap)
                  if n_val else None)
    elif args.data_dir:
        grids, _ = _load_surveys(args)
        train_ds = SyntheticGridDataset(grids, cfg, tile_size=args.tile_size,
                                        overlap=args.overlap,
                                        seed=cfg.training.seed)
        val_ds = None
    else:
        raise SystemExit("need --data-dir or --ground-truth-dir")
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg.save(out_dir / "config.yaml")
    trainer = GridTrainer(cfg, train_ds, val_ds, output_dir=str(out_dir),
                          device=args.device)
    return trainer.train(resume=args.resume)


def _load_surveys(args):
    """(depth grids with NaN at invalid cells, resolutions) of every
    survey under --data-dir; exits when none loads."""
    from ..io.loaders import BathymetricLoader

    loader = BathymetricLoader(args.vr_bag_mode)
    grids, resolutions = [], []
    for f in find_survey_files(args.data_dir):
        try:
            g = loader.load(f)
            grids.append(np.where(g.valid_mask, g.depth, np.nan))
            resolutions.append(g.resolution)
        except Exception:
            logger.exception("skipping %s", f)
    if not grids:
        raise SystemExit(f"no loadable surveys in {args.data_dir}")
    return grids, resolutions


def _train_graph(args, cfg):
    """The graph trainer on k-NN tile graphs (the JAX CLI's graph
    branch)."""
    from ..training.datasets import (GroundTruthTileDataset,
                                     SyntheticTileDataset)
    from ..training.trainer import Trainer

    if args.ground_truth_dir:
        files = [str(p) for p in
                 sorted(Path(args.ground_truth_dir).glob("*.tif"))]
        if not files:
            raise SystemExit(f"no GT rasters in {args.ground_truth_dir}")
        n_val = (max(1, int(len(files) * args.val_split))
                 if len(files) > 1 else 0)
        train_files = files[:-n_val] if n_val else files
        val_files = files[-n_val:] if n_val else None
        train_ds = GroundTruthTileDataset(
            train_files, cfg, tile_size=args.tile_size, overlap=args.overlap,
            seed=cfg.training.seed)
        val_ds = (GroundTruthTileDataset(val_files, cfg,
                                         tile_size=args.tile_size,
                                         overlap=args.overlap)
                  if val_files else None)
    elif args.data_dir:
        grids, resolutions = _load_surveys(args)
        train_ds = SyntheticTileDataset(
            grids, cfg, tile_size=args.tile_size, overlap=args.overlap,
            seed=cfg.training.seed, resolutions=resolutions)
        val_ds = None
    else:
        raise SystemExit("need --data-dir or --ground-truth-dir")
    logger.info("%d training tiles", len(train_ds))
    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    cfg.save(out_dir / "config.yaml")
    trainer = Trainer(cfg, train_ds, val_ds, output_dir=str(out_dir),
                      device=args.device)
    state = trainer.train(resume=args.resume)
    logger.info("training complete; best val %.4f",
                min(trainer.history["val_loss"])
                if trainer.history["val_loss"] else float("nan"))
    return state


if __name__ == "__main__":
    main()
