"""The graph trainer's ground-truth input pipeline against its worker count:

    python3 scripts/train_workers.py epochs [--size 1536] [--epochs 3]
        [--workers 0 4] [--data gt synthetic] [--device cpu] [--json PATH]
    python3 scripts/train_workers.py host [--size 768] [--reps 5]
        [--threads 0 4 2 1] [--json PATH]

Both write a clean / noisy pair of ``--size``^2 cells (the noisy copy
shifted by a few cells, 0.05 m deeper, with spikes) and its ground truth
(``data/ground_truth.compute_ground_truth``).

``epochs`` runs ``cli.train --trainer graph`` (the COO model at full width,
256^2 tiles, batches of 4) for ``--epochs`` epochs at each ``--workers``
count, on the GT raster (``--ground-truth-dir``: the dataset caches the
tiles it builds, and the ones the workers send back) and on the clean
survey with synthetic noise (``--data-dir``: every tile drawn anew). Each
epoch's seconds come from ``metrics.jsonl`` (the difference of its
cumulative ``elapsed_s``: the epoch's training loop and its eval; the
first also holds the trainer's set-up after its stats sample, and the
worker pool's start). Runs on the card unless ``--device cpu``.

``host`` times on the host clock, over the GT raster's 256^2 training
tiles (``GroundTruthTileDataset``, the training CLI's tile and overlap):

- ``raw_item`` (the windowed GeoTIFF read) and ``finalize`` (the
  grid-connectivity graph build and target gather) of one tile, at each
  ``--threads`` count of torch's CPU pool (0: torch's default);
- the trainer's per-batch host step on a batch of 4 such tiles
  (``collate_samples`` + ``Trainer.sparse_batch``: ``merge_stacked`` and
  ``CooGraph.from_padded`` with the source table);
- a ``ProcessSampleLoader`` of 1 and of 4 workers: the seconds to its
  first batch (the spawn and each worker's import of torch and the
  package) and to the end of one epoch over the tiles.

It touches no card, so it runs on any host; the numbers are the host's.
Each prints one JSON object (and writes it to ``--json``).
"""

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def make_pair(d: Path, n: int, seed: int = 0, shift=(3, 5)):
    from bathymetric_gnn_tpu_torch.io.geotiff import write_geotiff

    rg = np.random.default_rng(seed)
    dr, dc = shift
    yy, xx = np.mgrid[0:n + dr, 0:n + dc].astype(np.float32)
    surface = (30.0 + 0.002 * xx + 0.001 * yy + 0.5 * np.sin(xx / 37.0)
               + rg.normal(0, 0.02, xx.shape)).astype(np.float32)
    surface[rg.random(surface.shape) < 0.002] = np.nan
    clean = surface[:n, :n]
    noisy = surface[dr:, dc:] + np.float32(0.05)
    hit = rg.random(noisy.shape) < 0.01
    noisy[hit] += rg.uniform(-4, 4, hit.sum()).astype(np.float32)
    unc = rg.uniform(0.1, 0.4, noisy.shape).astype(np.float32)
    write_geotiff(d / "clean.tif", clean[None], pixel_scale=(1.0, 1.0),
                  origin=(2000.0, 6000.0), nodata=float("nan"))
    write_geotiff(d / "noisy.tif", np.stack([noisy, unc]),
                  pixel_scale=(1.0, 1.0), origin=(2000.0 + dc, 6000.0 - dr),
                  nodata=float("nan"))


def mean_s(fn, reps):
    fn()                                   # warm-up
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def host(args, out: dict) -> None:
    import torch

    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.data.ground_truth import (
        compute_ground_truth)
    from bathymetric_gnn_tpu_torch.training.datasets import (
        GroundTruthTileDataset, collate_samples)
    from bathymetric_gnn_tpu_torch.training.trainer import Trainer
    from bathymetric_gnn_tpu_torch.utils.mp_loader import ProcessSampleLoader

    out.update(torch_threads=torch.get_num_threads())
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        make_pair(d, args.size)
        gt = compute_ground_truth(d / "clean.tif", d / "noisy.tif",
                                  d / "gt")["output"]
        cfg = Config()
        ds = GroundTruthTileDataset([gt], cfg, tile_size=256, overlap=32)
        out["tiles"] = len(ds)
        raw = ds.raw_item(0)
        out["raw_item_s"] = mean_s(lambda: ds.raw_item(0), args.reps)
        default = torch.get_num_threads()
        out["finalize_s"] = {}
        for t in args.threads:
            torch.set_num_threads(t or default)
            out["finalize_s"][str(t or default)] = mean_s(
                lambda: ds.finalize(raw), args.reps)
        torch.set_num_threads(default)
        samples = [ds.finalize(ds.raw_item(i)) for i in range(4)]
        trainer = Trainer(cfg, ds, output_dir=str(d / "run"), device="cpu")
        out["batch_host_step_s"] = mean_s(
            lambda: trainer.sparse_batch(collate_samples(samples)[0]),
            args.reps)
        out["loader"] = {}
        for w in (1, 4):
            # a fresh dataset: the first loader fills the cache it reads
            fresh = GroundTruthTileDataset([gt], cfg, tile_size=256,
                                           overlap=32)
            t0 = time.perf_counter()
            first = None
            with ProcessSampleLoader(fresh, num_workers=w) as loader:
                for _ in loader.epoch_batches(4, np.random.default_rng(0)):
                    first = first or time.perf_counter() - t0
            out["loader"][str(w)] = {"first_batch_s": first,
                                     "epoch_s": time.perf_counter() - t0}


def epochs(args, out: dict) -> None:
    from bathymetric_gnn_tpu_torch.cli import train as tcli
    from bathymetric_gnn_tpu_torch.data.ground_truth import (
        compute_ground_truth)
    from bathymetric_gnn_tpu_torch.data.tiling import TileManager
    from bathymetric_gnn_tpu_torch.io.geotiff import read_geotiff
    from bathymetric_gnn_tpu_torch.training.datasets import (
        GroundTruthTileDataset)

    out.update(epochs=args.epochs, runs=[])
    with tempfile.TemporaryDirectory() as tmp:
        d = Path(tmp)
        make_pair(d, args.size)
        (d / "clean").mkdir()
        (d / "clean.tif").rename(d / "clean" / "clean.tif")
        compute_ground_truth(d / "clean" / "clean.tif", d / "noisy.tif",
                             d / "gt")
        gt_files = [str(f) for f in (d / "gt").glob("*.tif")]
        tiles_of = {
            "gt": len(GroundTruthTileDataset(gt_files, tile_size=256,
                                             overlap=32)),
            "synthetic": sum(1 for _ in TileManager(256, 32, 0.3)
                             .iterate_tiles(read_geotiff(
                                 d / "clean" / "clean.tif")[0][0]))}
        sources = {"gt": ["--ground-truth-dir", str(d / "gt")],
                   "synthetic": ["--data-dir", str(d / "clean")]}
        for kind in args.data:
            for w in args.workers:
                run = d / f"run_{kind}_{w}"
                argv = sources[kind] + [
                    "--trainer", "graph", "--output-dir", str(run),
                    "--epochs", str(args.epochs), "--num-workers", str(w),
                    "--seed", "0"]
                if args.device:
                    argv += ["--device", args.device]
                t0 = time.perf_counter()
                tcli.main(argv)
                wall = time.perf_counter() - t0
                rows = [json.loads(line) for line in
                        (run / "metrics.jsonl").read_text().splitlines()]
                elapsed = [r["elapsed_s"] for r in rows]
                epoch_s = [elapsed[0]] + [b - a for a, b in
                                          zip(elapsed, elapsed[1:])]
                tiles = tiles_of[kind] // 4 * 4
                out["runs"].append({
                    "data": kind, "workers": w, "wall_s": wall,
                    "epoch_s": epoch_s, "tiles_per_epoch": tiles,
                    "tiles_per_s": [tiles / s for s in epoch_s],
                    "train_loss": [r["train_loss"] for r in rows]})
                print(json.dumps(out["runs"][-1]), flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="mode", required=True)
    e = sub.add_parser("epochs")
    e.add_argument("--size", type=int, default=1536)
    e.add_argument("--epochs", type=int, default=3)
    e.add_argument("--workers", type=int, nargs="+", default=[0, 4])
    e.add_argument("--data", nargs="+", default=["gt", "synthetic"],
                   choices=["gt", "synthetic"])
    e.add_argument("--device")
    h = sub.add_parser("host")
    h.add_argument("--size", type=int, default=768)
    h.add_argument("--reps", type=int, default=5)
    h.add_argument("--threads", type=int, nargs="+", default=[0, 4, 2, 1])
    for q in (e, h):
        q.add_argument("--json")
    args = p.parse_args()
    out = {"mode": args.mode, "size": args.size,
           "usable_cpus": len(os.sched_getaffinity(0))}
    (host if args.mode == "host" else epochs)(args, out)
    print(json.dumps(out))
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
