"""Dense-grid training: ``GridTrainer.train_step`` inside the trainer's
own epoch loop (``prefetch_iterator`` over ``_batches``, the loss and
accuracy read each step), without evaluation or checkpoints.

Set-up makes a clean survey from the seed, draws the noisy tiles once
from the port's ``SyntheticGridDataset`` and serves them from a cache
thereafter, as a caching dataset does after its first epoch; builds
kernels A and B; builds the trainer and its state with the seeded
weights; and drives that state through its first steps in the window's
own loop: the reference follows the first three, which also warm every
shape. The window continues the same loop (shuffled epochs of
``batch_size`` tiles, dropout on, a fixed learning rate) until its
length has passed, finishing the step it is in.

Traffic parameters: ``tiles_per_side``, ``tile_size``, ``overlap``,
``min_valid_ratio``, ``warm_steps``, ``limits``.
"""

from __future__ import annotations

import tempfile
import shutil
import time
import types
from typing import Dict, List

import numpy as np
import torch

from portbench import compare, harness, surface, weights
from portbench.roofline import model_flops
from portbench.reference import gat_grid8 as ref

CHECK_STEPS = 3


class CachedTiles:
    """The noisy tiles drawn once, served by index; it notes the indices
    the loop asks for, in order."""

    def __init__(self, samples: List[Dict]):
        self.samples = samples
        self.asked: List[int] = []

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        self.asked.append(int(i))
        return self.samples[i]

    def class_counts(self) -> np.ndarray:
        counts = np.zeros(3, np.int64)
        for s in self.samples:
            counts += np.bincount(s["labels"][s["valid"]], minlength=3)[:3]
        return counts


def _loop(s, spans: harness.Spans):
    """The trainer's epoch loop, one step per ``next``."""
    from bathymetric_gnn_tpu_torch.utils.prefetch import prefetch_iterator

    tr, bs = s.trainer, s.cfg["training"]["batch_size"]
    while True:
        it = prefetch_iterator(tr._batches(s.data, bs))
        while True:
            with spans.span("next_batch"):
                batch = next(it, None)
            if batch is None:
                break
            with spans.span("train_step"):
                losses, acc = tr.train_step(s.state, batch, s.lr)
            with spans.span("loss_read"):
                loss = float(losses["total"])
                float(acc)
            yield loss


def setup(cell, seed: int, device, spans: harness.Spans, overrides=None):
    from bathymetric_gnn_tpu_torch.training.grid_trainer import (
        GridTrainer, SyntheticGridDataset)
    from bathymetric_gnn_tpu_torch.training.trainer import \
        cosine_warm_restarts

    tr = dict(cell.traffic, **(overrides or {}))
    cfg = cell.config
    s = types.SimpleNamespace()
    s.cfg, s.tr, s.seed, s.device = cfg, tr, seed, torch.device(device)
    s.compile_s = 0.0
    if s.device.type == "cuda":
        from bathymetric_gnn_tpu_torch.ops.cuda import _build

        t0 = time.perf_counter()
        _build.library("grid_gat_fwd")
        _build.library("grid_gat_bwd")
        s.compile_s = time.perf_counter() - t0
    conf = harness.port_config(cfg, seed)
    ts, ov = tr["tile_size"], tr["overlap"]
    side = tr["tiles_per_side"] * (ts - ov) + ov
    clean = surface.synthetic_survey(side, side, seed, s.device,
                                     spikes=False)
    ds = SyntheticGridDataset([clean], conf, tile_size=ts, overlap=ov,
                              min_valid_ratio=tr["min_valid_ratio"],
                              seed=seed)
    s.data = CachedTiles([ds[i] for i in range(len(ds))])
    if len(s.data) < cfg["training"]["batch_size"]:
        raise ValueError(f"{len(s.data)} tiles make no batch of "
                         f"{cfg['training']['batch_size']}")
    s.out_dir = tempfile.mkdtemp(prefix="portbench-")
    s.trainer = GridTrainer(conf, s.data, output_dir=s.out_dir,
                            device=device)
    s.lr = cosine_warm_restarts(0, conf.training.learning_rate,
                                conf.training.cosine_t0,
                                conf.training.cosine_t_mult)
    s.state = s.trainer.init_state()
    s.data.asked.clear()    # init_state reads a sample for its shapes
    s.weights = weights.seeded_state_dict(cfg, seed, s.device)
    s.state.model.load_state_dict(s.weights)
    s.steps = _loop(s, spans)
    first_steps(s)
    for _ in range(tr["warm_steps"]):
        next(s.steps)
    if s.device.type == "cuda":
        torch.cuda.synchronize()
    return s


def first_steps(s):
    """Drive ``s.steps`` (the window's own loop) through the steps the
    reference follows, keeping what it compares: each step's loss, the
    first gradient as AdamW takes it (its first moment after one step,
    over 1 - b1) and the parameters' change after the last, and the
    tiles of each step."""
    named = list(s.state.model.named_parameters())
    s.leaves = [k for k, _ in named]
    p0 = {k: p.detach().clone() for k, p in named}
    s.losses = [next(s.steps)]
    b1 = s.state.optimizer.b1
    s.first_grads = {k: (mu / (1 - b1)).cpu().numpy()
                     for k, mu in zip(s.leaves, s.state.optimizer.mu)}
    s.losses += [next(s.steps) for _ in range(CHECK_STEPS - 1)]
    s.change = {k: (p.detach() - p0[k]).cpu().numpy() for k, p in named}
    bs = s.cfg["training"]["batch_size"]
    s.check_batches = [s.data.asked[i * bs:(i + 1) * bs]
                       for i in range(CHECK_STEPS)]


def window(s, seconds: float, spans: harness.Spans) -> Dict:
    bs = s.cfg["training"]["batch_size"]
    tile = s.tr["tile_size"]
    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        next(s.steps)
        n += 1
    window_s = time.perf_counter() - t0
    cells = n * bs * tile * tile
    calls = {}
    for dims in model_flops.gat_layer_dims(s.cfg, bs, tile, tile):
        key = compare.dims_key(dims)
        calls[key] = calls.get(key, 0) + n
    return {
        "window_s": window_s,
        "attempted": n, "failed": 0,
        "metrics": {"train_tiles_per_s": (n * bs / window_s, "tiles/s")},
        "counts": {"steps": n, "tiles": n * bs},
        "flops": model_flops.train_step_flops(s.cfg, cells),
        "kernel_calls": {"grid_gat.train": calls},
    }


def release(s):
    """Stop the loop and free the program's state before the reference
    runs."""
    s.steps.close()
    s.trainer = s.state = s.steps = None
    shutil.rmtree(s.out_dir, ignore_errors=True)
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def _reference(s, mode: str) -> Dict:
    params = {k: v for k, v in s.weights.items() if k in s.leaves}
    r = ref.TrainReference(params, s.leaves, s.cfg, s.data.class_counts(),
                           s.seed, s.device, mode)
    p0 = {k: v.detach().clone() for k, v in r.p.items()}
    for idx in s.check_batches:
        items = [s.data.samples[i] for i in idx]
        batch = {k: np.stack([it[k] for it in items]) for k in items[0]}
        r.step(batch, s.lr)
    return {"losses": r.losses,
            "grads": {k: g.cpu().numpy() for k, g in r.first_grads.items()},
            "change": {k: (r.p[k].detach() - p0[k]).cpu().numpy()
                       for k in s.leaves}}


def check(s, result) -> List[tuple]:
    prog = {"losses": s.losses, "grads": s.first_grads, "change": s.change}
    return compare.train_readings(prog, _reference(s, "float32"),
                                  s.tr["limits"])


def control(s) -> List[tuple]:
    return compare.train_readings(_reference(s, "tf32"),
                                  _reference(s, "float32"), s.tr["limits"])
