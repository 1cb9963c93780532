"""COO graph training, the training CLI's default route:
``Trainer.train_step`` inside the trainer's own loop
(``prefetch_iterator(_host_batches(...))``, so ``merge_stacked`` and
``CooGraph.from_padded`` with the source table run in the prefetch
thread; the batch moved to the card and the loss read each step), without
evaluation, calibration or checkpoints.

Set-up makes a clean survey from the seed, draws each tile's noise once
from the port's ``SyntheticTileDataset`` and builds its graph, and serves
those graphs from a cache thereafter, as a caching dataset does after its
first epoch; builds kernel F; builds the trainer and its state with the
seeded weights, and drives that state through its first steps in the
window's own loop (the reference follows the first three). The window
continues the loop until its length has passed.

Traffic parameters: ``tiles_per_side`` [rows, cols], ``tile_size``, ``overlap``,
``min_valid_ratio``, ``warm_steps``, ``limits``.
"""

from __future__ import annotations

import json
import shutil
import tempfile
import time
import types
from typing import Dict, List

import numpy as np
import torch

from portbench import compare, harness, surface, weights
from portbench.drivers.grid_train import first_steps
from portbench.reference import gat_coo as ref
from portbench.roofline import model_flops


class CachedGraphs:
    """The tile graphs built once, served by index; it notes the indices
    the loop asks for, in order, and keeps each tile's raw grids (the
    reference's inputs)."""

    def __init__(self, raws: List[Dict], samples: List):
        self.raws, self.samples = raws, samples
        self.asked: List[int] = []

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        self.asked.append(int(i))
        return self.samples[i]

    def class_counts(self) -> np.ndarray:
        counts = np.zeros(3, np.int64)
        for s in self.samples:
            counts += np.bincount(s.targets["labels"][:s.num_nodes],
                                  minlength=3)[:3]
        return counts

    def sample_normalized_corrections(self) -> np.ndarray:
        return np.concatenate([
            s.targets["correction"][:s.num_nodes][
                s.targets["noise_mask"][:s.num_nodes]]
            for s in self.samples])


def coo_names(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The grid model's parameter names -> the COO model's (its layers
    and norms nest under ``GNNBackbone_0``, the GAT layers as
    ``GATConv_i``)."""
    out = {}
    for k, v in sd.items():
        if k.startswith("GridGATConv_"):
            k = ref.PREFIX + k[len("Grid"):]
        elif k.startswith("MaskedBatchNorm_"):
            k = ref.PREFIX + k
        out[k] = v
    return out


def _loop(s, spans: harness.Spans):
    from bathymetric_gnn_tpu_torch.training.trainer import _to_device_targets
    from bathymetric_gnn_tpu_torch.utils.prefetch import prefetch_iterator

    tr, dev = s.trainer, s.device
    while True:
        it = prefetch_iterator(tr._host_batches(s.data, shuffle=True))
        while True:
            with spans.span("next_batch"):
                item = next(it, None)
            if item is None:
                break
            g, targets, edges, _nodes, _tiles, banded = item
            with spans.span("train_step"):
                losses, acc = tr.train_step(
                    s.state, g.to(dev), _to_device_targets(targets, dev),
                    s.lr, tr._device_banded(banded))
            with spans.span("loss_read"):
                loss = float(losses["total"])
                float(acc)
            yield loss


def setup(cell, seed: int, device, spans: harness.Spans, overrides=None):
    from bathymetric_gnn_tpu_torch.training.datasets import \
        SyntheticTileDataset
    from bathymetric_gnn_tpu_torch.training.trainer import (
        Trainer, cosine_warm_restarts)

    tr = dict(cell.traffic, **(overrides or {}))
    cfg = cell.config
    s = types.SimpleNamespace()
    s.cfg, s.tr, s.seed, s.device = cfg, tr, seed, torch.device(device)
    s.compile_s = 0.0
    if s.device.type == "cuda":
        from bathymetric_gnn_tpu_torch.ops.cuda import _build

        t0 = time.perf_counter()
        _build.library("segment_reduce")
        s.compile_s = time.perf_counter() - t0
    conf = harness.port_config(cfg, seed)
    ts, ov = tr["tile_size"], tr["overlap"]
    rows, cols = tr["tiles_per_side"]
    clean = surface.synthetic_survey(rows * (ts - ov) + ov,
                                     cols * (ts - ov) + ov, seed, s.device,
                                     spikes=False)
    ds = SyntheticTileDataset([clean], conf, tile_size=ts, overlap=ov,
                              min_valid_ratio=tr["min_valid_ratio"],
                              seed=seed)
    raws = [ds.raw_item(i) for i in range(len(ds))]
    s.data = CachedGraphs(raws, [ds.finalize(r) for r in raws])
    if len(s.data) < cfg["training"]["batch_size"]:
        raise ValueError(f"{len(s.data)} tiles make no batch of "
                         f"{cfg['training']['batch_size']}")
    s.out_dir = tempfile.mkdtemp(prefix="portbench-")
    s.trainer = Trainer(conf, s.data, output_dir=s.out_dir, device=device)
    s.lr = cosine_warm_restarts(0, conf.training.learning_rate,
                                conf.training.cosine_t0,
                                conf.training.cosine_t_mult)
    s.state = s.trainer.init_state(s.data.samples[0].graph)
    s.weights = coo_names(weights.seeded_state_dict(cfg, seed, s.device))
    s.state.model.load_state_dict(s.weights)
    s.steps = _loop(s, spans)
    first_steps(s)
    for _ in range(tr["warm_steps"]):
        next(s.steps)
    if s.device.type == "cuda":
        torch.cuda.synchronize()
    return s


def window(s, seconds: float, spans: harness.Spans) -> Dict:
    """The loop for ``seconds``; every launch of kernel F (mode a) is
    noted with its shape, for its roofline."""
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    bs = s.cfg["training"]["batch_size"]
    tile = s.tr["tile_size"]
    f_calls: Dict[str, int] = {}
    launch = sr.call_kernel

    def noted(ct, perm, row_ptr, n):
        key = json.dumps({"live": int(perm.numel()), "n": int(n),
                          "f": int(ct.shape[1])}, sort_keys=True)
        f_calls[key] = f_calls.get(key, 0) + 1
        return launch(ct, perm, row_ptr, n)

    n = 0
    sr.call_kernel = noted
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            next(s.steps)
            n += 1
        window_s = time.perf_counter() - t0
    finally:
        sr.call_kernel = launch
    cells = n * bs * tile * tile
    return {
        "window_s": window_s,
        "attempted": n, "failed": 0,
        "metrics": {"train_tiles_per_s": (n * bs / window_s, "tiles/s")},
        "counts": {"steps": n, "tiles": n * bs},
        "flops": model_flops.train_step_flops(s.cfg, cells),
        "kernel_calls": {"segment_reduce.sorted": f_calls},
    }


def release(s):
    """Stop the loop and free the program's state before the reference
    runs."""
    s.steps.close()
    s.trainer.close()
    s.trainer = s.state = s.steps = None
    shutil.rmtree(s.out_dir, ignore_errors=True)
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def _reference(s, mode: str) -> Dict:
    params = {k: v for k, v in s.weights.items() if k in s.leaves}
    r = ref.TrainReference(params, s.leaves, s.cfg, s.data.raws, s.seed,
                           s.device, mode)
    p0 = {k: v.detach().clone() for k, v in r.p.items()}
    for idx in s.check_batches:
        r.step(idx, s.lr)
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

