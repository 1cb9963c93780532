"""Training on the dense-grid path (port of ``bathymetric_gnn_tpu/training/grid_trainer.py``).

The whole step runs on the device: featurization (``build_grid_inputs``),
the batched dense-grid model (kernels A and B on the card), the masked
losses, clipping and AdamW. The host only slices clean tiles and adds
noise (numpy, in a prefetch thread).

Checkpoints are port checkpoints (``utils/weights.save_checkpoint``:
``model.pt``, ``meta.json``, ``calibration.json``, ``config.yaml``) under
``best/``, ``last/`` and ``final/``, each with ``train_state.pt`` (the
optimizer's moments and count, and the step) for ``--resume``;
``cli/inference`` serves any of them.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.config import Config
from ..config.constants import (CLASS_NOISE, CORRECTION_NORM_CAP,
                                CORRECTION_NORM_FLOOR)
from ..data.graph_build import build_grid_inputs
from ..data.synthetic_noise import NoiseAugmentor, SyntheticNoiseGenerator
from ..data.tiling import TileManager
from ..inference.pipeline import resolve_device
from ..models.grid_batched import BatchedGridGNN
from ..utils import prof
from ..utils.prefetch import prefetch_iterator
from ..utils.weights import load_state_dict, save_checkpoint
from . import losses as L
from .optim import AdamW, clip_by_global_norm_
from .trainer import (PlateauScheduler, TrainState, cosine_warm_restarts,
                      make_dropout_key)

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class SyntheticGridDataset:
    """Clean tiles + synthetic noise, yielding raw grids (no graphs)."""

    def __init__(
        self,
        clean_grids: Sequence[np.ndarray],
        config: Optional[Config] = None,
        tile_size: int = 256,
        overlap: int = 32,
        min_valid_ratio: float = 0.3,
        seed: int = 0,
    ):
        self.config = config or Config()
        self.tm = TileManager(tile_size, overlap, min_valid_ratio)
        self.tile_size = tile_size
        gen = SyntheticNoiseGenerator(self.config.synthetic_noise, seed=seed)
        self.augmentor = NoiseAugmentor(gen, seed=seed + 1)
        self.tiles: List[np.ndarray] = []
        for grid in clean_grids:
            for t in self.tm.iterate_tiles(np.asarray(grid, np.float32)):
                if t.shape == (tile_size, tile_size):
                    self.tiles.append(t.data.copy())
        logger.info("SyntheticGridDataset: %d tiles", len(self.tiles))

    def __len__(self):
        return len(self.tiles)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        clean = self.tiles[idx]
        valid = np.isfinite(clean)
        lbl = self.augmentor(clean, valid)
        return {
            "noisy": np.nan_to_num(lbl.noisy_depth).astype(np.float32),
            "valid": valid,
            "labels": lbl.classification.astype(np.int32),
            "raw_correction": (lbl.noisy_depth - lbl.clean_depth
                               ).astype(np.float32),
        }

    def class_counts(self, sample_limit: int = 50) -> np.ndarray:
        rg = np.random.default_rng(0)
        counts = np.zeros(3, np.int64)
        for i in rg.choice(len(self), min(sample_limit, len(self)), False):
            s = self[int(i)]
            counts += np.bincount(s["labels"][s["valid"]], minlength=3)[:3]
        return counts


class GroundTruthGridDataset:
    """5-band GT rasters -> raw training grids (labels/diff/noisy/unc)."""

    def __init__(self, gt_files: Sequence[str], tile_size: int = 256,
                 overlap: int = 32, min_valid_ratio: float = 0.1):
        from ..io.loaders import read_raster_bands

        self.tm = TileManager(tile_size, overlap, min_valid_ratio)
        self.tile_size = tile_size
        self._read = read_raster_bands
        self.index: List[Tuple[str, object]] = []
        for path in gt_files:
            bands, _ = self._read(path, bands=[1])
            labels = bands[0]
            _, _, specs = self.tm.compute_tile_grid(labels.shape)
            for spec in specs:
                if spec.shape != (tile_size, tile_size):
                    continue
                sl = np.s_[spec.row_start:spec.row_end,
                           spec.col_start:spec.col_end]
                if (labels[sl] >= 0).mean() >= self.tm.min_valid_ratio:
                    self.index.append((path, spec))
        logger.info("GroundTruthGridDataset: %d tiles", len(self.index))

    def __len__(self):
        return len(self.index)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        path, spec = self.index[idx]
        bands, _ = self._read(path)
        sl = np.s_[spec.row_start:spec.row_end, spec.col_start:spec.col_end]
        labels = bands[0][sl]
        valid = labels >= 0
        return {
            "noisy": np.nan_to_num(bands[2][sl]).astype(np.float32),
            "valid": valid,
            "labels": np.maximum(labels, 0).astype(np.int32),
            "raw_correction": np.nan_to_num(bands[1][sl]).astype(np.float32),
        }

    def class_counts(self, sample_limit: int = 50) -> np.ndarray:
        counts = np.zeros(3, np.int64)
        for i in range(min(sample_limit, len(self))):
            s = self[i]
            counts += np.bincount(s["labels"][s["valid"]], minlength=3)[:3]
        return counts


def collate_grids(samples: Sequence[Dict[str, np.ndarray]]
                  ) -> Dict[str, np.ndarray]:
    return {k: np.stack([s[k] for s in samples]) for k in samples[0]}


class GridTrainer:
    """Trainer over the batched dense-grid model.

    ``device=None`` trains on the card and raises without one; the CPU
    runs only when asked for (``device="cpu"``), on the kernels' plain
    versions. Like the inference pipeline it turns TF32 off: the JAX
    reference computes in true f32."""

    def __init__(
        self,
        config: Config,
        train_dataset,
        val_dataset=None,
        output_dir: str = "checkpoints_grid",
        resolution: Tuple[float, float] = (1.0, 1.0),
        device=None,
    ):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        mc = config.model
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        self.resolution = (float(resolution[0]), float(resolution[1]))
        tc = config.training
        if tc.num_workers > 0:
            # as JAX's grid trainer: its tiles load in the prefetch thread
            logger.info("--trainer grid: training.num_workers=%d is ignored "
                        "(the grid trainer loads in a prefetch thread)",
                        tc.num_workers)
        self.rng = np.random.default_rng(tc.seed)
        self.dropout_rng = make_dropout_key(tc.seed, self.device)

        if getattr(tc, "class_weights", None) is not None:
            if len(tc.class_weights) != mc.num_classes:
                raise ValueError(
                    f"training.class_weights has {len(tc.class_weights)}"
                    f" entries but model.num_classes is {mc.num_classes}")
            cw = np.asarray(tc.class_weights, np.float32)
        else:
            try:
                cw = L.compute_class_weights(train_dataset.class_counts())
            except Exception:
                logger.exception("class-count estimation failed")
                cw = np.ones(mc.num_classes, np.float32)
        self.class_weights = torch.as_tensor(cw, device=self.device)
        self.huber_delta = 1.0
        self.plateau = PlateauScheduler(tc.learning_rate)
        self.history: Dict[str, list] = {"train_loss": [], "val_loss": [],
                                         "train_acc": [], "val_acc": [],
                                         "lr": []}

    # -- steps -------------------------------------------------------------

    def prepare(self, noisy: np.ndarray, valid: np.ndarray):
        """[B, H, W] host grids -> the model's inputs and local_std on the
        device (on-device featurization)."""
        d = torch.from_numpy(np.ascontiguousarray(noisy, np.float32))
        v = torch.from_numpy(np.ascontiguousarray(valid))
        return build_grid_inputs(d.to(self.device), v.to(self.device),
                                 resolution=self.resolution,
                                 connectivity=self.config.graph.connectivity)

    def loss_fn(self, model, batch, train: bool):
        """Forward + the 5-component loss of one batch; returns (losses,
        accuracy over valid cells)."""
        tc = self.config.training
        dev = self.device
        feats, v, nbr, eattr, local_std = self.prepare(batch["noisy"],
                                                       batch["valid"])
        model.train(train)
        out = model(feats, v, nbr, eattr,
                    dropout_rng=self.dropout_rng if train else None)
        # normalized correction targets on the device
        raw = torch.from_numpy(batch["raw_correction"]).to(dev)
        corr_t = torch.clamp(raw / local_std.clamp_min(CORRECTION_NORM_FLOOR),
                             -CORRECTION_NORM_CAP, CORRECTION_NORM_CAP)
        outputs = {k: (t.reshape(-1, t.shape[-1])
                       if k in ("class_logits", "class_probs")
                       else t.reshape(-1)) for k, t in out.items()}
        labels = torch.from_numpy(batch["labels"]).to(dev).reshape(-1).long()
        targets = {"labels": labels, "correction": corr_t.reshape(-1),
                   "noise_mask": labels == CLASS_NOISE}
        node_mask = v.reshape(-1)
        losses = L.combined_loss(
            outputs, targets, node_mask,
            class_weights=self.class_weights,
            classification_weight=tc.classification_weight,
            correction_weight=tc.correction_weight,
            confidence_weight=tc.confidence_weight,
            feature_preservation_weight=tc.feature_preservation_weight,
            shoal_safety_weight=tc.shoal_safety_weight,
            label_smoothing=tc.label_smoothing,
            correction_delta=self.huber_delta,
        )
        m = node_mask.to(torch.float32)
        acc = torch.sum((outputs["predicted_class"] == labels) * m
                        ) / m.sum().clamp_min(1.0)
        return losses, acc

    def train_step(self, state: TrainState, batch, lr: float):
        """One step: forward, backward (kernel B on the card), clip, AdamW.
        Returns (losses, accuracy) as device tensors. Spans
        (``utils/prof``): ``train.step`` around ``train.forward``,
        ``train.backward`` and ``train.optimizer``."""
        with prof.TRACER.root("train.step",
                            {"tiles": int(batch["noisy"].shape[0])}):
            model = state.model
            params = list(model.parameters())
            for p in params:
                p.grad = None
            with prof.TRACER.span("train.forward"):
                losses, acc = self.loss_fn(model, batch, train=True)
            with prof.TRACER.span("train.backward"):
                losses["total"].backward()
            with prof.TRACER.span("train.optimizer"):
                grads = [p.grad if p.grad is not None
                         else torch.zeros_like(p) for p in params]
                clip_by_global_norm_(grads,
                                     self.config.training.grad_clip_norm)
                state.optimizer.step(grads, lr)
            state.step += 1
            return {k: t.detach() for k, t in losses.items()}, acc.detach()

    @torch.no_grad()
    def eval_step(self, state: TrainState, batch):
        return self.loss_fn(state.model, batch, train=False)

    def init_state(self) -> TrainState:
        sample = collate_grids([self.train_dataset[0]])
        feats = self.prepare(sample["noisy"], sample["valid"])[0]
        mc = self.config.model
        tc = self.config.training
        model = BatchedGridGNN(
            feats.shape[-1], hidden_channels=mc.hidden_channels,
            num_layers=mc.num_layers, heads=mc.heads,
            num_classes=mc.num_classes, dropout=mc.dropout,
            predict_correction=mc.predict_correction,
            feature_extractor_layers=mc.feature_extractor_layers,
            edge_dim=3, connectivity=self.config.graph.connectivity,
            compute_dtype=_DTYPES[mc.compute_dtype],
            generator=torch.Generator().manual_seed(tc.seed),
        ).to(self.device)
        n = sum(p.numel() for p in model.parameters())
        logger.info("grid model initialized: %d params", n)
        return TrainState(model, AdamW(model.parameters(), tc.weight_decay),
                          0)

    # -- loop --------------------------------------------------------------

    def _batches(self, dataset, batch_size, shuffle=True):
        """The epoch's batches, each read and stacked under the span
        ``train.collate`` (``utils/prof``)."""
        order = np.arange(len(dataset))
        if shuffle:
            self.rng.shuffle(order)
        for s in range(0, len(order) - batch_size + 1, batch_size):
            with prof.TRACER.span("train.collate", {"tiles": batch_size}):
                batch = collate_grids([dataset[int(i)]
                                       for i in order[s:s + batch_size]])
            yield batch

    def train(self, resume: bool = False) -> TrainState:
        tc = self.config.training
        state = self.init_state()
        start_epoch, best_val, patience = 0, float("inf"), 0
        if resume:
            loaded = self.load_checkpoint(self.output_dir / "last", state)
            if loaded is not None:
                state, start_epoch, best_val = loaded

        epoch = start_epoch
        for epoch in range(start_epoch, tc.epochs):
            t0 = time.time()
            if tc.scheduler == "cosine_warm_restarts":
                lr = cosine_warm_restarts(epoch, tc.learning_rate,
                                          tc.cosine_t0, tc.cosine_t_mult)
            elif tc.scheduler == "plateau":
                lr = self.plateau.lr
            else:
                lr = tc.learning_rate
            tl = ta = 0.0
            nb = 0
            for batch in prefetch_iterator(
                    self._batches(self.train_dataset, tc.batch_size)):
                losses, acc = self.train_step(state, batch, lr)
                tl += float(losses["total"])
                ta += float(acc)
                nb += 1
            tl /= max(nb, 1)
            ta /= max(nb, 1)
            vl, va = self.evaluate(state)
            for k, v_ in (("train_loss", tl), ("val_loss", vl),
                          ("train_acc", ta), ("val_acc", va), ("lr", lr)):
                self.history[k].append(v_)
            logger.info("epoch %d: train %.4f/%.3f val %.4f/%.3f (%.1fs)",
                        epoch, tl, ta, vl, va, time.time() - t0)
            if tc.scheduler == "plateau":
                self.plateau.step(vl)
            if vl < best_val - tc.early_stop_min_delta:
                best_val = vl
                patience = 0
                self.save_checkpoint(state, epoch, best_val, "best")
            else:
                patience += 1
            self.save_checkpoint(state, epoch, best_val, "last")
            if patience >= tc.early_stop_patience:
                break
        self.save_checkpoint(state, epoch, best_val, "final")
        with open(self.output_dir / "history.json", "w") as f:
            json.dump(self.history, f)
        return state

    def evaluate(self, state) -> Tuple[float, float]:
        ds = self.val_dataset or self.train_dataset
        tot = acc = 0.0
        nb = 0
        for batch in self._batches(ds, self.config.training.batch_size,
                                   shuffle=False):
            losses, a = self.eval_step(state, batch)
            tot += float(losses["total"])
            acc += float(a)
            nb += 1
        return tot / max(nb, 1), acc / max(nb, 1)

    # -- checkpointing -----------------------------------------------------

    def save_checkpoint(self, state: TrainState, epoch, best_val, name):
        meta = {
            "epoch": epoch, "best_val": best_val, "param_layout": "grid",
            "correction_norm_floor": CORRECTION_NORM_FLOOR,
            "correction_norm_cap": CORRECTION_NORM_CAP,
            "class_weights": self.class_weights.cpu().numpy(),
            "huber_delta": self.huber_delta,
        }
        d = save_checkpoint(self.output_dir / name, state.model.state_dict(),
                            self.config, meta)
        torch.save({"optimizer": state.optimizer.state_dict(),
                    "step": state.step}, d / "train_state.pt")
        self.config.save(self.output_dir / "config.yaml")

    def load_checkpoint(self, path, state: TrainState):
        path = Path(path)
        if not (path / "model.pt").exists():
            return None
        sd, meta = load_state_dict(path)
        state.model.load_state_dict(sd)
        ts = torch.load(path / "train_state.pt", map_location="cpu",
                        weights_only=True)
        state.optimizer.load_state_dict(ts["optimizer"])
        state.step = int(ts["step"])
        return state, int(meta["epoch"]) + 1, float(meta["best_val"])
