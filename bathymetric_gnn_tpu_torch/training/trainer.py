"""Training loop on k-NN graphs (port of ``bathymetric_gnn_tpu/training/trainer.py``):
the per-epoch learning-rate schedules, the train state and the dropout
generator that the grid trainer shares, and the graph ``Trainer`` on its
k-NN path (``knn_k > 0``, GAT: the JAX trainer's ``banded_pallas`` route,
or its ``banded`` route).

Each batch of k-NN tile graphs is merged on the host (``merge_stacked``),
packed into the ELL layout with its source-sorted slot tables
(``coo_to_ell``, ``src_sorted_slots``), and on the ``"banded"`` route
split into 128-row bands (``ops/ell_banded.band_ell``, as the JAX trainer
does), in a prefetch thread, and moved to the device once. On the card
every GAT layer of a train step runs kernel C's dropout form forward and
kernel C' (with kernel F's source-side reduction) backward; on the
``"banded"`` route (dropout 0: the JAX layer refuses attention dropout
there) the JAX XLA route's band part and spill pass, differentiated by
autograd, as JAX differentiates them. The losses, clipping and AdamW
follow the JAX trainer. After training, the confidence head is
Platt-calibrated through the ELL model and ``calibration.json`` is written
beside every checkpoint.

Checkpoints are port checkpoints (``utils/weights.save_checkpoint``, the
weights grid-named, ``meta["param_layout"] = "coo"``) under ``best/``,
``last/``, ``final/`` (and ``epoch_N/`` every ``checkpoint_every``
epochs), each with ``train_state.pt`` for ``--resume``;
``cli/inference_native --knn-k K`` serves them. Not ported: the COO graph
trainer (``knn_k == 0`` or ``sparse_kernel="xla"``, ROADMAP queue 1 item
11) and the worker-process loader (``num_workers > 0`` loads in a
prefetch thread). With dropout the ``"banded"`` route raises the JAX
layer's own refusal when the trainer is built (JAX raises it at the first
step).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

COO_TRAINER_NOT_PORTED = (
    "the COO graph trainer (graph.knn_k == 0 or sparse_kernel='xla') is not "
    "ported to the PyTorch port yet (ROADMAP.md queue 1 item 11); train on "
    "k-NN graphs (--knn-k 8) or use --trainer grid")


def cosine_warm_restarts(epoch: int, base_lr: float, t0: int = 10,
                         t_mult: int = 2, eta_min: float = 0.0) -> float:
    """torch CosineAnnealingWarmRestarts schedule, stepped per epoch."""
    t_i, t_cur = t0, epoch
    while t_cur >= t_i:
        t_cur -= t_i
        t_i *= t_mult
    return eta_min + (base_lr - eta_min) * 0.5 * (
        1 + math.cos(math.pi * t_cur / t_i)
    )


def make_dropout_key(seed: int, device=None) -> torch.Generator:
    """The training dropout generator: a ``torch.Generator`` on ``device``
    (the model's), seeded with ``seed``. It replaces the JAX trainer's
    dropout PRNG key; the two give different draws from one seed."""
    return torch.Generator(device=device or "cpu").manual_seed(int(seed))


class PlateauScheduler:
    """ReduceLROnPlateau semantics (factor 0.5, patience 5)."""

    def __init__(self, base_lr: float, factor: float = 0.5, patience: int = 5,
                 min_lr: float = 1e-6):
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.min_lr = min_lr
        self.best = float("inf")
        self.bad = 0

    def step(self, val_loss: float) -> float:
        if val_loss < self.best - 1e-8:
            self.best = val_loss
            self.bad = 0
        else:
            self.bad += 1
            if self.bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.bad = 0
        return self.lr


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BatchNorm statistics), its optimizer and
    the number of steps taken."""

    model: Any
    optimizer: Any
    step: int = 0


def _to_device_targets(targets: Dict[str, np.ndarray], device
                       ) -> Dict[str, torch.Tensor]:
    """Stacked [B, N_pad] targets -> flat [B * N_pad] tensors on
    ``device`` (labels as int64)."""
    out = {k: torch.from_numpy(np.ascontiguousarray(v).reshape(-1)).to(device)
           for k, v in targets.items()}
    out["labels"] = out["labels"].long()
    return out


class Trainer:
    """The graph trainer on k-NN tile graphs (``config.graph.knn_k > 0``,
    GAT). The ELL model (``models/gnn_ell.EllBathymetricGNN``) is built by
    ``init_state`` from the first sample's feature widths.

    ``device=None`` trains on the card and raises without one; the CPU
    runs only when asked for (``device="cpu"``), on the kernels' plain
    versions. Like the other entry points it turns TF32 off: the JAX
    reference computes in true f32."""

    def __init__(self, config, train_dataset, val_dataset=None,
                 output_dir: str = "checkpoints", device=None):
        from ..inference.pipeline import resolve_device
        from ..utils.prof import MetricsLogger, ThroughputMeter

        mc = config.model
        self.knn_k = int(config.graph.knn_k)
        sk = mc.sparse_kernel
        if sk == "auto":
            # the kernel route on any device, as the k-NN serving path
            sk = "banded_pallas"
        if self.knn_k <= 0 or sk == "xla":
            raise NotImplementedError(COO_TRAINER_NOT_PORTED)
        if sk == "banded" and mc.dropout > 0:
            # the JAX trainer runs this route with use_pallas=False, whose
            # layer refuses attention dropout
            from ..models.conv_ell import BANDED_DROPOUT_NEEDS_FUSED

            raise NotImplementedError(BANDED_DROPOUT_NEEDS_FUSED)
        if mc.gnn_type != "GAT":
            raise NotImplementedError(
                f"gnn_type {mc.gnn_type!r} on k-NN graphs: only GAT is "
                "ported (ROADMAP.md queue 1 item 11)")
        self.sparse_kernel = sk
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.output_dir = Path(output_dir)
        self.output_dir.mkdir(parents=True, exist_ok=True)
        tc = config.training
        if getattr(tc, "num_workers", 0) > 0:
            logger.info("num_workers=%d: the port loads batches in a "
                        "prefetch thread (worker processes are not "
                        "ported)", tc.num_workers)
        self.rng = np.random.default_rng(tc.seed)
        self.dropout_rng = make_dropout_key(tc.seed, self.device)
        cw, self.huber_delta = self._compute_training_stats()
        self.class_weights = torch.as_tensor(cw, dtype=torch.float32,
                                             device=self.device)
        self.plateau = PlateauScheduler(tc.learning_rate)
        self.history: Dict[str, list] = {
            "train_loss": [], "val_loss": [], "train_acc": [], "val_acc": [],
            "lr": [],
        }
        self.metrics = MetricsLogger(self.output_dir / "metrics.jsonl")
        self.meter = ThroughputMeter()

    # -- setup -------------------------------------------------------------

    def _compute_training_stats(self) -> Tuple[np.ndarray, float]:
        """Class weights and the Huber delta from the training data, as
        the JAX trainer estimates them; the defaults (ones, 1.0) when the
        estimate fails."""
        from . import losses as L

        tc = self.config.training
        nc = self.config.model.num_classes
        if getattr(tc, "class_weights", None) is not None:
            if len(tc.class_weights) != nc:
                raise ValueError(
                    f"training.class_weights has {len(tc.class_weights)} "
                    f"entries but model.num_classes is {nc}")
        try:
            counts = self.train_dataset.class_counts()
            if getattr(tc, "class_weights", None) is not None:
                cw = np.asarray(tc.class_weights, np.float32)
            else:
                cw = L.compute_class_weights(np.asarray(counts))
            corr = self.train_dataset.sample_normalized_corrections()
            delta = L.compute_correction_delta(np.asarray(corr))
            logger.info("class counts %s -> weights %s; huber delta %.3f",
                        counts, cw, delta)
            return np.asarray(cw, np.float32), float(delta)
        except Exception:
            logger.exception("training-stats estimation failed; using "
                             "defaults")
            return np.ones(nc, np.float32), 1.0

    def sparse_batch(self, stacked_graph):
        """Stacked [B, ...] batch -> its merged ELL graph with the
        source-sorted slot tables, on the host (NumPy)."""
        from ..ops.ell import coo_to_ell
        from ..ops.graph import merge_stacked

        merged = merge_stacked(stacked_graph)
        return coo_to_ell(merged, max_degree=self.knn_k
                          ).with_src_sorted_slots()

    def banded_batch(self, g):
        """The band/spill decomposition of a merged ELL graph (NumPy) on
        the ``"banded"`` route, as the JAX trainer's ``_sparse_batch``
        builds it (128-row bands: merged graphs keep each sample's node
        bucket, a multiple of 128, so bands never span samples); None on
        the kernel route, whose layers need none."""
        if self.sparse_kernel != "banded":
            return None
        from ..ops.ell_banded import band_ell

        return band_ell(g, band_rows=128)

    def _host_batches(self, dataset, shuffle: bool):
        """(ELL graph, stacked targets, live edges, live nodes, tiles,
        BandedEll or None) per batch, all built on the host."""
        from .datasets import epoch_batches

        rng = self.rng if shuffle else np.random.default_rng(0)
        for graph, targets in epoch_batches(
                dataset, self.config.training.batch_size, rng,
                shuffle=shuffle):
            g = self.sparse_batch(graph)
            yield (g, targets,
                   int(np.asarray(graph.edge_mask).sum()),
                   int(np.asarray(graph.node_mask).sum()),
                   int(graph.node_mask.shape[0]), self.banded_batch(g))

    def _device_banded(self, banded):
        return None if banded is None else banded.to(self.device)

    def init_state(self, sample_graph) -> TrainState:
        """A new model (random weights from ``training.seed``) and its
        AdamW state, for graphs shaped like ``sample_graph`` (a
        PaddedGraph)."""
        from ..models.gnn_ell import make_ell_model
        from .optim import AdamW

        tc = self.config.training
        model = make_ell_model(
            self.config.model, int(np.asarray(sample_graph.x).shape[-1]),
            edge_dim=int(np.asarray(sample_graph.edge_attr).shape[-1]),
            sparse_kernel=self.sparse_kernel,
            dropout=self.config.model.dropout,
            generator=torch.Generator().manual_seed(tc.seed)
        ).to(self.device)
        logger.info("ELL model initialized (k-NN path, %s): %d parameters",
                    self.sparse_kernel,
                    sum(p.numel() for p in model.parameters()))
        return TrainState(model, AdamW(model.parameters(), tc.weight_decay),
                          0)

    # -- steps -------------------------------------------------------------

    def loss_fn(self, model, g, targets: Dict[str, torch.Tensor],
                train: bool, banded=None):
        """Forward + the 5-component loss of one merged batch (``g`` an
        ELL graph on the device, ``banded`` its BandedEll on the device on
        the ``"banded"`` route); returns (losses, accuracy over live
        nodes)."""
        from . import losses as L

        tc = self.config.training
        model.train(train)
        out = model(g, self.dropout_rng if train else None, banded=banded)
        node_mask = g.node_mask.to(torch.bool)
        terms = L.combined_loss_terms(
            out, targets, node_mask, class_weights=self.class_weights,
            label_smoothing=tc.label_smoothing,
            correction_delta=self.huber_delta)
        losses = L.finalize_loss_terms(
            terms, classification_weight=tc.classification_weight,
            correction_weight=tc.correction_weight,
            confidence_weight=tc.confidence_weight,
            feature_preservation_weight=tc.feature_preservation_weight,
            shoal_safety_weight=tc.shoal_safety_weight)
        m = node_mask.to(torch.float32)
        acc = torch.sum((out["predicted_class"] == targets["labels"]) * m
                        ) / m.sum().clamp_min(1.0)
        return losses, acc

    def train_step(self, state: TrainState, g, targets, lr: float,
                   banded=None):
        """One step: forward (kernel C's dropout form on the card),
        backward (kernels C' and F), clip, AdamW. ``g``/``targets`` (and
        ``banded`` on the ``"banded"`` route) on the device. Returns
        (losses, accuracy) as device tensors."""
        from .optim import clip_by_global_norm_

        model = state.model
        params = list(model.parameters())
        for p in params:
            p.grad = None
        losses, acc = self.loss_fn(model, g, targets, train=True,
                                   banded=banded)
        losses["total"].backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        clip_by_global_norm_(grads, self.config.training.grad_clip_norm)
        state.optimizer.step(grads, lr)
        state.step += 1
        return {k: t.detach() for k, t in losses.items()}, acc.detach()

    @torch.no_grad()
    def eval_step(self, state: TrainState, g, targets, banded=None):
        return self.loss_fn(state.model, g, targets, train=False,
                            banded=banded)

    # -- loop --------------------------------------------------------------

    def train(self, resume: bool = False) -> TrainState:
        from ..utils.prefetch import prefetch_iterator

        tc = self.config.training
        state = self.init_state(self.train_dataset[0].graph)
        start_epoch, best_val, patience = 0, float("inf"), 0
        if resume:
            loaded = self.load_checkpoint(self.output_dir / "last", state)
            if loaded is not None:
                state, start_epoch, best_val = loaded
                logger.info("resumed from epoch %d (best val %.4f)",
                            start_epoch, best_val)

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
            for g, targets, edges, nodes, tiles, banded in prefetch_iterator(
                    self._host_batches(self.train_dataset, shuffle=True)):
                losses, acc = self.train_step(
                    state, g.to(self.device),
                    _to_device_targets(targets, self.device), lr,
                    self._device_banded(banded))
                self.meter.add(edges=edges, nodes=nodes, tiles=tiles)
                tl += float(losses["total"])
                ta += float(acc)
                nb += 1
            tl /= max(nb, 1)
            ta /= max(nb, 1)

            vl, va = self.evaluate(state)
            for k, v_ in (("train_loss", tl), ("val_loss", vl),
                          ("train_acc", ta), ("val_acc", va), ("lr", lr)):
                self.history[k].append(v_)
            logger.info("epoch %d: train %.4f/%.3f val %.4f/%.3f lr %.2e "
                        "(%.1fs)", epoch, tl, ta, vl, va, lr,
                        time.time() - t0)
            self.metrics.log(epoch, {
                "train_loss": tl, "val_loss": vl, "train_acc": ta,
                "val_acc": va, "lr": lr, **self.meter.rates()})
            if tc.scheduler == "plateau":
                self.plateau.step(vl)
            if vl < best_val - tc.early_stop_min_delta:
                best_val = vl
                patience = 0
                self.save_checkpoint(state, epoch, best_val, "best")
            else:
                patience += 1
            self.save_checkpoint(state, epoch, best_val, "last")
            if (epoch + 1) % tc.checkpoint_every == 0:
                self.save_checkpoint(state, epoch, best_val,
                                     f"epoch_{epoch + 1}")
            if patience >= tc.early_stop_patience:
                logger.info("early stopping at epoch %d", epoch)
                break

        self.save_checkpoint(state, epoch, best_val, "final")
        with open(self.output_dir / "history.json", "w") as f:
            json.dump(self.history, f)
        self.calibrate_confidence(state)
        return state

    def evaluate(self, state: TrainState) -> Tuple[float, float]:
        """Masked loss and accuracy over the validation set, or over the
        training set (with a warning) when there is none."""
        if self.val_dataset is None:
            logger.warning("Trainer.evaluate: no val_dataset; evaluating on "
                           "the TRAIN set (early stopping tracks train loss)")
        ds = self.val_dataset if self.val_dataset is not None \
            else self.train_dataset
        tot = acc = 0.0
        nb = 0
        for g, targets, *_, banded in self._host_batches(ds, shuffle=False):
            losses, a = self.eval_step(
                state, g.to(self.device),
                _to_device_targets(targets, self.device),
                self._device_banded(banded))
            tot += float(losses["total"])
            acc += float(a)
            nb += 1
        return tot / max(nb, 1), acc / max(nb, 1)

    # -- confidence calibration --------------------------------------------

    @staticmethod
    def fit_platt(z: np.ndarray, y: np.ndarray,
                  sw: Optional[np.ndarray] = None,
                  lam: float = 1e-3) -> Tuple[float, float]:
        """Ridge-regularized Newton fit of sigmoid(a * z + b) to y in
        {0, 1}, optionally sample-weighted by ``sw`` (normalized to mean 1).
        The ridge keeps separable subsets finite; the clamps keep the map
        monotone (a > 0)."""
        if sw is None:
            sw = np.ones_like(z)
        sw = sw / max(float(sw.mean()), 1e-12)
        a_f, b_f = 1.0, 0.0
        for _ in range(60):
            u = a_f * z + b_f
            p = 1.0 / (1.0 + np.exp(-u))
            g = sw * (p - y)
            w = np.maximum(sw * p * (1.0 - p), 1e-12)
            ga = float(np.mean(g * z)) + lam * (a_f - 1.0)
            gb = float(np.mean(g)) + lam * b_f
            haa = float(np.mean(w * z * z)) + lam
            hbb = float(np.mean(w)) + lam
            hab = float(np.mean(w * z))
            det = haa * hbb - hab * hab
            if det <= 1e-12:
                break
            da = (hbb * ga - hab * gb) / det
            db = (haa * gb - hab * ga) / det
            a_f = float(np.clip(a_f - da, 1e-2, 60.0))
            b_f = float(np.clip(b_f - db, -12.0, 12.0))
            if abs(da) < 1e-8 and abs(db) < 1e-8:
                break
        return a_f, b_f

    def calibrate_confidence(self, state: TrainState) -> float:
        """Platt scaling of the confidence head after training: fits
        conf' = sigmoid(a * logit(conf) + b) (a > 0, so the ranking is
        kept) on the validation split's predicted-noise cells (all cells
        when fewer than 200), against the benefit of applying the
        predicted correction (|error| shrinks, weighted by the change of
        squared error), or against label agreement when the targets carry
        no correction. The forward runs the ELL model in eval mode (the
        JAX k-NN trainer runs its COO model here, which cannot take the
        banded graph, so it never writes the file). Writes
        calibration.json into the run directory and beside every
        checkpoint; inference applies (a, b). Returns a."""
        from ..config.constants import CLASS_NOISE

        ds = self.val_dataset if self.val_dataset is not None \
            else self.train_dataset
        model = state.model.eval()
        confs, ys, sws, noise_sel = [], [], [], []
        for g, targets, *_, banded in self._host_batches(ds, shuffle=False):
            with torch.no_grad():
                out = model(g.to(self.device),
                            banded=self._device_banded(banded))
            m = np.asarray(g.node_mask).astype(bool).reshape(-1)
            c = out["confidence"].cpu().numpy().astype(np.float64)
            pc = out["predicted_class"].cpu().numpy().reshape(-1)[m]
            labels = np.asarray(targets["labels"]).reshape(-1)[m]
            confs.append(c.reshape(-1)[m])
            if "correction" in targets and "correction" in out:
                corr_t = np.asarray(targets["correction"],
                                    np.float64).reshape(-1)[m]
                corr_p = out["correction"].cpu().numpy().astype(
                    np.float64).reshape(-1)[m]
                # benefit of applying the correction, in squared
                # normalized-depth units: error^2 before minus after
                delta = corr_t ** 2 - (corr_p - corr_t) ** 2
                ys.append(delta > 0)
                sws.append(np.abs(delta))
            else:
                ys.append(pc == labels)
                sws.append(np.ones(int(m.sum())))
            noise_sel.append(pc == CLASS_NOISE)
        c_all = np.clip(np.concatenate(confs), 1e-6, 1.0 - 1e-6)
        y_all = np.concatenate(ys).astype(np.float64)
        sw_all = np.concatenate(sws).astype(np.float64)
        sel = np.concatenate(noise_sel)
        fit_on = "predicted-noise" if int(sel.sum()) >= 200 else "all"
        if fit_on == "all":
            sel = np.ones_like(sel)
        z = np.log(c_all[sel] / (1.0 - c_all[sel]))
        y = y_all[sel]
        sw = sw_all[sel]
        swm = sw / max(float(sw.mean()), 1e-12)

        def bce(a_, b_):
            p = np.clip(1.0 / (1.0 + np.exp(-(a_ * z + b_))), 1e-12,
                        1 - 1e-12)
            return float(-np.mean(swm * (y * np.log(p)
                                         + (1.0 - y) * np.log(1.0 - p))))

        a_f, b_f = self.fit_platt(z, y, sw)

        def frac_above(v, thr=0.85):
            return float(np.mean(v >= thr)) if v.size else 0.0

        cal = 1.0 / (1.0 + np.exp(-(a_f * z + b_f)))
        info = {
            "confidence_scale": a_f,
            "confidence_bias": b_f,
            "fit_on": fit_on,
            "fit_nodes": int(y.size),
            "fit_benefit_rate": float(y.mean()) if y.size else 0.0,
            "fit_bce_raw": bce(1.0, 0.0),
            "fit_bce_calibrated": bce(a_f, b_f),
            "benefit_above_085_raw": frac_above(c_all[sel][y > 0.5]),
            "benefit_above_085_cal": frac_above(cal[y > 0.5]),
            "harm_above_085_raw": frac_above(c_all[sel][y < 0.5]),
            "harm_above_085_cal": frac_above(cal[y < 0.5]),
            "gate_net_gain_raw": float(np.sum(
                np.where(y > 0.5, sw, -sw) * (c_all[sel] >= 0.85))),
            "gate_net_gain_cal": float(np.sum(
                np.where(y > 0.5, sw, -sw) * (cal >= 0.85))),
            "val_nodes": int(y_all.size),
            "val_benefit_rate": float(y_all.mean()),
        }
        for name in ("", "best", "last", "final"):
            p = self.output_dir / name if name else self.output_dir
            if p.is_dir():
                (p / "calibration.json").write_text(json.dumps(info))
        logger.info("confidence calibration: scale=%.3f bias=%.3f on %s "
                    "(%d cells, BCE %.4f -> %.4f)", a_f, b_f, fit_on, y.size,
                    info["fit_bce_raw"], info["fit_bce_calibrated"])
        return a_f

    # -- checkpointing -----------------------------------------------------

    def save_checkpoint(self, state: TrainState, epoch: int,
                        best_val: float, name: str):
        """A port checkpoint under output_dir/name: grid-named weights
        with ``param_layout`` "coo" (the graph trainer's), plus
        ``train_state.pt`` (AdamW moments and count, step)."""
        from ..config.constants import (CORRECTION_NORM_CAP,
                                        CORRECTION_NORM_FLOOR)
        from ..utils.weights import grid_state_dict, save_checkpoint

        meta = {
            "epoch": epoch, "best_val": best_val, "param_layout": "coo",
            "correction_norm_floor": CORRECTION_NORM_FLOOR,
            "correction_norm_cap": CORRECTION_NORM_CAP,
            "class_weights": self.class_weights.cpu().numpy(),
            "huber_delta": self.huber_delta,
        }
        d = save_checkpoint(self.output_dir / name,
                            grid_state_dict(state.model.state_dict()),
                            self.config, meta)
        torch.save({"optimizer": state.optimizer.state_dict(),
                    "step": state.step}, d / "train_state.pt")
        self.config.save(self.output_dir / "config.yaml")

    def load_checkpoint(self, path, state: TrainState):
        """(state, next epoch, best val) from a checkpoint this trainer
        wrote, or None when ``path`` holds none."""
        from ..utils.weights import coo_state_dict, load_state_dict

        path = Path(path)
        if not (path / "model.pt").exists():
            return None
        sd, meta = load_state_dict(path)
        state.model.load_state_dict(coo_state_dict(sd))
        ts = torch.load(path / "train_state.pt", map_location="cpu",
                        weights_only=True)
        state.optimizer.load_state_dict(ts["optimizer"])
        state.step = int(ts["step"])
        return state, int(meta["epoch"]) + 1, float(meta["best_val"])
