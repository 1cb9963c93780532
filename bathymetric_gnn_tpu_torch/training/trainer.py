"""Trainer helpers (port of the parts of ``bathymetric_gnn_tpu/training/trainer.py``
that the grid trainer uses): the per-epoch learning-rate schedules, the
train state and the dropout generator. The COO graph ``Trainer`` is
ported with the COO path (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch


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
