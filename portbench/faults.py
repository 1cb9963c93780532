"""Faults planted under the timed path, to show that the comparison with
the reference catches them (tests, and ``control.py --fault``).

- ``altered``: every batch's packed survey output has its first tile's
  confidence halved where ``forward_tiles`` produces it;
- ``unchanged``: a training step computes its loss and gradients and
  returns the state as it was (no optimizer step);
- ``half_batch``: a training step's loss (and, on the COO path, its
  BatchNorm moments) takes in the first half of the batch alone.
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch


def _patches(name: str):
    from bathymetric_gnn_tpu_torch.inference.pipeline import \
        BathymetricPipeline
    from bathymetric_gnn_tpu_torch.training.grid_trainer import GridTrainer
    from bathymetric_gnn_tpu_torch.training.trainer import Trainer

    if name == "altered":
        orig = BathymetricPipeline.forward_tiles

        def forward_tiles(self, *a, **k):
            res = orig(self, *a, **k)
            res[1, 0] = res[1, 0] * 0.5
            return res
        return [(BathymetricPipeline, "forward_tiles", forward_tiles)]
    if name == "unchanged":
        def unchanged(step_loss):
            def train_step(self, state, *batch):
                model = state.model
                for p in model.parameters():
                    p.grad = None
                losses, acc = step_loss(self, model, *batch)
                losses["total"].backward()
                return ({k: t.detach() for k, t in losses.items()},
                        acc.detach())
            return train_step

        def grid_loss(self, model, batch, lr):
            return self.loss_fn(model, batch, train=True)

        def coo_loss(self, model, g, targets, lr, banded=None):
            return self.loss_fn(model, g, targets, train=True,
                                banded=banded)
        return [(GridTrainer, "train_step", unchanged(grid_loss)),
                (Trainer, "train_step", unchanged(coo_loss))]
    if name == "half_batch":
        grid_orig, coo_orig = GridTrainer.loss_fn, Trainer.loss_fn

        def grid_half(self, model, batch, train):
            half = len(batch["noisy"]) // 2
            return grid_orig(self, model,
                             {k: v[:half] for k, v in batch.items()}, train)

        def coo_half(self, model, g, targets, train, banded=None):
            n = g.node_mask.shape[0]
            keep = torch.arange(n, device=g.node_mask.device) < n // 2
            g = dataclasses.replace(g, node_mask=g.node_mask & keep)
            return coo_orig(self, model, g, targets, train, banded)
        return [(GridTrainer, "loss_fn", grid_half),
                (Trainer, "loss_fn", coo_half)]
    raise ValueError(f"no fault named {name!r}")


@contextlib.contextmanager
def planted(name: str):
    patches = _patches(name)
    origs = [(cls, attr, getattr(cls, attr)) for cls, attr, _ in patches]
    for cls, attr, fn in patches:
        setattr(cls, attr, fn)
    try:
        yield
    finally:
        for cls, attr, fn in origs:
            setattr(cls, attr, fn)
