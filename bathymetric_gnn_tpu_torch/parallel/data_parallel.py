"""Data-parallel training over the mesh's ``data`` dimension (port of
``bathymetric_gnn_tpu/parallel/data_parallel.py``).

Each rank owns its own tiles of the batch, merges them into one graph (no
edge crosses ranks), computes its loss and gradients on its device, and
the ranks average the gradients, the metrics and the BatchNorm running
statistics over the ``data`` process group in one all-reduce, so every
rank applies the same update.

The train steps take JAX's ``exact`` flag:

- ``exact=True`` (the default) equals the single-device step on the
  concatenated batch. The loss terms' numerators and denominators and the
  accuracy's are all-reduced before the divide
  (``training/trainer.make_loss_fn``'s ``terms_group``), and the
  BatchNorm moments are synced over ``data`` (``MaskedBatchNorm``'s
  ``group``). The collectives are ``parallel/collectives.all_reduce_sum``,
  whose backward is again an all-reduce sum (psum's transpose): each
  rank's backward then carries a factor of the group's size, and the
  average of the gradients is the exact total gradient.
- ``exact=False`` is torch-DDP-style local BatchNorm: each rank's
  ``MaskedBatchNorm`` takes its moments over its own live nodes, and its
  loss terms and accuracy are normalized by its own counts. The forward
  runs no collective, so the average of the gradients is the classic DDP
  average of the ranks' own gradients, as JAX's ``pmean`` of them.

At world 1 the two are the same computation. ``make_dp_eval_step`` has no
``exact``: its loss terms are always reduced exactly, as JAX's.

The optimizer is the trainer's: ``clip_by_global_norm_`` with
``training_cfg.grad_clip_norm``, then ``optimizer.step(grads, lr)``.
Each rank's dropout generator is seeded from one draw of the step's
generator folded with the rank's ``data`` index (``jax.random.fold_in``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.graph import CooGraph, merge_stacked
from ..training.optim import clip_by_global_norm_
from ..training.trainer import TrainState, _to_device_targets, make_loss_fn
from .collectives import all_reduce_mean_

DATA_AXIS = "data"


def fold_in(rng: torch.Generator, index: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from one draw of ``rng`` and
    ``index`` (ranks drawing from equal ``rng`` get distinct streams)."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=rng,
                             device=rng.device))
    mixed = (seed * 0x9E3779B97F4A7C15 + int(index) + 1) % (2 ** 63)
    return torch.Generator(device=device).manual_seed(mixed)


@contextlib.contextmanager
def bn_group(model: torch.nn.Module, group):
    """Sync the BatchNorm moments of ``model``'s backbone over ``group``
    for the duration (the JAX ``model.clone(bn_axis_name=...)``)."""
    bb = model.GNNBackbone_0
    old, bb.bn_group = bb.bn_group, group
    try:
        yield
    finally:
        bb.bn_group = old


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _apply_update(state: TrainState, model, optimizer, training_cfg,
                  group, losses: Dict, acc: torch.Tensor, lr: float):
    """pmean over ``group`` of the gradients, the losses, the accuracy
    and the BatchNorm running statistics (one all-reduce), then clip and
    the optimizer's step; returns the averaged (losses, accuracy)."""
    params = list(model.parameters())
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    losses = {k: v.detach().clone() for k, v in losses.items()}
    acc = acc.detach().clone()
    stats = [b for n, b in model.named_buffers()
             if n.endswith((".mean", ".var"))]
    all_reduce_mean_(grads + list(losses.values()) + [acc] + stats, group)
    clip_by_global_norm_(grads, training_cfg.grad_clip_norm)
    optimizer.step(grads, lr)
    state.step += 1
    return losses, acc


def _check_state(state: TrainState, model, optimizer) -> None:
    if state.model is not model or state.optimizer is not optimizer:
        raise ValueError("the step trains the model and optimizer it was "
                         "built with: pass TrainState(model, optimizer)")


def make_dp_train_step(
    model,
    optimizer,
    training_cfg,
    class_weights,
    huber_delta,
    mesh: DeviceMesh,
    exact: bool = True,
) -> Callable:
    """A data-parallel train step of the COO model (``models/gnn``): on the
    card every segment sum and gather backward is kernel F (a). ``exact``
    as in the module docstring.

    ``step(state, graph, targets, rng, lr)`` -> (state, losses, accuracy):
    ``graph`` this rank's stacked [B_local, ...] ``PaddedGraph`` and
    ``targets`` its stacked targets (NumPy, ``collate_samples``; from
    ``mesh.shard_batch_pytree`` of the global batch, or loaded by this
    process), ``rng`` the step's ``torch.Generator`` (equal on every
    rank), ``lr`` the learning rate. ``state`` is ``TrainState(model,
    optimizer)``; the step updates it in place on every rank alike."""
    group = mesh.get_group(DATA_AXIS)
    sync = group if exact else None
    index = mesh.get_local_rank(DATA_AXIS)
    loss_fn = make_loss_fn(training_cfg, class_weights, huber_delta, True,
                           terms_group=sync)

    def step(state: TrainState, graph, targets, rng: torch.Generator,
             lr: float):
        _check_state(state, model, optimizer)
        dev = _device(model)
        g = CooGraph.from_padded(merge_stacked(graph)).to(dev)
        t = _to_device_targets(targets, dev)
        for p in model.parameters():
            p.grad = None
        with bn_group(model, sync):
            losses, acc = loss_fn(model, g, t, fold_in(rng, index, dev))
            losses["total"].backward()
        losses, acc = _apply_update(state, model, optimizer, training_cfg,
                                    group, losses, acc, lr)
        return state, losses, acc

    return step


def make_dp_eval_step(model, training_cfg, class_weights, huber_delta,
                      mesh: DeviceMesh) -> Callable:
    """``step(state, graph, targets)`` -> (losses, accuracy) of the eval
    loss over every rank's batch (running BatchNorm statistics, so only
    the loss terms are all-reduced); equal on every rank."""
    group = mesh.get_group(DATA_AXIS)
    loss_fn = make_loss_fn(training_cfg, class_weights, huber_delta, False,
                           terms_group=group)

    @torch.no_grad()
    def step(state: TrainState, graph, targets):
        if state.model is not model:
            raise ValueError("the step evaluates the model it was built "
                             "with")
        dev = _device(model)
        g = CooGraph.from_padded(merge_stacked(graph),
                                 src_table=False).to(dev)
        return loss_fn(model, g, _to_device_targets(targets, dev))

    return step


def stack_banded_batches(pairs, mesh: DeviceMesh):
    """[(EllGraph, BandedEll or None)] per ``data`` shard -> this rank's
    pair.

    The JAX function stacks the shards' pairs along a leading dimension
    for ``shard_map``, which needs equal static shapes, so it normalizes
    the data-dependent reducer depths (``spill_red_maxj``) across shards.
    Here each rank keeps its own graph and decomposition and nothing is
    stacked across processes; the port's ``BandedEll`` carries (perm,
    row_ptr) tables instead of reducer depths, so shards of unequal spill
    counts need no alignment. A process that built every shard's pair
    passes them all; one that built only its own passes a list of one."""
    if len(pairs) == 1:
        return pairs[0]
    nd = mesh.size(mesh.mesh_dim_names.index(DATA_AXIS))
    if len(pairs) != nd:
        raise ValueError(f"{len(pairs)} pairs for {nd} data shards")
    return pairs[mesh.get_local_rank(DATA_AXIS)]


def make_dp_sparse_train_step(
    ell_model,
    optimizer,
    training_cfg,
    class_weights,
    huber_delta,
    mesh: DeviceMesh,
    exact: bool = True,
) -> Callable:
    """Data-parallel train step of the ``"banded_pallas"`` ELL model (the
    k-NN path). On the card its default route C runs kernel C's dropout
    form, C' and F (b); with ``wide_kernel=False`` on its layers, D and D'.

    ``step(state, g, banded, targets, rng, lr)`` -> (state, losses,
    accuracy): ``(g, banded)`` this rank's merged ``EllGraph`` (with its
    source-sorted slot tables, ``with_src_sorted_slots``, for C') and
    ``BandedEll`` (None on route C) from ``stack_banded_batches``,
    ``targets`` its stacked [B_local, n_pad] targets; the rest as in
    ``make_dp_train_step``."""
    group = mesh.get_group(DATA_AXIS)
    sync = group if exact else None
    index = mesh.get_local_rank(DATA_AXIS)
    loss_fn = make_loss_fn(training_cfg, class_weights, huber_delta, True,
                           terms_group=sync)

    def step(state: TrainState, g, banded, targets, rng: torch.Generator,
             lr: float):
        _check_state(state, ell_model, optimizer)
        dev = _device(ell_model)
        g = g.to(dev)
        banded = None if banded is None else banded.to(dev)
        t = _to_device_targets(targets, dev)
        for p in ell_model.parameters():
            p.grad = None
        with bn_group(ell_model, sync):
            losses, acc = loss_fn(ell_model, g, t,
                                  fold_in(rng, index, dev), banded)
            losses["total"].backward()
        losses, acc = _apply_update(state, ell_model, optimizer,
                                    training_cfg, group, losses, acc, lr)
        return state, losses, acc

    return step

