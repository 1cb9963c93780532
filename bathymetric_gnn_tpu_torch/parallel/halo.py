"""Spatial (halo-exchange) partitioning of the dense-grid model (port of
``bathymetric_gnn_tpu/parallel/halo.py``).

One survey grid too large for a card is row-sharded over the mesh's
``graph`` process group: rank r owns rows [r L, (r + 1) L). Featurization
exchanges a 4-row halo of depth and validity once; each GAT layer then
refreshes a 1-row halo of activations from the neighbouring ranks
(``parallel/collectives``). BatchNorm moments are summed over the group
(sync-BN), so the sharded model computes what the single-card
``GridBathymetricGNN`` computes on the whole grid, up to f32 rounding
(the featurization centres its masked statistics on the shard's mean).

**Overlap (default)**: only the first and last local row of a shard
depend on the halo, so each layer after the first

    posts the exchange of the two boundary rows      (NCCL's stream)
    runs the layer on the local block                (kernel A; rows 0
                                                      and L - 1 discarded)
    waits, then finishes the two boundary rows       (two 3-row strip
                                                      convs, kernel A at
                                                      H = 3)

The local block does not depend on the exchange, so on NCCL the interior
kernel runs while the rows are in flight. ``overlap=False`` exchanges
first and runs the layer on the L + 2 rows (the same math).

Inference folds each BatchNorm into kernel A's epilogue, interior and
strips alike (``GridBathymetricGNN``'s fold); training runs kernel A's
training form and kernel B behind it. ``HaloGridGNN`` has the parameter
layout of ``GridBathymetricGNN`` (it is one), so ``utils/weights``'
``grid_state_dict`` of a single-card model loads into it unchanged.
``parallel/halo2d`` is the same model over row x col blocks.
"""

from __future__ import annotations

import contextlib
import inspect
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config.constants import (CLASS_NOISE, CORRECTION_NORM_CAP,
                                CORRECTION_NORM_FLOOR)
from ..data.graph_build import build_grid_inputs
from ..models.grid_gat import GridBathymetricGNN
from ..models.layers import keep_mask
from ..training import losses as L
from ..training.optim import clip_by_global_norm_
from ..training.trainer import TrainState, all_reduce_terms
from .collectives import (HaloExchange, all_gather_rows, all_reduce_mean_,
                          exchange_halo_rows, halo_rows_split)
from .data_parallel import _device, fold_in

GRAPH_AXIS = "graph"
HALO_FEAT = 4   # 5x5 stats (2) + gradient / curvature (1) + one ring more,
# so that the halo row's features, which layer 0 reads, are exact

__all__ = ["GRAPH_AXIS", "HaloGridGNN", "exchange_halo_rows",
           "halo_rows_split", "make_halo_train_step",
           "make_sharded_grid_forward", "pad_rows_to_multiple"]


def _check_inject_opt_state(optimizer) -> None:
    """The halo train steps pass the learning rate to every step, which
    needs ``optimizer.step(grads, lr)`` (the trainers' optimizers,
    ``training/optim``); fail before the step runs otherwise."""
    step = getattr(optimizer, "step", None)
    try:
        inspect.signature(step).bind([], 1.0)
    except (TypeError, ValueError):
        raise TypeError(
            "halo train steps need an optimizer whose step(grads, lr) takes "
            f"the learning rate (training/optim); got {type(optimizer)!r}"
        ) from None


def _pad_dim(t: torch.Tensor, dim: int, before: int, after: int
             ) -> torch.Tensor:
    """t with ``before`` / ``after`` zero (False) slices added on dim."""
    if before == after == 0:
        return t
    parts = []
    for k in (before, after):
        shape = list(t.shape)
        shape[dim] = k
        parts.append(t.new_zeros(shape))
    return torch.cat([parts[0], t, parts[1]], dim)


def suppress_border(v_ext: torch.Tensor, halo: int,
                    groups: Sequence) -> torch.Tensor:
    """Zero the validity halo of v_ext [rows, cols, ...] at the global
    survey border (dim i sharded over ``groups[i]``), where no neighbour
    sent cells."""
    for dim, g in enumerate(groups):
        r, n = dist.get_rank(g), dist.get_world_size(g)
        size = v_ext.shape[dim]
        idx = torch.arange(size, device=v_ext.device)
        ok = ((r > 0) | (idx >= halo)) & ((r < n - 1) | (idx < size - halo))
        shape = [1] * v_ext.dim()
        shape[dim] = size
        v_ext = v_ext & ok.reshape(shape)
    return v_ext


class HaloGridGNN(GridBathymetricGNN):
    """The row-sharded grid model: ``GridBathymetricGNN``'s layers applied
    to one shard's [L, W] rows with halo exchanges over ``groups`` (one
    group: rows over ``graph``; ``parallel/halo2d`` passes two: rows and
    columns). The sharded forwards and train steps bind ``groups`` to
    their mesh for the call; it is the JAX module's ``axis_name``.
    ``in_channels`` is the featurization's width (7)."""

    def __init__(self, in_channels: int = 7, hidden_channels: int = 64,
                 num_layers: int = 4, heads: int = 4, num_classes: int = 3,
                 dropout: float = 0.1, overlap: bool = True, **kwargs):
        super().__init__(in_channels, hidden_channels, num_layers, heads,
                         num_classes, dropout=dropout, **kwargs)
        self.overlap = overlap
        self.groups: Optional[Tuple] = None

    # -- the spatial layout (one sharded dimension here; two in halo2d) ---

    def _extend(self, t: torch.Tensor, halo: int) -> torch.Tensor:
        """t [rows, cols, ...] extended by ``halo`` neighbour rows (and
        columns, with two groups) on each side; zeros at the border."""
        for dim, g in enumerate(self.groups):
            t = exchange_halo_rows(t, halo, g, dim)
        return t

    def _crop(self, t: torch.Tensor, a: int, first: int) -> torch.Tensor:
        """Drop ``a`` cells on each side of the sharded dimensions of t,
        which start at dim ``first``."""
        for d in range(len(self.groups)):
            t = t.narrow(first + d, a, t.shape[first + d] - 2 * a)
        return t

    def _featurize(self, d_ext, v_ext, resolution):
        """``build_grid_inputs`` of the halo-extended block, (features,
        nbr_mask, edge_attr, local_std) with a leading batch of 1. At the
        global border the block is featurized without its (empty) halo
        and padded back with zeros, so that the border cells' gradient
        and curvature see the survey's edge as the single-card model's
        do; the JAX module featurizes the zero halo there, which moves
        the border rows' gradient features (ROADMAP queue 3)."""
        spans = []
        for dim, g in enumerate(self.groups):
            r, n, size = dist.get_rank(g), dist.get_world_size(g), \
                d_ext.shape[dim]
            lo = HALO_FEAT if r == 0 else 0
            hi = size - HALO_FEAT if r == n - 1 else size
            spans.append((dim, lo, hi, size))
            d_ext = d_ext.narrow(dim, lo, hi - lo)
            v_ext = v_ext.narrow(dim, lo, hi - lo)
        feats, _, nbr, eattr, lstd = build_grid_inputs(
            d_ext[None], v_ext[None],
            resolution=(float(resolution[0]), float(resolution[1])),
            connectivity=self.GridGATConv_0.connectivity)
        out = []
        for t, first in ((feats, 1), (nbr, 2), (eattr, 2), (lstd, 1)):
            for dim, lo, hi, size in spans:
                t = _pad_dim(t, first + dim, lo, size - hi)
            out.append(t)
        return out

    # -- the model -----------------------------------------------------------

    def forward(self, depth_local: torch.Tensor, valid_local: torch.Tensor,
                resolution: Tuple[float, float] = (1.0, 1.0),
                dropout_rng: Optional[torch.Generator] = None
                ) -> Dict[str, torch.Tensor]:
        """This shard's [L, W] depth and validity -> its per-cell outputs
        ([L, W, ...], as ``GridBathymetricGNN`` per tile, plus
        ``local_std``)."""
        if self.groups is None:
            raise RuntimeError("HaloGridGNN runs inside a sharded forward or "
                               "train step, which binds its process groups")
        hf = HALO_FEAT
        d_ext = self._extend(depth_local.to(torch.float32), hf)
        v_ext = suppress_border(self._extend(valid_local.to(torch.bool), hf),
                                hf, self.groups)
        feats_e, nbr_e, eattr_e, lstd_e = self._featurize(d_ext, v_ext,
                                                          resolution)
        tr = hf - 1      # keep a 1-cell activation halo for layer 0
        feats = self._crop(feats_e, tr, 1)
        valid1 = self._crop(v_ext, tr, 0)[None]
        nbr1 = self._crop(nbr_e, tr, 2)
        eattr1 = self._crop(eattr_e, tr, 2)
        local_std = self._crop(lstd_e, hf, 1)[0]

        drop = self.training and self.dropout > 0
        fold = not self.training and not (
            torch.is_grad_enabled()
            and any(p.requires_grad for p in self.parameters()))
        x = self.MLPFeatureExtractor_0(feats, dropout_rng)
        core_valid = self._crop(valid1, 1, 1)
        for i in range(self.num_layers):
            last = i == self.num_layers - 1
            conv = getattr(self, f"GridGATConv_{i}")
            norm = getattr(self, f"MaskedBatchNorm_{i}")
            kw = (dict(zip(("bn_scale", "bn_bias"), norm.affine()),
                       fuse_relu=not last) if fold
                  else dict(dropout_rng=dropout_rng))

            def run(xx, rows=slice(None)):
                return conv(xx, valid1[:, rows], nbr1[:, :, rows],
                            eattr1[:, :, rows], **kw)

            if i == 0:
                # layer 0's halo is left over from the featurization's
                y = self._crop(run(x), 1, 1)
            elif (self.overlap and len(self.groups) == 1
                  and x.shape[1] >= 2):
                y = self._overlapped(run, x)
            else:
                xh = self._extend(x[0], 1)[None]
                y = self._crop(run(xh), 1, 1)
            if fold:
                x = y
                continue
            width = y.shape[-1]
            flat = y.reshape(-1, width)
            keep, keep_prob = None, 1.0
            if drop and not last:
                keep_prob = 1.0 - self.dropout
                keep = keep_mask(flat.shape, keep_prob, dropout_rng,
                                 y.device)
            x = norm(flat, core_valid.reshape(-1), fuse_relu=not last,
                     keep=keep, keep_prob=keep_prob,
                     group=self.groups).reshape(y.shape)
        x = x.to(torch.float32)[0]
        logits = self.ClassificationHead_0(x, dropout_rng)
        out = {
            "class_logits": logits,
            "class_probs": torch.softmax(logits, -1),
            "predicted_class": torch.argmax(logits, -1),
            "confidence": self.ConfidenceHead_0(x, dropout_rng),
            "local_std": local_std,
        }
        if self.predict_correction:
            out["correction"] = self.CorrectionHead_0(x, dropout_rng)
        return out

    def _overlapped(self, run: Callable, x: torch.Tensor) -> torch.Tensor:
        """One layer with its halo refresh overlapped (module docstring):
        x [1, L, W, F] -> [1, L, W, HC]."""
        ex = HaloExchange(x[0], 1, self.groups[0])
        y_loc = run(x, slice(1, -1))    # rows 0 and L - 1: discarded
        fa, fb = ex.wait()
        y_top = run(torch.cat([fa[None], x[:, :2]], 1), slice(0, 3))
        y_bot = run(torch.cat([x[:, -2:], fb[None]], 1), slice(-3, None))
        return torch.cat([y_top[:, 1:2], y_loc[:, 1:-1], y_bot[:, 1:2]], 1)


@contextlib.contextmanager
def bound_groups(model: HaloGridGNN, groups: Sequence):
    """Bind ``model``'s halo groups for the duration."""
    old, model.groups = model.groups, tuple(groups)
    try:
        yield model
    finally:
        model.groups = old


def _shard(a, mesh: DeviceMesh, axes: Sequence[str], first: int = 0):
    """This rank's block of ``a`` (NumPy or tensor): dim ``first + i``
    split over mesh dimension ``axes[i]``."""
    from .mesh import _rank_slice

    for i, ax in enumerate(axes):
        a = _rank_slice(a, mesh.get_local_rank(ax),
                        mesh.size(mesh.mesh_dim_names.index(ax)), first + i)
    return a


def sharded_forward(model: HaloGridGNN, mesh: DeviceMesh,
                    axes: Sequence[str],
                    resolution: Tuple[float, float] = (1.0, 1.0)):
    """The forward of ``make_sharded_grid_forward`` over the mesh
    dimensions ``axes`` (rows, then columns)."""
    groups = [mesh.get_group(ax) for ax in axes]

    @torch.no_grad()
    def fwd(depth, valid) -> Dict[str, torch.Tensor]:
        dev = _device(model)
        d = torch.as_tensor(_shard(depth, mesh, axes)).to(dev)
        v = torch.as_tensor(_shard(valid, mesh, axes)).to(dev)
        model.eval()
        with bound_groups(model, groups):
            out = model(d, v, resolution)
        for dim in reversed(range(len(groups))):
            out = {k: all_gather_rows(t, groups[dim], dim)
                   for k, t in out.items()}
        return out

    return fwd


def make_sharded_grid_forward(
    model: HaloGridGNN,
    mesh: DeviceMesh,
    resolution: Tuple[float, float] = (1.0, 1.0),
):
    """``fwd(depth, valid)``: full [H, W] arrays in (H a multiple of the
    ``graph`` size; ``pad_rows_to_multiple``), full outputs out on every
    rank. Each rank takes its rows, runs the halo model on its device
    (eval mode: running BatchNorm statistics folded into kernel A), and
    the outputs are all-gathered."""
    return sharded_forward(model, mesh, (GRAPH_AXIS,), resolution)


def halo_train_step(model: HaloGridGNN, optimizer, training_cfg,
                    class_weights, huber_delta, mesh: DeviceMesh,
                    axes: Sequence[str], resolution=(1.0, 1.0),
                    data_axis: str = "data"):
    """The train step of ``make_halo_train_step`` with the tiles' rows
    (and columns) split over the mesh dimensions ``axes``."""
    _check_inject_opt_state(optimizer)
    tc = training_cfg
    groups = [mesh.get_group(ax) for ax in axes]
    index = mesh.get_local_rank(data_axis)
    stats = [b for n, b in model.named_buffers()
             if n.endswith((".mean", ".var"))]

    def local_loss(batch, dev, gen):
        terms, acc_num, acc_den, new_stats = [], [], [], []
        old = [s.clone() for s in stats]
        cw = torch.as_tensor(class_weights, dtype=torch.float32, device=dev)
        for b in range(batch["noisy"].shape[0]):
            for s, o in zip(stats, old):   # each tile from the old stats
                s.copy_(o)
            noisy, valid, labels, raw = (
                torch.as_tensor(np.asarray(batch[k][b])).to(dev)
                for k in ("noisy", "valid", "labels", "raw_correction"))
            out = model(noisy, valid, resolution, dropout_rng=gen)
            denom = out["local_std"].clamp_min(CORRECTION_NORM_FLOOR)
            corr_t = torch.clamp(raw / denom, -CORRECTION_NORM_CAP,
                                 CORRECTION_NORM_CAP)
            outputs = {k: (v.reshape(-1, v.shape[-1])
                           if k in ("class_logits", "class_probs")
                           else v.reshape(-1)) for k, v in out.items()}
            lbl = labels.reshape(-1).long()
            node_mask = valid.reshape(-1).to(torch.bool)
            terms.append(L.combined_loss_terms(
                outputs, {"labels": lbl, "correction": corr_t.reshape(-1),
                          "noise_mask": lbl == CLASS_NOISE},
                node_mask, class_weights=cw,
                label_smoothing=tc.label_smoothing,
                correction_delta=huber_delta))
            m = node_mask.to(torch.float32)
            acc_num.append(torch.sum((outputs["predicted_class"] == lbl)
                                     * m))
            acc_den.append(m.sum())
            new_stats.append([s.clone() for s in stats])
        with torch.no_grad():      # the tiles' updates, averaged
            for j, s in enumerate(stats):
                s.copy_(torch.stack([t[j] for t in new_stats]).mean(0))
        stacked = {k: tuple(torch.stack([t[k][i] for t in terms])
                            for i in range(2)) for k in terms[0]}
        # the exact sharded objective: each tile's numerators and
        # denominators summed over the spatial groups before the divide
        stacked, an, ad = all_reduce_terms(
            stacked, torch.stack(acc_num), torch.stack(acc_den), groups)
        losses = L.finalize_loss_terms(
            stacked, classification_weight=tc.classification_weight,
            correction_weight=tc.correction_weight,
            confidence_weight=tc.confidence_weight,
            feature_preservation_weight=tc.feature_preservation_weight,
            shoal_safety_weight=tc.shoal_safety_weight)
        losses = {k: v.mean() for k, v in losses.items()}
        return losses, (an / ad.clamp_min(1.0)).mean()

    def step(state: TrainState, batch: Dict, rng: torch.Generator,
             lr: float):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the step trains the model and optimizer it "
                             "was built with: pass TrainState(model, "
                             "optimizer)")
        dev = _device(model)
        params = list(model.parameters())
        for p in params:
            p.grad = None
        model.train()
        with bound_groups(model, groups):
            losses, acc = local_loss(batch, dev, fold_in(rng, index, dev))
            losses["total"].backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        losses = {k: v.detach() for k, v in losses.items()}
        acc = acc.detach()
        # the loss is the spatially global objective and psum's transpose
        # is psum, so each rank's backward carries the spatial group's
        # size as a factor: the mean over every rank (spatial, then data)
        # is the exact total gradient. Losses, accuracy and the BatchNorm
        # statistics are equal within a spatial group, so their mean over
        # every rank is their mean over ``data``.
        all_reduce_mean_(grads + list(losses.values()) + [acc] + stats,
                         None)
        clip_by_global_norm_(grads, tc.grad_clip_norm)
        optimizer.step(grads, lr)
        state.step += 1
        return state, losses, acc

    return step


def make_halo_train_step(
    model: HaloGridGNN,
    optimizer,
    training_cfg,
    class_weights,
    huber_delta,
    mesh: DeviceMesh,
    resolution: Tuple[float, float] = (1.0, 1.0),
):
    """dp x sp train step on the (data x graph) mesh.

    ``step(state, batch, rng, lr)`` -> (state, losses, accuracy): ``batch``
    is this rank's block of a [B, H, W] tile batch (keys ``noisy``,
    ``valid``, ``labels``, ``raw_correction``): the tiles of its ``data``
    index, the rows of its ``graph`` index (``mesh.shard_batch_pytree``
    then ``host_local_batch_to_global`` with ("data", "graph", None)).
    ``state`` is ``TrainState(model, optimizer)``, updated in place.

    Each tile runs through the halo model on its own, as the JAX step
    vmaps it: its BatchNorm moments summed over ``graph``, its running
    statistics' update averaged over the tiles. Every loss term's
    numerator and denominator is summed over ``graph`` before the divide,
    so with dropout 0 the sharded objective is the single-card one, also
    on masked surveys whose valid cells spread unevenly over the shards.
    The gradients are averaged over ``graph`` and ``data`` (see the note
    in the step), then clipped (``grad_clip_norm``) and applied by
    ``optimizer.step(grads, lr)``. With dropout the shards draw their own
    masks (each rank's generator folded with its data index), so the
    objective is equal in distribution, not bit for bit."""
    return halo_train_step(model, optimizer, training_cfg, class_weights,
                           huber_delta, mesh, (GRAPH_AXIS,), resolution)


def pad_rows_to_multiple(a, n: int, fill=0.0):
    """Pad the leading dim of a host array to a multiple of n; returns
    (padded, original rows)."""
    h = a.shape[0]
    target = ((h + n - 1) // n) * n
    if target == h:
        return a, h
    pad = np.full((target - h,) + a.shape[1:], fill, a.dtype)
    return np.concatenate([a, pad], 0), h
