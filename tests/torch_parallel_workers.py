"""Process worlds for the port's sharded-path tests (``test_torch_parallel_*``).

``run_world(name, world, tmp_path, *args)`` spawns ``world`` processes
(``torch.multiprocessing``), joins them into a gloo process group that
meets through a ``FileStore`` under ``tmp_path`` (no fixed port: test
workers run side by side), runs the function ``name`` of this module as
``fn(rank, world, *args)`` in each, and returns each rank's result (what
the function returned, saved with ``torch.save``). The workers import
``torch``, ``numpy`` and the port only, never ``jax``: the JAX references
are computed in the test process.
"""

from __future__ import annotations

import sys
import traceback
from pathlib import Path

import numpy as np
import torch

WORKER_THREADS = 1


def _entry(rank, world, init, name, out_dir):
    torch.set_num_threads(WORKER_THREADS)
    from bathymetric_gnn_tpu_torch.parallel.mesh import initialize_distributed

    import torch.distributed as dist

    try:
        args = torch.load(Path(out_dir) / "args.pt", weights_only=False)
        initialize_distributed(init, world, rank, device="cpu")
        result = globals()[name](rank, world, *args)
        torch.save(result, Path(out_dir) / f"rank{rank}.pt")
    except Exception:
        (Path(out_dir) / f"rank{rank}.err").write_text(
            traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_world(name: str, world: int, tmp_path, *args):
    """Each rank's result of ``name(rank, world, *args)`` in a gloo world
    of ``world`` processes."""
    import torch.multiprocessing as mp

    out = Path(tmp_path) / f"{name}-{world}"
    out.mkdir(parents=True, exist_ok=True)
    # the arguments go through a file: pickled into spawn's pipe, a large
    # one would start the processes one after another
    torch.save(args, out / "args.pt")
    try:
        mp.spawn(_entry, args=(world, f"file://{out}/store", name,
                               str(out)), nprocs=world)
    except Exception:
        errs = "\n".join(p.read_text() for p in sorted(out.glob("*.err")))
        raise AssertionError(f"world {name}/{world} failed:\n{errs}") from None
    return [torch.load(out / f"rank{r}.pt", weights_only=False)
            for r in range(world)]


# -- shared inputs (numpy, the JAX tests' helpers) -----------------------------

def make_ramp_surface(h=64, w=64, base_depth=30.0, seed=0):
    """``tests/conftest.make_ramp_surface`` (conftest imports jax)."""
    rg = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = (base_depth + 0.05 * xx + 0.02 * yy + 0.5 * np.sin(xx / 7.0)
             + 0.3 * np.cos(yy / 9.0)
             + rg.normal(0, 0.02, (h, w)).astype(np.float32))
    return depth.astype(np.float32)


def halo_case(h=64, w=48, masked=True):
    """``tests/test_halo.setup_case``: a ramp with an interior hole, a
    hole across the 2- and 4-shard boundaries and an invalid first row."""
    depth = make_ramp_surface(h, w)
    valid = np.ones((h, w), bool)
    if masked:
        valid[10:14, 5:30] = False
        valid[30:34, :] = False
        valid[0, :] = False
        depth = depth.copy()
        depth[~valid] = np.nan
    return np.nan_to_num(depth).astype(np.float32), valid


def halo2d_case(h=32, w=32, masked=True):
    """``tests/test_halo2d.setup_case``: holes on both seams."""
    depth = make_ramp_surface(h, w)
    valid = np.ones((h, w), bool)
    if masked:
        valid[6:10, 5:20] = False
        valid[h // 2 - 2:h // 2 + 2, :] = False
        valid[:, w // 2] = False
        depth = depth.copy()
        depth[~valid] = np.nan
    return np.nan_to_num(depth).astype(np.float32), valid


def halo_train_batch(bsz=2, h=32, w=48, seed=7, border=0):
    """``tests/test_halo._make_train_batch`` as NumPy arrays; ``border``
    1 makes the first and last rows of every tile invalid, 2 the first
    and last columns too (the cells where the JAX halo models featurize
    an empty halo, ROADMAP queue 3)."""
    rg = np.random.default_rng(seed)
    out = {"noisy": [], "valid": [], "labels": [], "raw_correction": []}
    for i in range(bsz):
        depth, valid = halo_case(h=h, w=w, masked=(i == 0))
        if border:
            valid = valid.copy()
            valid[[0, -1]] = False
            if border > 1:
                valid[:, [0, -1]] = False
            depth = np.where(valid, depth, 0.0).astype(np.float32)
        lbl = (rg.random((h, w)) < 0.2).astype(np.int32) * 2
        corr = rg.normal(0, 0.3, (h, w)).astype(np.float32) * (lbl == 2)
        out["noisy"].append(depth)
        out["valid"].append(valid)
        out["labels"].append(lbl)
        out["raw_correction"].append(corr)
    return {k: np.stack(v) for k, v in out.items()}


def sgd_setup(model, clip=1e9):
    """A TrainState of ``model`` with SGD, and a training config with a
    clip norm no gradient reaches: a parameter's change after a step at
    learning rate 1 is minus its gradient."""
    from bathymetric_gnn_tpu_torch.config.config import TrainingConfig
    from bathymetric_gnn_tpu_torch.training.optim import SGD
    from bathymetric_gnn_tpu_torch.training.trainer import TrainState

    tc = TrainingConfig()
    tc.grad_clip_norm = clip
    return TrainState(model, SGD(model.parameters())), tc


def _numpy_state(model):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in model.state_dict().items()}


def _scalars(losses, acc):
    return ({k: float(v) for k, v in losses.items()}, float(acc))


# -- mesh helpers, collectives, sync-BN ------------------------------------------

def mesh_and_collectives(rank, world, bn_x, bn_mask, bn_ct):
    import torch.distributed as dist

    from bathymetric_gnn_tpu_torch.models import layers
    from bathymetric_gnn_tpu_torch.parallel import collectives as C
    from bathymetric_gnn_tpu_torch.parallel import mesh as M

    res = {"init": [M.initialize_distributed(), M.initialize_distributed(
        "file:///nonexistent", world, rank, device="cpu")]}
    hm = M.make_host_mesh(graph_axis=2, local_world_size=2)
    res["host_mesh"] = (hm.mesh_dim_names, hm.mesh.tolist())
    try:
        M.make_host_mesh(graph_axis=3)
    except ValueError as e:
        res["host_mesh_refusal"] = str(e)
    batch = {"a": np.arange(16.0).reshape(8, 2),
             "b": [np.arange(8)], "c": None}
    dmesh = M.make_mesh(graph_axis=1)                       # (2, 1)
    res["shard"] = M.shard_batch_pytree(batch, dmesh)
    tiles = np.arange(2 * 6 * 3.0).reshape(2, 6, 3)
    res["host_local"] = M.host_local_batch_to_global(
        {"t": tiles}, hm, lambda x: ("data", "graph", None))["t"]
    res["host_local_plain"] = M.host_local_batch_to_global({"t": tiles}, hm)

    # all_reduce_sum: forward and the transpose
    x = (torch.arange(4.0) * (rank + 1)).requires_grad_()
    y = C.all_reduce_sum(x, None)
    (y * torch.full((4,), float(rank + 2))).sum().backward()
    res["ars"] = (y.detach().numpy(), x.grad.numpy())

    # halo_rows_split / exchange_halo_rows: rows of a [5, 3] block
    g = torch.Generator().manual_seed(rank)
    xb = torch.randn(5, 3, generator=g).requires_grad_()
    fa, fb = C.halo_rows_split(xb, 2, hm.get_group("graph"))
    ca = torch.randn(2, 3, generator=g)
    cb = torch.randn(2, 3, generator=g)
    ((fa * ca).sum() + (fb * cb).sum()).backward()
    ext = C.exchange_halo_rows(xb.detach(), 2, hm.get_group("graph"))
    res["halo"] = dict(x=xb.detach().numpy(), fa=fa.detach().numpy(),
                       fb=fb.detach().numpy(), ca=ca.numpy(), cb=cb.numpy(),
                       grad=xb.grad.numpy(), ext=ext.numpy())

    # sync-BN on a bf16 input: the f32 autograd path, never _BnLowp
    bn = layers.MaskedBatchNorm(bn_x.shape[-1]).train()
    xs = torch.from_numpy(bn_x[rank]).to(torch.bfloat16).requires_grad_()
    lowp_calls = []
    real = layers._BnLowp.apply
    layers._BnLowp.apply = lambda *a: lowp_calls.append(1) or real(*a)
    try:
        yb = bn(xs, torch.from_numpy(bn_mask[rank]), fuse_relu=True,
                group=hm.get_group("graph"))
    finally:
        layers._BnLowp.apply = real
    (yb * torch.from_numpy(bn_ct[rank])).sum().backward()
    res["bn"] = dict(dtype=str(yb.dtype), lowp_calls=len(lowp_calls),
                     y=yb.detach().numpy(), mean=bn.mean.numpy(),
                     var=bn.var.numpy(), dx=xs.grad.float().numpy())
    res["pg"] = dist.get_backend()
    return res


# -- data-parallel steps -------------------------------------------------------------

class _Stats:
    """The two numbers ``Trainer`` estimates from its dataset."""

    def class_counts(self):
        return np.ones(3)

    def sample_normalized_corrections(self):
        return np.zeros(4)


def dp_steps(rank, world, config, cw, hd, graph, targets, state_dict, lr,
             sparse, out_dir, exact=True):
    """The COO data-parallel train and eval steps on this rank's shard of
    the global batch (with world 1 also ``Trainer.train_step`` on the
    whole batch), or, given ``sparse`` ((pairs, targets)), the k-NN step
    on routes C and D; the train steps with ``exact``.
    ``config`` is the port's Config (its grad_clip_norm out of reach)."""
    from bathymetric_gnn_tpu_torch.models.gnn import make_model
    from bathymetric_gnn_tpu_torch.models.gnn_ell import make_ell_model
    from bathymetric_gnn_tpu_torch.parallel import data_parallel as DP
    from bathymetric_gnn_tpu_torch.parallel.mesh import (make_mesh,
                                                         shard_batch_pytree)
    from bathymetric_gnn_tpu_torch.training.optim import SGD
    from bathymetric_gnn_tpu_torch.training.trainer import (
        Trainer, TrainState, _to_device_targets)

    mesh = make_mesh(graph_axis=1)
    tc = config.training
    cw = torch.as_tensor(np.asarray(cw, np.float32))

    def fresh(**kw):
        m = (make_ell_model(config.model, 7, **kw) if kw
             else make_model(config.model, 7, dropout=0.0))
        m.load_state_dict(state_dict)
        return TrainState(m, SGD(m.parameters()))

    res = {}
    if sparse is not None:
        pairs, sp_targets = sparse
        g, banded = DP.stack_banded_batches(pairs, mesh)
        for route, wide in (("C", True), ("D", False)):
            st = fresh(sparse_kernel="banded_pallas", dropout=0.0)
            for i in range(config.model.num_layers):
                getattr(st.model.GNNBackbone_0,
                        f"GATConv_{i}").wide_kernel = wide
            sstep = DP.make_dp_sparse_train_step(st.model, st.optimizer, tc,
                                                 cw, hd, mesh, exact=exact)
            _, sl, sa = sstep(st, g, None if wide else banded,
                              shard_batch_pytree(sp_targets, mesh),
                              torch.Generator().manual_seed(0), lr)
            res["sparse_" + route] = (_scalars(sl, sa),
                                      _numpy_state(st.model))
        return res
    g_local = shard_batch_pytree(graph, mesh)
    t_local = shard_batch_pytree(targets, mesh)
    st = fresh()
    step = DP.make_dp_train_step(st.model, st.optimizer, tc, cw, hd, mesh,
                                 exact=exact)
    _, losses, acc = step(st, g_local, t_local,
                          torch.Generator().manual_seed(0), lr)
    res["coo"] = (_scalars(losses, acc), _numpy_state(st.model))
    st = fresh()
    ev = DP.make_dp_eval_step(st.model, tc, cw, hd, mesh)
    res["eval"] = _scalars(*ev(st, g_local, t_local))
    if world == 1:
        tr = Trainer(config, _Stats(), output_dir=out_dir, device="cpu")
        tr.class_weights, tr.huber_delta = cw, hd
        st = fresh()
        l1, a1 = tr.train_step(st, tr.sparse_batch(graph).to("cpu"),
                               _to_device_targets(targets, "cpu"), lr)
        res["trainer"] = (_scalars(l1, a1), _numpy_state(st.model))
    return res


def dp_modes(rank, world, jobs):
    """``dp_steps`` on each of ``jobs`` (its arguments from ``config`` to
    ``out_dir``) with ``exact`` True and False: [{exact: result}]."""
    return [{exact: dp_steps(rank, world, *job, exact)
             for exact in (True, False)} for job in jobs]


# -- the 1-D and 2-D halo models -------------------------------------------------

def halo_forwards(rank, world, state_dict, kw, cases, mesh_shape, axes):
    """The sharded forwards (overlap and serial for the 1-D model) of each
    case, and the train-mode BatchNorm update of the first."""
    from bathymetric_gnn_tpu_torch.parallel import halo, halo2d
    from bathymetric_gnn_tpu_torch.parallel.mesh import make_mesh

    two_d = len(axes) == 2
    mesh = make_mesh(shape=mesh_shape, axis_names=("data",) + tuple(axes))
    res = {}
    for overlap in ((False,) if two_d else (True, False)):
        cls = halo2d.HaloGrid2DGNN if two_d else halo.HaloGridGNN
        model = cls(**kw, **({} if two_d else {"overlap": overlap}))
        model.load_state_dict(state_dict)
        fwd = (halo2d.make_sharded_grid2d_forward if two_d
               else halo.make_sharded_grid_forward)(model, mesh)
        res[overlap] = [{k: v.numpy() for k, v in fwd(d, v_).items()}
                        for d, v_ in cases]
    # train-mode BatchNorm: the running mean after one update
    model = (halo2d.HaloGrid2DGNN if two_d else halo.HaloGridGNN)(**kw)
    model.load_state_dict(state_dict)
    model.train()
    groups = [mesh.get_group(a) for a in axes]
    d, v_ = cases[0]
    d = torch.from_numpy(halo._shard(d, mesh, axes))
    v_ = torch.from_numpy(halo._shard(v_, mesh, axes))
    with torch.no_grad(), halo.bound_groups(model, groups):
        model(d, v_, dropout_rng=torch.Generator().manual_seed(0))
    res["bn_mean"] = model.MaskedBatchNorm_0.mean.numpy().copy()
    return res


def halo_steps(rank, world, state_dict, kw, batch, cw, lr, meshes, axes):
    """One halo train step on each mesh shape of ``meshes`` from the same
    weights; returns (losses, accuracy) and the state after each."""
    from bathymetric_gnn_tpu_torch.parallel import halo, halo2d
    from bathymetric_gnn_tpu_torch.parallel.mesh import (
        host_local_batch_to_global, make_mesh, shard_batch_pytree)

    two_d = len(axes) == 2
    names = ("data",) + tuple(axes)
    out = {}
    for shape in meshes:
        mesh = make_mesh(shape=shape, axis_names=names)
        model = (halo2d.HaloGrid2DGNN if two_d else halo.HaloGridGNN)(**kw)
        model.load_state_dict(state_dict)
        state, tc = sgd_setup(model)
        make = (halo2d.make_halo2d_train_step if two_d
                else halo.make_halo_train_step)
        step = make(model, state.optimizer, tc, cw, 1.0, mesh)
        local = host_local_batch_to_global(
            shard_batch_pytree(batch, mesh), mesh,
            lambda x: names)
        _, losses, acc = step(state, local,
                              torch.Generator().manual_seed(3), lr)
        out[tuple(shape)] = (_scalars(losses, acc), _numpy_state(model))
    return out


def halo_world(rank, world, state_dict, kw, cases, mesh_shape, axes,
               batch, cw, lr, step_meshes):
    """``halo_forwards`` then, for each of ``step_meshes``,
    ``halo_steps``."""
    out = halo_forwards(rank, world, state_dict, kw, cases, mesh_shape,
                        axes)
    out["steps"] = halo_steps(rank, world, state_dict, kw, batch, cw, lr,
                              step_meshes, axes)
    return out


if __name__ == "__main__":   # pragma: no cover
    sys.exit("a helper of the tests; run pytest")
