"""PyTorch port vs JAX: the data-parallel train and eval steps
(``bathymetric_gnn_tpu_torch/parallel/data_parallel.py``) in gloo worlds of
1, 2 and 4 processes (``torch_parallel_workers``).

The JAX tests' batch sizes (``tests/test_data_parallel.build_batch``: 8
tiles of 48 from two 96^2 ramps, hidden 8, 2 layers, 2 heads; the tile
graphs built by the port's dataset and fed to both), at dropout 0 and
from the same weights (``utils/weights``), with SGD and a clip norm no
gradient reaches, so that a parameter's change is minus its gradient:

- the COO step at world 2 and 4 against JAX's ``make_dp_train_step`` on 2
  and 4 virtual devices, and against JAX's single-device step on the whole
  batch (``exact=True``: the sharded step equals it): losses rtol 1e-4,
  parameters and BatchNorm statistics rtol 5e-4, atol 1e-6;
- ``make_dp_eval_step`` at world 2 against JAX's on 2 devices and the
  single-device eval loss;
- world 1 against the port's ``Trainer.train_step`` on the same batch.

``test_torch_parallel_dp_knn.py`` holds the k-NN step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from bathymetric_gnn_tpu.config.config import (BucketConfig, Config,
                                               ModelConfig, TrainingConfig)
from bathymetric_gnn_tpu.models.gnn import make_model
from bathymetric_gnn_tpu.parallel.data_parallel import (make_dp_eval_step,
                                                        make_dp_train_step)
from bathymetric_gnn_tpu.parallel.mesh import make_mesh, shard_batch_pytree
from bathymetric_gnn_tpu.ops.graph import PaddedGraph, merge_stacked
from bathymetric_gnn_tpu.training.trainer import Trainer, TrainState
from bathymetric_gnn_tpu_torch.config.config import Config as PortConfig
from bathymetric_gnn_tpu_torch.training import datasets as port_datasets
from bathymetric_gnn_tpu_torch.utils.weights import (coo_state_dict,
                                                     state_dict_from_flax)

from conftest import make_ramp_surface
from torch_parallel_workers import run_world

LR = 1.0
RTOL, ATOL = 5e-4, 1e-6


def _sgd():
    return optax.chain(optax.clip_by_global_norm(1e9),
                       optax.inject_hyperparams(optax.sgd)(learning_rate=LR))


class _Stats:
    """The dataset numbers the JAX Trainer estimates (class counts, the
    Huber delta's corrections), from the port's samples."""

    def __init__(self, samples):
        self.samples = samples

    def class_counts(self):
        return sum(np.bincount(s.targets["labels"][:s.num_nodes],
                               minlength=3)[:3] for s in self.samples)

    def sample_normalized_corrections(self):
        return np.concatenate([
            s.targets["correction"][:s.num_nodes][
                s.targets["noise_mask"][:s.num_nodes]]
            for s in self.samples])


def _jax_setup(tmp, knn=False, batch=8):
    """The JAX trainer (SGD, a clip no gradient reaches) and state, and the
    batch: tile graphs built by the port's dataset (``test_data_parallel``'s
    surveys and sizes; the JAX dataset's graph builds would compile per
    tile shape), as NumPy for the port and as JAX arrays for JAX."""
    pcfg = PortConfig()
    if knn:
        cfg = Config(model=ModelConfig(hidden_channels=8, num_layers=2,
                                       heads=2, dropout=0.0,
                                       sparse_kernel="banded_pallas"),
                     bucket=BucketConfig(node_buckets=(2048,)),
                     training=TrainingConfig(batch_size=batch, seed=0))
        cfg.graph = dataclasses.replace(cfg.graph, knn_k=8)
        pcfg.graph.knn_k = 8
        grids = [make_ramp_surface(80, 80, seed=i) for i in range(2)]
        grids[0][8:30, 4:22] = np.nan   # shards of unequal spill counts
        tile = 40
    else:
        cfg = Config(model=ModelConfig(hidden_channels=8, num_layers=2,
                                       heads=2, dropout=0.0),
                     bucket=BucketConfig(node_buckets=(4096,)),
                     training=TrainingConfig(batch_size=batch, seed=0))
        grids = [make_ramp_surface(96, 96, seed=i) for i in range(2)]
        tile = 48
    pcfg.bucket.node_buckets = cfg.bucket.node_buckets
    ds = port_datasets.SyntheticTileDataset(grids, pcfg, tile_size=tile,
                                            overlap=8, min_valid_ratio=0.0,
                                            seed=0)
    samples = [ds[i % len(ds)] for i in range(batch)]
    np_graph, np_targets = port_datasets.collate_samples(samples)
    graph = PaddedGraph(**{f.name: jnp.asarray(getattr(np_graph, f.name))
                           for f in dataclasses.fields(PaddedGraph)})
    targets = {k: jnp.asarray(v) for k, v in np_targets.items()}
    model = make_model(cfg.model, in_channels=7, edge_dim=3)
    trainer = Trainer(cfg, model, _Stats(samples),
                      output_dir=str(tmp / "jax"))
    # Trainer.init_state's COO branch, jitted (eager flax init ~15 s)
    variables = jax.jit(model.init)(
        jax.random.PRNGKey(cfg.training.seed),
        merge_stacked(jax.tree.map(lambda a: a[:1], graph)))
    opt = _sgd()
    state = TrainState(variables["params"], variables.get("batch_stats", {}),
                       opt.init(variables["params"]), jnp.int32(0))
    trainer.optimizer = opt
    return cfg, trainer, state, graph, targets


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bridged(params, stats):
    return coo_state_dict(state_dict_from_flax(_np(params), _np(stats),
                                               "coo"))


def _port_config(cfg):
    pc = PortConfig()
    for f in ("hidden_channels", "num_layers", "heads", "dropout"):
        setattr(pc.model, f, getattr(cfg.model, f))
    pc.training.grad_clip_norm = 1e9
    return pc


def _jax_state_after(step_out):
    state, losses, acc = step_out
    return (({k: float(v) for k, v in losses.items()}, float(acc)),
            _bridged(state.params, state.batch_stats))


def _check_step(got, want, init, what, rtol=RTOL):
    """Losses, accuracy, and each leaf after the step: a parameter's
    change (minus its gradient: SGD at learning rate 1) within ``rtol``
    (5e-4) and an atol of 1e-4 of the largest change of any leaf (JAX's
    own sharded-step tests' atol, ``test_halo.py:238``: f32 sums in
    another order), at least 1e-6; a BatchNorm statistic's value within
    rtol 5e-4, atol 1e-6."""
    (gl, ga), gs = got
    (wl, wa), ws = want
    for k in wl:
        np.testing.assert_allclose(gl[k], wl[k], rtol=1e-4, atol=1e-7,
                                   err_msg=f"{what}: loss {k}")
    np.testing.assert_allclose(ga, wa, rtol=1e-5, err_msg=f"{what}: acc")
    assert sorted(gs) == sorted(ws)
    stat = [n for n in ws if n.endswith((".mean", ".var"))]
    delta = {n: (gs[n] - init[n].numpy(), ws[n].numpy() - init[n].numpy())
             for n in ws if n not in stat}
    gscale = max(float(np.abs(w).max()) for _, w in delta.values())
    for name, (g, w) in delta.items():
        np.testing.assert_allclose(g, w, rtol=rtol,
                                   atol=max(1e-4 * gscale, ATOL),
                                   err_msg=f"{what}: {name}")
    for name in stat:
        np.testing.assert_allclose(gs[name], ws[name].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{what}: {name}")


@pytest.fixture(scope="module")
def coo(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    cfg, trainer, state, graph, targets = _jax_setup(tmp)
    rng, lr = jax.random.PRNGKey(0), jnp.float32(LR)
    np_graph = _np(graph)
    np_targets = _np(targets)
    sd = _bridged(state.params, state.batch_stats)
    jax_ref = {"single": _jax_state_after(trainer._make_step(train=True)(
        state, graph, targets, rng, lr))}
    jl, ja = trainer._eval_step(state, graph, targets)
    jax_ref["eval_single"] = ({k: float(v) for k, v in jl.items()},
                              float(ja))
    args = (_port_config(cfg), np.asarray(trainer.class_weights),
            float(trainer.huber_delta), np_graph, np_targets, sd, LR)
    port = {}
    for world in (1, 2, 4):
        port[world] = run_world("dp_steps", world, tmp, *args, None,
                                str(tmp / f"port{world}"))
        if world == 1:
            continue
        mesh = make_mesh(world, graph_axis=1)
        dp = make_dp_train_step(trainer.model, trainer.optimizer,
                                cfg.training, trainer.class_weights,
                                trainer.huber_delta, mesh)
        jax_ref[world] = _jax_state_after(dp(
            state, shard_batch_pytree(graph, mesh),
            shard_batch_pytree(targets, mesh), rng, lr))
        if world == 2:
            ev = make_dp_eval_step(trainer.model, cfg.training,
                                   trainer.class_weights,
                                   trainer.huber_delta, mesh)
            el, ea = ev(state, shard_batch_pytree(graph, mesh),
                        shard_batch_pytree(targets, mesh))
            jax_ref["eval_2"] = ({k: float(v) for k, v in el.items()},
                                 float(ea))
    return jax_ref, port, sd


@pytest.mark.parametrize("world", [2, 4])
def test_coo_step_matches_jax_sharded_step(coo, world):
    jax_ref, port, init = coo
    for rank, res in enumerate(port[world]):
        _check_step(res["coo"], jax_ref[world], init,
                    f"world {world} rank {rank}")


@pytest.mark.parametrize("world", [1, 2, 4])
def test_coo_step_equals_the_single_device_step(coo, world):
    jax_ref, port, init = coo
    _check_step(port[world][0]["coo"], jax_ref["single"], init,
                f"world {world}")


def test_world_one_equals_the_trainer_step(coo):
    _, port, _ = coo
    (gl, ga), gs = port[1][0]["coo"]
    (tl, ta), ts = port[1][0]["trainer"]
    for k in tl:
        np.testing.assert_allclose(gl[k], tl[k], rtol=1e-6, err_msg=k)
    assert ga == ta
    for name in ts:
        np.testing.assert_allclose(gs[name], ts[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_eval_step_matches_jax(coo):
    jax_ref, port, _ = coo
    for res in port[2]:
        gl, ga = res["eval"]
        for ref in (jax_ref["eval_2"], jax_ref["eval_single"]):
            for k in ref[0]:
                np.testing.assert_allclose(gl[k], ref[0][k], rtol=1e-4,
                                           atol=1e-7, err_msg=k)
            np.testing.assert_allclose(ga, ref[1], rtol=1e-5)
