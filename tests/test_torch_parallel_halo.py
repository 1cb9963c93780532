"""PyTorch port vs JAX: the row-sharded grid model
(``bathymetric_gnn_tpu_torch/parallel/halo.py``) in gloo worlds of 2 and 4
processes (``torch_parallel_workers``).

``tests/test_halo.py``'s model and survey (hidden 16, 3 layers, 2 heads,
dropout 0; a 64 x 48 ramp with an interior hole, a hole across the shard
boundaries and an invalid first row; and the same ramp all valid), the
weights from the JAX model's init with random BatchNorm statistics
(``utils/weights``):

- ``make_sharded_grid_forward`` at world 2 and 4, overlapped and serial,
  against JAX's ``make_sharded_grid_forward`` on as many devices and
  against the single-card ``GridBathymetricGNN``: class logits,
  confidence and correction on valid cells within rtol 1e-3, atol 5e-4
  (``test_halo.py:57``); overlapped equals serial (1e-5 / 1e-6);
- train mode: the first BatchNorm's running mean after one sharded
  forward equals the single-card update (rtol 1e-4, atol 1e-6);
- ``make_halo_train_step`` at world 2 on a (1 x 2) and a (2 x 1) mesh
  (2 tiles of 32 x 48, one masked, CE weights 0.5 / 1.5 / 1.0, SGD and a
  clip no gradient reaches) against JAX's step on one device (which
  JAX's own ``test_halo.py::test_sharded_step_matches_single_device``
  holds equal to its sharded step; a second JAX step here would only
  add its ~20 s compile): losses rtol 1e-4, each parameter's change within rtol
  1e-3 and 1e-4 of the largest change (JAX's own criterion for its
  sharded halo step, ``test_halo.py:237-239``: the port's layer forms
  its attention dots as x @ (W @ a), JAX's XLA layer as (x @ W) . a; an
  element of the first BatchNorm's bias gradient differs by 0.6 % of
  itself at this size, the same on every mesh). The tiles' first and
  last rows are invalid: there the JAX halo
  model featurizes an empty halo and the port the survey's edge;
- that difference: on the all-valid grid the port's sharded forward
  equals the single-card model to 2e-6, JAX's differs at the border rows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from bathymetric_gnn_tpu.config.config import TrainingConfig
from bathymetric_gnn_tpu.data.graph_build import build_grid_inputs
from bathymetric_gnn_tpu.models.grid_gat import GridBathymetricGNN
from bathymetric_gnn_tpu.parallel.halo import (HaloGridGNN,
                                               make_halo_train_step,
                                               make_sharded_grid_forward)
from bathymetric_gnn_tpu.parallel.mesh import make_mesh
from bathymetric_gnn_tpu.training.trainer import TrainState
from bathymetric_gnn_tpu_torch.utils.weights import state_dict_from_flax
from jax.sharding import Mesh

from test_torch_parallel_dp import _check_step
from torch_parallel_workers import halo_case, halo_train_batch, run_world

KW = dict(hidden_channels=16, num_layers=3, heads=2, dropout=0.0)
CW = np.asarray([0.5, 1.5, 1.0], np.float32)
KEYS = ("class_logits", "confidence", "correction")


def jax_variables(model_cls, depth, valid, seed=0):
    """The JAX model's init with random running statistics."""
    feats, v, nbr, eattr, _ = build_grid_inputs(depth, valid)
    variables = jax.jit(model_cls(**KW).init)(jax.random.PRNGKey(seed),
                                              feats, v, nbr, eattr)
    rg = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, a: (np.asarray(a) + rg.normal(0, 0.1, a.shape)
                      if p[-1].key == "mean"
                      else np.asarray(a) * (1 + rg.random(a.shape))
                      ).astype(np.float32), variables["batch_stats"])
    return {"params": variables["params"], "batch_stats": stats}


def bridged(variables):
    return state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, variables["params"]),
        variables["batch_stats"], "grid")


def jax_step(step_fn, variables, batch, optimizer):
    state = TrainState(variables["params"], variables["batch_stats"],
                       optimizer.init(variables["params"]), jnp.int32(0))
    st, losses, acc = step_fn(state, jax.tree_util.tree_map(jnp.asarray,
                                                            batch),
                              jax.random.PRNGKey(3), jnp.float32(1.0))
    return (({k: float(v) for k, v in losses.items()}, float(acc)),
            bridged({"params": st.params, "batch_stats": st.batch_stats}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("halo")
    cases = [halo_case(), halo_case(masked=False)]
    variables = jax_variables(GridBathymetricGNN, *cases[0])
    sd = bridged(variables)
    single = []
    for d, v in cases:
        out = GridBathymetricGNN(**KW).apply(variables,
                                             *build_grid_inputs(d, v)[:4])
        single.append({k: np.asarray(out[k]) for k in KEYS})
    feats, v, nbr, eattr, _ = build_grid_inputs(*cases[0])
    _, upd = GridBathymetricGNN(**KW).apply(
        variables, feats, v, nbr, eattr, deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
    bn_mean = np.asarray(upd["batch_stats"]["MaskedBatchNorm_0"]["mean"])
    jax_sharded = {}
    for world in (2, 4):
        fwd = make_sharded_grid_forward(HaloGridGNN(**KW),
                                        make_mesh(world, graph_axis=world))
        jax_sharded[world] = {k: np.asarray(v[k]) for k in KEYS
                              for v in [fwd(variables, *cases[0])]}
        jax_sharded[world, "valid"] = np.asarray(
            fwd(variables, *cases[1])["class_logits"])

    batch = halo_train_batch(border=1)
    opt = optax.chain(optax.clip_by_global_norm(1e9),
                      optax.inject_hyperparams(optax.sgd)(learning_rate=1.0))
    step = jax_step(make_halo_train_step(
        HaloGridGNN(**KW), opt, TrainingConfig(), jnp.asarray(CW), 1.0,
        Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
             ("data", "graph"))), variables, batch, opt)
    port = {2: run_world("halo_world", 2, tmp, sd, KW, cases, (1, 2),
                         ("graph",), batch, CW, 1.0, [(1, 2), (2, 1)]),
            4: run_world("halo_forwards", 4, tmp, sd, KW, cases, (1, 4),
                         ("graph",))}
    return dict(cases=cases, single=single, bn_mean=bn_mean,
                jax_sharded=jax_sharded, step=step, port=port, init=sd)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("overlap", [True, False])
def test_sharded_forward_matches_jax(runs, world, overlap):
    valid = runs["cases"][0][1]
    for rank, res in enumerate(runs["port"][world]):
        got = res[overlap][0]
        for ref in (runs["jax_sharded"][world], runs["single"][0]):
            for k in KEYS:
                np.testing.assert_allclose(
                    got[k][valid], ref[k][valid], rtol=1e-3, atol=5e-4,
                    err_msg=f"rank {rank} {k}")
        assert got["class_logits"].shape == (64, 48, 3)


@pytest.mark.parametrize("world", [2, 4])
def test_all_valid_grid(runs, world):
    got = runs["port"][world][0][True][1]
    np.testing.assert_allclose(got["class_logits"],
                               runs["single"][1]["class_logits"],
                               rtol=1e-3, atol=5e-4)


@pytest.mark.parametrize("world", [2, 4])
def test_overlap_matches_serial(runs, world):
    res = runs["port"][world][0]
    for case in range(2):
        for k in KEYS:
            np.testing.assert_allclose(res[True][case][k],
                                       res[False][case][k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


@pytest.mark.parametrize("world", [2, 4])
def test_train_mode_batchnorm_global(runs, world):
    for res in runs["port"][world]:
        np.testing.assert_allclose(res["bn_mean"], runs["bn_mean"],
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("port_mesh", [(1, 2), (2, 1)])
def test_halo_train_step_matches_jax(runs, port_mesh):
    for rank, res in enumerate(runs["port"][2]):
        _check_step(res["steps"][port_mesh], runs["step"], runs["init"],
                    f"port {port_mesh} rank {rank}", rtol=1e-3)


@pytest.mark.parametrize("world", [2, 4])
def test_border_rows_equal_the_single_card_model(runs, world):
    """The port featurizes the survey's edge as the single-card model does
    (``HaloGridGNN._featurize``); JAX's halo model featurizes an empty
    halo there, which moves the border rows' outputs (ROADMAP queue 3)."""
    got = runs["port"][world][0][True][1]["class_logits"]
    want = runs["single"][1]["class_logits"]
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    jax_err = np.abs(runs["jax_sharded"][world, "valid"] - want
                     ).max(axis=(1, 2))
    # the border rows move, and through the 3 layers and the 5x5 window
    # their neighbours; rows 8 and more from the edge do not
    assert jax_err[[0, -1]].min() > 1e-5 and jax_err[8:-8].max() < 2e-6
