"""PyTorch port vs JAX: the row x col block-sharded grid model
(``bathymetric_gnn_tpu_torch/parallel/halo2d.py``) in a gloo world of 4
processes on a (1 x 2 x 2) ("data", "row", "col") mesh
(``torch_parallel_workers``).

``tests/test_halo2d.py``'s model and survey (hidden 16, 3 layers, 2 heads,
dropout 0; a 32 x 32 ramp with holes on both seams, and the same ramp all
valid), weights from the JAX model's init with random BatchNorm
statistics:

- ``make_sharded_grid2d_forward`` against JAX's on a 2 x 2 mesh and
  against the single-card ``GridBathymetricGNN`` on valid cells (rtol
  1e-3, atol 2e-3 masked, ``test_halo2d.py:59-62``; atol 5e-4 all valid),
  and the cells around the four-block corner, which need the diagonal
  block's cells, within 5e-4;
- ``exchange_halo_2d``'s corners: the all-valid grid's outputs equal the
  single-card model's to 2e-6 everywhere;
- train mode: the first BatchNorm's running mean after one sharded
  forward equals the single-card update;
- ``make_halo2d_train_step`` on the (1 x 2 x 2) mesh (one masked tile with
  its border rows and columns invalid, CE weights 0.5 / 1.5 / 1.0, SGD)
  against JAX's on a (1 x 1 x 1) mesh (which JAX's own
  ``test_halo2d.py::test_sharded_step_matches_unsharded_mesh`` holds
  equal to its (1 x 2 x 2) step), with ``test_torch_parallel_halo``'s
  tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

from bathymetric_gnn_tpu.config.config import TrainingConfig
from bathymetric_gnn_tpu.data.graph_build import build_grid_inputs
from bathymetric_gnn_tpu.models.grid_gat import GridBathymetricGNN
from bathymetric_gnn_tpu.parallel.halo2d import (
    HaloGrid2DGNN, make_halo2d_train_step, make_sharded_grid2d_forward)

from test_torch_parallel_dp import _check_step
from test_torch_parallel_halo import (CW, KEYS, KW, bridged, jax_step,
                                      jax_variables)
from torch_parallel_workers import halo2d_case, run_world


def mesh_2d(nr, nc):
    devs = np.asarray(jax.devices()[:nr * nc]).reshape(1, nr, nc)
    return Mesh(devs, ("data", "row", "col"))


def step_batch():
    """One masked 32 x 32 tile (``test_halo2d.py:125-134``) with its
    border rows and columns invalid."""
    rg = np.random.default_rng(0)
    depth, valid = halo2d_case()
    valid = valid.copy()
    valid[[0, -1]] = False
    valid[:, [0, -1]] = False
    depth = np.where(valid, depth, 0.0).astype(np.float32)
    labels = (rg.random(depth.shape) < 0.25).astype(np.int32) * 2
    raw = rg.normal(0, 0.1, depth.shape).astype(np.float32)
    return {"noisy": depth[None], "valid": valid[None],
            "labels": labels[None], "raw_correction": raw[None]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("halo2d")
    cases = [halo2d_case(), halo2d_case(masked=False)]
    variables = jax_variables(GridBathymetricGNN, *cases[0])
    sd = bridged(variables)
    single = [{k: np.asarray(v[k]) for k in KEYS} for v in (
        GridBathymetricGNN(**KW).apply(variables,
                                       *build_grid_inputs(d, v_)[:4])
        for d, v_ in cases)]
    feats, v, nbr, eattr, _ = build_grid_inputs(*cases[0])
    _, upd = GridBathymetricGNN(**KW).apply(
        variables, feats, v, nbr, eattr, deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(0)}, mutable=["batch_stats"])
    fwd = make_sharded_grid2d_forward(HaloGrid2DGNN(**KW), mesh_2d(2, 2))
    jax_sharded = {k: np.asarray(fwd(variables, *cases[0])[k])
                   for k in KEYS}
    batch = step_batch()
    opt = optax.chain(optax.clip_by_global_norm(1e9),
                      optax.inject_hyperparams(optax.sgd)(learning_rate=1.0))
    step = jax_step(make_halo2d_train_step(
        HaloGrid2DGNN(**KW), opt, TrainingConfig(), jnp.asarray(CW), 1.0,
        mesh_2d(1, 1)), variables, batch, opt)
    port = run_world("halo_world", 4, tmp, sd, KW, cases, (1, 2, 2),
                     ("row", "col"), batch, CW, 1.0, [(1, 2, 2)])
    return dict(cases=cases, single=single, jax_sharded=jax_sharded,
                bn_mean=np.asarray(
                    upd["batch_stats"]["MaskedBatchNorm_0"]["mean"]),
                step=step, port=port, init=sd)


def test_block_sharded_matches_jax(runs):
    valid = runs["cases"][0][1]
    for rank, res in enumerate(runs["port"]):
        got = res[False][0]
        assert got["class_logits"].shape == (32, 32, 3)
        for ref in (runs["jax_sharded"], runs["single"][0]):
            for k in KEYS:
                np.testing.assert_allclose(got[k][valid], ref[k][valid],
                                           rtol=1e-3, atol=2e-3,
                                           err_msg=f"rank {rank} {k}")


def test_corner_cells(runs):
    got = runs["port"][0][False][1]["class_logits"]
    want = runs["single"][1]["class_logits"]
    corner = np.s_[14:18, 14:18]
    np.testing.assert_allclose(got[corner], want[corner], rtol=1e-3,
                               atol=5e-4)
    # the port featurizes the survey's edge as the single-card model, so
    # the whole all-valid grid agrees, its border rows and columns too
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


def test_train_mode_batchnorm_global(runs):
    for res in runs["port"]:
        np.testing.assert_allclose(res["bn_mean"], runs["bn_mean"],
                                   rtol=1e-4, atol=1e-6)


def test_halo2d_train_step_matches_jax(runs):
    for rank, res in enumerate(runs["port"]):
        _check_step(res["steps"][(1, 2, 2)], runs["step"], runs["init"],
                    f"rank {rank}", rtol=1e-3)
