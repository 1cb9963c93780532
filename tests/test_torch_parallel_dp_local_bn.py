"""PyTorch port vs JAX: the data-parallel train steps with ``exact=False``
(local BatchNorm: each rank's BatchNorm moments and loss normalization
over its own nodes, the gradients averaged) in gloo worlds of 1, 2 and 4
processes (``torch_parallel_workers.dp_modes``).

``test_torch_parallel_dp``'s COO batch (8 tiles of 48 from two 96^2 ramps,
hidden 8, 2 layers, 2 heads, dropout 0, SGD, the weights carried across by
``utils/weights``) and ``test_torch_parallel_dp_knn``'s k-NN batch (4
tiles of 40, 2 shards of unequal spill counts, routes C and D):

- the COO step at world 2 and 4 against JAX's ``make_dp_train_step(...,
  exact=False)`` on 2 and 4 virtual devices, and the k-NN step at world 2
  against JAX's ``make_dp_sparse_train_step(..., exact=False)``, with the
  ``exact=True`` tests' tolerances (losses rtol 1e-4; parameters and
  BatchNorm statistics rtol 5e-4, atol 1e-6);
- at world 1 ``exact=False`` equals ``exact=True`` bit for bit;
- at world 2 the flag acts: the BatchNorm running statistics and the
  losses of the two modes differ by more than 10x those tolerances.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bathymetric_gnn_tpu.models.gnn_ell import make_ell_model
from bathymetric_gnn_tpu.ops.ell import coo_to_ell
from bathymetric_gnn_tpu.ops.ell_banded import band_ell
from bathymetric_gnn_tpu.ops.graph import merge_stacked
from bathymetric_gnn_tpu.parallel.data_parallel import (
    make_dp_sparse_train_step, make_dp_train_step, stack_banded_batches)
from bathymetric_gnn_tpu.parallel.mesh import make_mesh, shard_batch_pytree
from bathymetric_gnn_tpu_torch.ops import ell as port_ell
from bathymetric_gnn_tpu_torch.ops import ell_banded as port_banded
from bathymetric_gnn_tpu_torch.ops import graph as port_graph

from test_torch_parallel_dp import (ATOL, LR, RTOL, _bridged, _check_step,
                                    _jax_setup, _jax_state_after, _np,
                                    _port_config)
from torch_parallel_workers import run_world

KNN_SHARDS, KNN_PER_SHARD = 2, 2
LOSS_RTOL = 1e-4


def _take(tree, i, per):
    return jax.tree.map(lambda a: a[i * per:(i + 1) * per], tree)


def _knn_pairs(graph, n_shards, per_shard):
    """JAX's and the port's (EllGraph, BandedEll) of each shard's merged
    tiles (``test_torch_parallel_dp_knn``'s decomposition)."""
    pairs, port_pairs = [], []
    for i in range(n_shards):
        part = _take(graph, i, per_shard)
        g = coo_to_ell(merge_stacked(part), max_degree=8)
        pairs.append((g, band_ell(g, band_rows=128, s_max=256,
                                  spill_pad=65536)))
        pg = port_ell.coo_to_ell(port_graph.merge_stacked(_np(part)),
                                 max_degree=8)
        port_pairs.append((pg.with_src_sorted_slots(),
                           port_banded.band_ell(pg, band_rows=128, s_max=256,
                                                spill_pad=65536, heads=2)))
    return pairs, port_pairs


def compute(tmp):
    """(JAX's exact=False steps by world, the port's results by world: a
    list of jobs, each {exact: dp_steps result}, the initial weights)."""
    rng, lr = jax.random.PRNGKey(0), jnp.float32(LR)
    cfg, trainer, state, graph, targets = _jax_setup(tmp)
    sd = _bridged(state.params, state.batch_stats)
    coo_job = (_port_config(cfg), np.asarray(trainer.class_weights),
               float(trainer.huber_delta), _np(graph), _np(targets), sd, LR,
               None, str(tmp / "port_coo"))
    want = {}
    for world in (2, 4):
        mesh = make_mesh(world, graph_axis=1)
        dp = make_dp_train_step(trainer.model, trainer.optimizer,
                                cfg.training, trainer.class_weights,
                                trainer.huber_delta, mesh, exact=False)
        want[("coo", world)] = _jax_state_after(dp(
            state, shard_batch_pytree(graph, mesh),
            shard_batch_pytree(targets, mesh), rng, lr))

    kcfg, ktr, kstate, kgraph, ktargets = _jax_setup(
        tmp / "knn", knn=True, batch=KNN_SHARDS * KNN_PER_SHARD)
    ksd = _bridged(kstate.params, kstate.batch_stats)
    pairs, port_pairs = _knn_pairs(kgraph, KNN_SHARDS, KNN_PER_SHARD)
    _, port_whole = _knn_pairs(kgraph, 1, KNN_SHARDS * KNN_PER_SHARD)
    g_st, b_st = stack_banded_batches(pairs)
    t_st = jax.tree.map(
        lambda a: a.reshape((KNN_SHARDS, KNN_PER_SHARD) + a.shape[1:]),
        ktargets)
    ell_model = make_ell_model(kcfg.model, in_channels=7, edge_dim=3,
                               sparse_kernel="banded_pallas")
    dp = make_dp_sparse_train_step(ell_model, ktr.optimizer, kcfg.training,
                                   ktr.class_weights, ktr.huber_delta,
                                   make_mesh(KNN_SHARDS, graph_axis=1),
                                   exact=False)
    want[("knn", 2)] = _jax_state_after(dp(kstate, g_st, b_st, t_st, rng,
                                           lr))

    def knn_job(port_pairs):
        return (_port_config(kcfg), np.asarray(ktr.class_weights),
                float(ktr.huber_delta), None, None, ksd, LR,
                (port_pairs, _np(ktargets)), str(tmp / "port_knn"))

    port = {1: run_world("dp_modes", 1, tmp, [coo_job,
                                              knn_job(port_whole)]),
            2: run_world("dp_modes", 2, tmp, [coo_job, knn_job(port_pairs)]),
            4: run_world("dp_modes", 4, tmp, [coo_job])}
    return want, port, {"coo": sd, "knn": ksd}


@pytest.fixture(scope="module")
def local_bn(tmp_path_factory):
    return compute(tmp_path_factory.mktemp("dp_local_bn"))


@pytest.mark.parametrize("world", [2, 4])
def test_coo_local_bn_step_matches_jax(local_bn, world):
    want, port, init = local_bn
    for rank, res in enumerate(port[world]):
        _check_step(res[0][False]["coo"], want[("coo", world)], init["coo"],
                    f"world {world} rank {rank}")


@pytest.mark.parametrize("route", ["C", "D"])
def test_sparse_local_bn_step_matches_jax(local_bn, route):
    want, port, init = local_bn
    for rank, res in enumerate(port[2]):
        _check_step(res[1][False][f"sparse_{route}"], want[("knn", 2)],
                    init["knn"], f"route {route} rank {rank}")


@pytest.mark.parametrize("key", ["coo", "sparse_C", "sparse_D"])
def test_world_one_local_bn_equals_exact_bit_for_bit(local_bn, key):
    _, port, _ = local_bn
    res = port[1][0][0 if key == "coo" else 1]
    (gl, ga), gs = res[False][key]
    (wl, wa), ws = res[True][key]
    assert gl == wl and ga == wa
    assert sorted(gs) == sorted(ws)
    for name in ws:
        np.testing.assert_array_equal(gs[name], ws[name], err_msg=name)


@pytest.mark.parametrize("key", ["coo", "sparse_C", "sparse_D"])
def test_world_two_local_bn_differs_from_exact(local_bn, key):
    """At world 2 the two modes differ by more than 10x the parity tests'
    tolerances: in a BatchNorm running statistic (rtol 5e-4, atol 1e-6)
    and in a loss (rtol 1e-4)."""
    _, port, _ = local_bn
    for rank, res in enumerate(port[2]):
        job = res[0 if key == "coo" else 1]
        (ll, _), ls = job[False][key]
        (el, _), es = job[True][key]
        stat = [n for n in es if n.endswith((".mean", ".var"))]
        assert stat
        stat_x = max(float(np.max(np.abs(ls[n] - es[n])
                                  / (ATOL + RTOL * np.abs(es[n]))))
                     for n in stat)
        loss_x = max(abs(ll[k] - el[k]) / (LOSS_RTOL * abs(el[k]) + 1e-7)
                     for k in el)
        assert stat_x > 10 and loss_x > 10, (rank, stat_x, loss_x)
