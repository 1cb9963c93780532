"""PyTorch port vs JAX: the data-parallel k-NN train step
(``parallel/data_parallel.make_dp_sparse_train_step``) in a gloo world of
2 processes (``torch_parallel_workers``).

``test_data_parallel``'s k-NN batch (4 tiles of 40 from two 80^2 ramps,
node bucket 2048, k 8, hidden 8, 2 layers, 2 heads, dropout 0), with a
hole in the first ramp, split into 2 shards of 2 tiles whose spill counts
differ, from the same weights
with SGD and a clip norm no gradient reaches: the ``"banded_pallas"``
model's step on its default route C and on route D (``wide_kernel`` off)
against JAX's ``make_dp_sparse_train_step`` with ``s_max=256``,
``spill_pad=65536`` (``stack_banded_batches``), with ``test_torch_parallel_dp``'s
tolerances.
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
    make_dp_sparse_train_step, stack_banded_batches)
from bathymetric_gnn_tpu.parallel.mesh import make_mesh
from bathymetric_gnn_tpu_torch.ops import ell as port_ell
from bathymetric_gnn_tpu_torch.ops import ell_banded as port_banded
from bathymetric_gnn_tpu_torch.ops import graph as port_graph

from test_torch_parallel_dp import (LR, _bridged, _check_step, _jax_setup,
                                    _jax_state_after, _np, _port_config)
from torch_parallel_workers import run_world


@pytest.fixture(scope="module")
def knn(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_knn")
    n_shards, per_shard = 2, 2
    cfg, trainer, state, graph, targets = _jax_setup(
        tmp, knn=True, batch=n_shards * per_shard)

    def take(tree, i):
        return jax.tree.map(lambda a: a[i * per_shard:(i + 1) * per_shard],
                            tree)

    pairs, port_pairs, spills = [], [], []
    for i in range(n_shards):
        merged = merge_stacked(take(graph, i))
        g = coo_to_ell(merged, max_degree=8)
        pairs.append((g, band_ell(g, band_rows=128, s_max=256,
                                  spill_pad=65536)))
        pg = port_ell.coo_to_ell(port_graph.merge_stacked(
            _np(take(graph, i))), max_degree=8)
        pb = port_banded.band_ell(pg, band_rows=128, s_max=256,
                                  spill_pad=65536, heads=2)
        port_pairs.append((pg.with_src_sorted_slots(), pb))
        spills.append(int(np.asarray(pb.spill_mask).sum()))
    g_st, b_st = stack_banded_batches(pairs)
    t_st = jax.tree.map(
        lambda a: a.reshape((n_shards, per_shard) + a.shape[1:]), targets)
    mesh = make_mesh(n_shards, graph_axis=1)
    ell_model = make_ell_model(cfg.model, in_channels=7, edge_dim=3,
                               sparse_kernel="banded_pallas")
    dp = make_dp_sparse_train_step(ell_model, trainer.optimizer,
                                   cfg.training, trainer.class_weights,
                                   trainer.huber_delta, mesh)
    want = _jax_state_after(dp(state, g_st, b_st, t_st,
                               jax.random.PRNGKey(0), jnp.float32(LR)))
    sd = _bridged(state.params, state.batch_stats)
    port = run_world("dp_steps", n_shards, tmp, _port_config(cfg),
                     np.asarray(trainer.class_weights),
                     float(trainer.huber_delta), _np(graph), _np(targets),
                     sd, LR, (port_pairs, _np(targets)), str(tmp / "port"))
    return want, port, spills, sd


def test_sparse_shards_have_unequal_spill_counts(knn):
    spills = knn[2]
    assert spills[0] != spills[1], spills


@pytest.mark.parametrize("route", ["C", "D"])
def test_sparse_step_matches_jax(knn, route):
    want, port, _, init = knn
    for rank, res in enumerate(port):
        _check_step(res[f"sparse_{route}"], want, init,
                    f"route {route} rank {rank}")
