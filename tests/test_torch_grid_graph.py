"""PyTorch port vs JAX: grid-connectivity graphs (``GraphBuilder`` with
``knn_k == 0``, the large grids of the default VR route).

The port builds on the host with torch; JAX on its device with jit. Inputs
are made from numpy seeds. Integers (edges, masks, node rows and cols, ELL
slots) are compared exactly; node features and edge attributes within
rtol 1e-5 / atol 1e-5 (float32 on both sides, the same arithmetic order),
but the local std (feature channel 2 and ``local_std``) within atol 1e-4:
it is a difference of two window means that cancels in float32, where XLA
and torch differ by up to ~4e-5 on the same sums (the featurization
parity of ``test_torch_features`` and ``test_torch_knn_graph``).
"""

import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.config.config import (BucketConfig as JaxBucket,
                                               GraphConfig as JaxGraph)
from bathymetric_gnn_tpu.data.graph_build import GraphBuilder as JaxBuilder
from bathymetric_gnn_tpu.ops import edges as jax_edges
from bathymetric_gnn_tpu.ops import features as jax_features
from bathymetric_gnn_tpu.ops.ell import coo_to_ell as jax_coo_to_ell
from bathymetric_gnn_tpu_torch.config.config import BucketConfig, GraphConfig
from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
from bathymetric_gnn_tpu_torch.ops import edges, features
from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-5)
STD_TOL = dict(rtol=0, atol=1e-4)
STD_CHANNEL = 2


def _grid(seed, shape, holes=0.08):
    rg = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = (25.0 + rg.uniform(-5, 5) + 0.1 * xx - 0.07 * yy
             + rg.normal(0, 0.05, (h, w))).astype(np.float32)
    valid = rg.random((h, w)) >= holes
    depth[~valid] = np.nan
    unc = rg.uniform(0.1, 0.4, (h, w)).astype(np.float32)
    return depth, valid, unc


def _check(tg, jg):
    for f in ("edge_src", "edge_dst", "edge_mask", "node_mask", "graph_id"):
        np.testing.assert_array_equal(getattr(tg, f),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    np.testing.assert_array_equal(tg.pos, np.asarray(jg.pos))
    jx = np.asarray(jg.x)
    np.testing.assert_allclose(np.delete(tg.x, STD_CHANNEL, 1),
                               np.delete(jx, STD_CHANNEL, 1), **TOL)
    np.testing.assert_allclose(tg.x[:, STD_CHANNEL], jx[:, STD_CHANNEL],
                               **STD_TOL)
    np.testing.assert_allclose(tg.local_std, np.asarray(jg.local_std),
                               **STD_TOL)
    np.testing.assert_allclose(tg.edge_attr, np.asarray(jg.edge_attr), **TOL)


@pytest.mark.parametrize("connectivity,self_loops", [(4, False), (8, False),
                                                     (8, True)])
@pytest.mark.parametrize("shape,with_unc", [((80, 70), True),
                                            ((1, 40), False),
                                            ((23, 31), False)])
def test_grid_graph_matches_jax(connectivity, self_loops, shape, with_unc):
    """GraphBuilder(knn_k=0).build_graph and coo_to_ell of it against the
    JAX package's, on a grid with holes (and a one-cell-thin one)."""
    depth, valid, unc = _grid(sum(shape) + connectivity, shape)
    res = (1.5, 2.0)
    kw = dict(connectivity=connectivity, include_self_loops=self_loops,
              knn_k=0)
    jb = JaxBuilder(JaxGraph(**kw), JaxBucket()).build_graph(
        depth, valid, unc if with_unc else None, res)
    tb = GraphBuilder(GraphConfig(**kw), BucketConfig()).build_graph(
        depth, valid, unc if with_unc else None, res)
    assert tb.num_nodes == jb.num_nodes == int(valid.sum())
    assert tb.grid_shape == jb.grid_shape
    np.testing.assert_array_equal(tb.rows, np.asarray(jb.rows))
    np.testing.assert_array_equal(tb.cols, np.asarray(jb.cols))
    _check(tb.graph, jb.graph)
    vals = np.arange(tb.num_nodes, dtype=np.float32)
    np.testing.assert_array_equal(tb.graph_to_grid(vals),
                                  jb.graph_to_grid(vals))
    k = connectivity + self_loops
    je = jax_coo_to_ell(jb.graph, max_degree=k)
    te = coo_to_ell(tb.graph, max_degree=k)
    np.testing.assert_array_equal(te.nbr_src, np.asarray(je.nbr_src))
    np.testing.assert_array_equal(te.nbr_mask, np.asarray(je.nbr_mask))
    np.testing.assert_allclose(te.edge_attr, np.asarray(je.edge_attr), **TOL)


def test_pad_sizes_match_jax():
    for kw in (dict(connectivity=8), dict(connectivity=4),
               dict(connectivity=8, include_self_loops=True)):
        jb = JaxBuilder(JaxGraph(**kw), JaxBucket())
        tb = GraphBuilder(GraphConfig(**kw), BucketConfig())
        for n in (0, 1, 300, 4096, 4097, 262144):
            assert tb.pad_sizes(n) == jb.pad_sizes(n), (kw, n)


@pytest.mark.parametrize("dr,dc", [(-1, -1), (0, 1), (1, 0), (1, -1)])
def test_edge_functions_match_jax(dr, dc):
    """edge_features_for_offset, neighbor_valid_mask, enumerate_nodes,
    build_node_index_grid and compact_edges (with and without the sort)
    on one grid, against the JAX functions."""
    depth, valid, _ = _grid(20 + dr * 7 + dc, (17, 23))
    filled = np.nan_to_num(depth)
    res = (0.5, 2.0)
    np.testing.assert_allclose(
        features.edge_features_for_offset(torch.from_numpy(filled), dr, dc,
                                          res).numpy(),
        np.asarray(jax_features.edge_features_for_offset(filled, dr, dc,
                                                         res)), **TOL)
    tv = torch.from_numpy(valid)
    np.testing.assert_array_equal(
        edges.neighbor_valid_mask(tv, dr, dc).numpy(),
        np.asarray(jax_edges.neighbor_valid_mask(valid, dr, dc)))
    n_pad = 512
    t_nodes = edges.enumerate_nodes(tv, n_pad)
    j_nodes = jax_edges.enumerate_nodes(valid, n_pad)
    for a, b in zip(t_nodes, j_nodes):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        edges.build_node_index_grid(tv, *t_nodes).numpy(),
        np.asarray(jax_edges.build_node_index_grid(valid, *j_nodes)))
    t_coo = edges.enumerate_edges_coo(tv, *t_nodes, torch.from_numpy(filled),
                                      res, 8, True)
    j_coo = jax_edges.enumerate_edges_coo(valid, *j_nodes, filled, res, 8,
                                          True)
    for sort in (True, False):
        t_c = edges.compact_edges(*t_coo, 9 * n_pad, n_pad, sort_by_dst=sort)
        j_c = jax_edges.compact_edges(*j_coo, 9 * n_pad, n_pad,
                                      sort_by_dst=sort)
        for i, (a, b) in enumerate(zip(t_c, j_c)):
            if i == 2:
                np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
            else:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
