"""PyTorch port vs JAX: the k-NN graph path on the host.

The port's native graph kit (built from ``native/graphkit.cpp`` into
``build/torch_kernels/``), Hilbert order, ``GraphBuilder(knn_k=8)``,
``batch_graphs`` and ``coo_to_ell`` against the JAX package's, on inputs
made from numpy seeds. Everything integer (edges, node order, ELL slots) is
compared exactly; node features within the featurization parity of
``test_torch_features`` (float32 on both sides, atol 2e-5; local std
1e-4); edge attributes, computed by the same NumPy code from the same
positions and depths, within 1e-6.
"""

import ctypes
import fcntl
import os
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu import native as jax_native
from bathymetric_gnn_tpu.config.config import (BucketConfig as JaxBucket,
                                               GraphConfig as JaxGraph)
from bathymetric_gnn_tpu.data.graph_build import GraphBuilder as JaxBuilder
from bathymetric_gnn_tpu.ops import edges as jax_edges
from bathymetric_gnn_tpu.ops.ell import coo_to_ell as jax_coo_to_ell
from bathymetric_gnn_tpu.ops.graph import batch_graphs as jax_batch_graphs
from bathymetric_gnn_tpu_torch import native
from bathymetric_gnn_tpu_torch.config.config import BucketConfig, GraphConfig
from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
from bathymetric_gnn_tpu_torch.ops import edges
from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell
from bathymetric_gnn_tpu_torch.ops.graph import batch_graphs

torch.set_num_threads(2)

STD_CHANNEL = 2
ROOT = Path(__file__).resolve().parents[1]


def _loads(so: Path) -> bool:
    try:
        ctypes.CDLL(str(so))
        return True
    except OSError:
        return False


def ensure_jax_native_kit():
    """Make sure the JAX package's k-NN runs on its native graph kit, not
    on its NumPy fallback (which breaks distance ties differently).

    The JAX loader builds ``libgraphkit.so`` on first use with
    ``native/build.sh``, which has g++ write straight into the final path,
    and caches a failed build or load per process. Under several test
    workers one worker can read the file while another writes it. So,
    under a file lock in ``build/``: where the library is missing or does
    not load, compile ``native/graphkit.cpp`` with ``build.sh``'s flags
    into a temporary file beside it and move it into place atomically;
    then reset the loader's cache and load it, retrying briefly while
    another process may still be rewriting the file."""
    so = ROOT / "bathymetric_gnn_tpu" / "native" / "libgraphkit.so"
    lock = ROOT / "build" / "jax_graphkit.lock"
    lock.parent.mkdir(exist_ok=True)
    with open(lock, "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            if not (so.exists() and _loads(so)):
                fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
                os.close(fd)
                try:
                    subprocess.run(
                        ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                         "-o", tmp, str(ROOT / "native" / "graphkit.cpp"),
                         "-lpthread"], check=True, capture_output=True,
                        timeout=300)
                    os.replace(tmp, so)
                finally:
                    if os.path.exists(tmp):
                        os.unlink(tmp)
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)
    for _ in range(10):
        jax_native._LIB, jax_native._TRIED = None, False
        if jax_native._load() is not None:
            break
        time.sleep(0.5)
    assert jax_native.native_available(), "JAX graph kit did not load"


# Every test worker imports this module while it collects, before any test
# of any file runs: the library is whole on disk (and loads) before any JAX
# k-NN can reach the loader's in-place ``native/build.sh`` or cache a
# failed load. The fixtures and tests call it again (cheap once built).
ensure_jax_native_kit()


def _cloud(seed=0, n=1500):
    return (np.random.default_rng(seed).random((n, 2)) * 100.0
            ).astype(np.float32)


def _grid_with_holes(h=40, w=33, seed=1):
    """Valid-cell coordinates of a grid with ~10 % holes: every interior
    cell has 4 candidates at distance 1, 4 at sqrt(2) and 4 at 2."""
    valid = np.random.default_rng(seed).random((h, w)) > 0.1
    rows, cols = np.nonzero(valid)
    return np.stack([cols, rows], -1).astype(np.float32)


def _refinement(seed, shape, holes=0.05):
    rg = np.random.default_rng(seed)
    h, w = shape
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = (20.0 + rg.uniform(-5, 5) + 0.1 * xx + 0.05 * yy
             + rg.normal(0, 0.05, (h, w))).astype(np.float32)
    valid = rg.random((h, w)) >= holes
    depth[~valid] = np.nan
    unc = rg.uniform(0.1, 0.4, (h, w)).astype(np.float32)
    return depth, valid, unc


@pytest.mark.parametrize("points", ["cloud", "grid_ties"])
@pytest.mark.parametrize("k", [8, 16])
def test_knn2d_matches_jax(points, k):
    pos = _cloud() if points == "cloud" else _grid_with_holes()
    ensure_jax_native_kit()
    want = jax_native.knn2d(pos, k)
    got = native.knn2d(pos, k)
    np.testing.assert_array_equal(got, want)


def test_knn2d_numpy_keeps_the_same_distances():
    """The named NumPy version finds the same neighbour distances; only
    the choice among equal distances may differ."""
    pos = _grid_with_holes()
    a, b = native.knn2d(pos, 8), native.knn2d_numpy(pos, 8)

    def dist(nb):
        return np.sort(((pos[nb] - pos[:, None]) ** 2).sum(-1), axis=1)

    np.testing.assert_array_equal(dist(a), dist(b))


def test_ell_pack_matches_jax():
    rg = np.random.default_rng(2)
    dst = np.sort(rg.integers(0, 300, 2000)).astype(np.int32)
    src = rg.integers(0, 300, 2000).astype(np.int32)
    ensure_jax_native_kit()
    want = jax_native.ell_pack(src, dst, 300, 6)
    got = native.ell_pack(src, dst, 300, 6)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


@pytest.mark.parametrize("points", ["cloud", "grid_ties"])
def test_hilbert_and_morton_order_match_jax(points):
    pos = _cloud(3) if points == "cloud" else _grid_with_holes(seed=4)
    np.testing.assert_array_equal(edges.hilbert_order(pos),
                                  jax_edges.hilbert_order(pos))
    np.testing.assert_array_equal(edges.morton_order(pos),
                                  jax_edges.morton_order(pos))
    np.testing.assert_array_equal(edges.knn_edges(pos, 8),
                                  jax_edges.knn_edges(pos, 8))


def _check_graph(tg, jg):
    for f in ("edge_src", "edge_dst", "edge_mask", "node_mask"):
        np.testing.assert_array_equal(getattr(tg, f), np.asarray(
            getattr(jg, f)), err_msg=f)
    jx = np.asarray(jg.x)
    np.testing.assert_allclose(tg.x[:, STD_CHANNEL], jx[:, STD_CHANNEL],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(tg.x, jx, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(np.delete(tg.x, STD_CHANNEL, 1),
                               np.delete(jx, STD_CHANNEL, 1), rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_allclose(tg.edge_attr, np.asarray(jg.edge_attr),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg.local_std, np.asarray(jg.local_std),
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(tg.pos, np.asarray(jg.pos))


@pytest.mark.parametrize("shape,with_unc", [((40, 37), True), ((3, 5), False),
                                            ((50, 50), True)])
def test_graph_builder_knn_matches_jax(shape, with_unc):
    depth, valid, unc = _refinement(sum(shape), shape)
    res = (1.5, 2.0)
    ensure_jax_native_kit()
    jb = JaxBuilder(JaxGraph(knn_k=8), JaxBucket()).build_graph(
        depth, valid, unc if with_unc else None, res)
    tb = GraphBuilder(GraphConfig(knn_k=8), BucketConfig()).build_graph(
        depth, valid, unc if with_unc else None, res)
    assert tb.num_nodes == jb.num_nodes == int(valid.sum())
    np.testing.assert_array_equal(tb.rows, jb.rows)
    np.testing.assert_array_equal(tb.cols, jb.cols)
    np.testing.assert_array_equal(tb.perm, jb.perm)
    _check_graph(tb.graph, jb.graph)
    vals = np.arange(tb.num_nodes, dtype=np.float32)
    np.testing.assert_array_equal(tb.graph_to_grid(vals),
                                  jb.graph_to_grid(vals))


def test_grid_connectivity_branch_raises():
    depth, valid, _ = _refinement(0, (8, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        GraphBuilder(GraphConfig(knn_k=0)).build_graph(depth, valid)


def test_batch_graphs_and_coo_to_ell_match_jax():
    """A batch of refinement graphs (one of a single node, one of two, so
    with isolated nodes and fewer than K live slots) packed by both
    packages, then converted to ELL of width 8."""
    ensure_jax_native_kit()
    builders = (JaxBuilder(JaxGraph(knn_k=8), JaxBucket()),
                GraphBuilder(GraphConfig(knn_k=8), BucketConfig()))
    shapes = [(12, 9), (1, 1), (1, 2), (30, 21), (5, 5)]
    packed = []
    for b in builders:
        graphs, stds = [], []
        for i, shape in enumerate(shapes):
            depth, valid, unc = _refinement(10 + i, shape, holes=0.0)
            g = b.build_graph(depth, valid, unc, (1.0, 1.0))
            n = g.num_nodes
            gr = g.graph
            em = np.asarray(gr.edge_mask)
            graphs.append((np.asarray(gr.x)[:n],
                           np.stack([np.asarray(gr.edge_src),
                                     np.asarray(gr.edge_dst)])[:, em],
                           np.asarray(gr.edge_attr)[em]))
            stds.append(np.asarray(gr.local_std)[:n])
        packed.append((graphs, stds))
    jg, jc = jax_batch_graphs(packed[0][0], n_pad=2048, e_pad=2048 * 8,
                              local_std_list=packed[0][1])
    tg, tc = batch_graphs(packed[1][0], n_pad=2048, e_pad=2048 * 8,
                          local_std_list=packed[1][1])
    np.testing.assert_array_equal(tc, jc)
    _check_graph(tg, jg)
    np.testing.assert_array_equal(tg.graph_id, np.asarray(jg.graph_id))
    je, te = jax_coo_to_ell(jg, max_degree=8), coo_to_ell(tg, max_degree=8)
    np.testing.assert_array_equal(te.nbr_src, np.asarray(je.nbr_src))
    np.testing.assert_array_equal(te.nbr_mask, np.asarray(je.nbr_mask))
    np.testing.assert_allclose(te.edge_attr, np.asarray(je.edge_attr),
                               rtol=0, atol=1e-6)
    deg = te.nbr_mask.sum(1)
    assert (deg[:tc.sum()] == 0).any() and ((deg > 0) & (deg < 8)).any()
    dev = te.to("cpu")
    assert dev.nbr_src.dtype == torch.int32 and dev.nbr_mask.dtype == torch.bool
