"""PyTorch port vs JAX: the slab-batched VR inputs (``data/slab_build``).

``pack_slab`` is compared array for array; ``build_slab_grid_inputs`` and
``build_slab_ell`` on the same packed slab: masks, neighbour slots and
node order exactly, features, edge attributes and the local std within
rtol 1e-5 / atol 1e-5, but the local std (feature channel 2) within atol
1e-4, the featurization parity of ``test_torch_features`` (a difference of
two window means that cancels in float32, where XLA and torch differ by up
to ~4e-5). The port's slab against the port's own per-grid builder mirrors
the JAX test ``test_slab_features_and_edges_match_per_grid`` at its
tolerances (rtol 1e-4 / atol 2e-5; edge attributes 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.data import slab_build as jsb
from bathymetric_gnn_tpu_torch.config.config import BucketConfig, GraphConfig
from bathymetric_gnn_tpu_torch.data import slab_build as tsb
from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder

torch.set_num_threads(2)

SLAB = 56
TOL = dict(rtol=1e-5, atol=1e-5)
STD_TOL = dict(rtol=0, atol=1e-4)
STD_CHANNEL = 2


def _grids(n, seed, with_unc):
    """Refinement-like grids: the slab's own size, a 3 x 3, a 2 x 56, then
    random sides 3..56, ~10 % NODATA, per-grid resolutions."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        h, w = {0: (SLAB, SLAB), 1: (3, 3), 2: (2, SLAB)}.get(
            i, tuple(rng.integers(3, SLAB + 1, 2)))
        depth = (20 + 0.2 * np.arange(w)[None, :] + 0.1 * np.arange(h)[:, None]
                 + rng.normal(0, 0.3, (h, w))).astype(np.float32)
        valid = rng.random((h, w)) > 0.1
        valid[h // 2, w // 2] = True
        depth[~valid] = np.nan
        unc = (rng.uniform(0.1, 0.5, (h, w)).astype(np.float32)
               if with_unc else None)
        res = (float(rng.uniform(0.5, 4)), float(rng.uniform(0.5, 4)))
        out.append((depth, valid, unc, res))
    return out


def _close_feats(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.delete(got, STD_CHANNEL, -1),
                               np.delete(want, STD_CHANNEL, -1), **TOL)
    np.testing.assert_allclose(got[..., STD_CHANNEL], want[..., STD_CHANNEL],
                               **STD_TOL)


@pytest.mark.parametrize("implicit_valid", [False, True])
@pytest.mark.parametrize("with_unc", [False, True])
def test_pack_slab_matches_jax(implicit_valid, with_unc):
    grids = _grids(7, 1, with_unc)
    got = tsb.pack_slab(grids, SLAB, 9, with_unc, implicit_valid)
    want = jsb.pack_slab(grids, SLAB, 9, with_unc, implicit_valid)
    for a, b in zip(got, want):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def _slab(grids, with_unc, implicit):
    depth, valid, unc, hs, ws, res = tsb.pack_slab(
        grids, SLAB, len(grids) + 1, with_unc, implicit)
    t = lambda a: None if a is None else torch.from_numpy(a)  # noqa: E731
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    args = (depth, valid, unc, hs, ws, res)
    return [t(a) for a in args], [j(a) for a in args]


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("with_unc", [False, True])
def test_slab_grid_inputs_match_jax(connectivity, with_unc):
    grids = _grids(6, 2 + connectivity, with_unc)
    targs, jargs = _slab(grids, with_unc, implicit=with_unc)
    kw = dict(connectivity=connectivity, with_uncertainty=with_unc,
              stats_window=5)
    got = tsb.build_slab_grid_inputs(*targs, **kw)
    want = jsb.build_slab_grid_inputs(*jargs, **kw)
    feats, valid, nbr, eattr, lstd = (g.numpy() for g in got)
    np.testing.assert_array_equal(valid, np.asarray(want[1]))
    np.testing.assert_array_equal(nbr, np.asarray(want[2]))
    _close_feats(feats, want[0])
    np.testing.assert_allclose(eattr, np.asarray(want[3]), **TOL)
    np.testing.assert_allclose(lstd, np.asarray(want[4]), **STD_TOL)


@pytest.mark.parametrize("connectivity", [4, 8])
@pytest.mark.parametrize("with_unc", [False, True])
def test_slab_ell_matches_jax(connectivity, with_unc):
    grids = _grids(6, 5 + connectivity, with_unc)
    n_pad = 1 << int(np.ceil(np.log2(sum(int(v.sum()) for _, v, _, _
                                         in grids) + 1)))
    targs, jargs = _slab(grids, with_unc, implicit=not with_unc)
    kw = dict(connectivity=connectivity, n_pad=n_pad,
              with_uncertainty=with_unc, stats_window=5)
    tg, tr, tc, tb = tsb.build_slab_ell(*targs, **kw)
    jg, jr, jc, jb = jsb.build_slab_ell(*jargs, **kw)
    for a, b in ((tr, jr), (tc, jc), (tb, jb)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for f in ("nbr_src", "nbr_mask", "node_mask", "graph_id", "pos"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    _close_feats(tg.x.numpy(), jg.x)
    np.testing.assert_allclose(tg.edge_attr.numpy(), np.asarray(jg.edge_attr),
                               **TOL)
    np.testing.assert_allclose(tg.local_std.numpy(), np.asarray(jg.local_std),
                               **STD_TOL)
    # the host's flat indices give the same graph
    lin = np.concatenate([
        i * SLAB * SLAB + np.ravel_multi_index(np.nonzero(v), (SLAB, SLAB))
        for i, (_, v, _, _) in enumerate(grids)])
    tg2, *_ = tsb.build_slab_ell(*targs, **kw, lin=torch.from_numpy(lin))
    for f in ("x", "nbr_src", "nbr_mask", "edge_attr", "local_std"):
        assert torch.equal(getattr(tg2, f), getattr(tg, f)), f


@pytest.mark.parametrize("connectivity", [4, 8])
def test_slab_features_and_edges_match_per_grid(connectivity):
    """The port's slab ELL against the port's per-grid grid-connectivity
    builder, grid by grid: features (the border fixups included), local
    std, and the directed edge sets with their attributes."""
    grids = _grids(6, 0, False)
    n_total = sum(int(v.sum()) for _, v, _, _ in grids)
    n_pad = 1 << int(np.ceil(np.log2(n_total + 1)))
    targs, _ = _slab(grids, False, implicit=False)
    g, _, _, _ = tsb.build_slab_ell(*targs, connectivity=connectivity,
                                    n_pad=n_pad, with_uncertainty=False)
    x, lstd = g.x.numpy(), g.local_std.numpy()
    nbr_src, nbr_mask = g.nbr_src.numpy(), g.nbr_mask.numpy()
    eattr = g.edge_attr.numpy()
    gb = GraphBuilder(GraphConfig(connectivity=connectivity),
                      BucketConfig(node_buckets=(64, 256, 1024, 4096)))
    offset = 0
    for depth_i, valid_i, _, res_i in grids:
        n = int(valid_i.sum())
        bg = gb.build_graph(depth_i, valid_i, None, res_i)
        np.testing.assert_allclose(x[offset:offset + n], bg.graph.x[:n],
                                   rtol=1e-4, atol=2e-5)
        np.testing.assert_allclose(lstd[offset:offset + n],
                                   bg.graph.local_std[:n], rtol=1e-4,
                                   atol=2e-5)
        em = bg.graph.edge_mask
        ref = {(int(s), int(d)): a for s, d, a in zip(
            bg.graph.edge_src[em], bg.graph.edge_dst[em],
            bg.graph.edge_attr[em])}
        got = {}
        for ni in range(offset, offset + n):
            for k in np.nonzero(nbr_mask[ni])[0]:
                got[(int(nbr_src[ni, k]) - offset, ni - offset)] = eattr[ni, k]
        assert set(got) == set(ref)
        for key, a in got.items():
            np.testing.assert_allclose(a, ref[key], rtol=1e-4, atol=1e-4)
        offset += n
