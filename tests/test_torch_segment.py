"""PyTorch port vs JAX: the COO segment ops and the COO edge tables.

``ops/segment``'s gather, segment_sum, segment_mean, segment_max and
segment_softmax (CPU: kernel F's plain ``index_add_`` version behind the
sums) against ``bathymetric_gnn_tpu/ops/segment.py`` on the same seeded
NumPy inputs: a destination-sorted padded edge list with empty segments,
masked edges and pads at N - 1, with and without self logits, over the
tables of ``CooGraph.from_padded`` / ``sorted_segments`` and with int32 or
int64 segment ids (atol 1e-6); ``csr_row_offsets`` equals JAX's; and the
gradients of
the ``segment_sum`` / ``gather`` autograd Functions equal autograd of
plain torch (``index_add_`` and indexing).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.ops import graph as jgraph
from bathymetric_gnn_tpu.ops import segment as jseg
from bathymetric_gnn_tpu_torch.ops import segment as seg
from bathymetric_gnn_tpu_torch.ops.graph import (CooGraph, csr_row_offsets,
                                                 make_padded_graph,
                                                 sorted_segments)

N, E_LIVE, E_PAD = 37, 150, 200
ATOL = 1e-6


def _graph(seed=0):
    """A padded graph: E_LIVE live edges sorted by destination (nodes
    3, 10 and 36 receive none, node 20 sends none), pads at N - 1."""
    rg = np.random.default_rng(seed)
    dst_pool = np.setdiff1d(np.arange(N - 1), [3, 10])
    src_pool = np.setdiff1d(np.arange(N), [20])
    ei = np.stack([rg.choice(src_pool, E_LIVE), rg.choice(dst_pool, E_LIVE)])
    x = rg.normal(size=(N - 2, 4)).astype(np.float32)
    return make_padded_graph(x, ei, rg.normal(size=(E_LIVE, 3)).astype(
        np.float32), n_pad=N, e_pad=E_PAD)


@pytest.fixture(scope="module")
def case():
    g = _graph()
    rg = np.random.default_rng(1)
    data = {shape: rg.normal(size=(E_PAD,) + shape).astype(np.float32) * 3
            for shape in [(), (5,), (3, 4)]}
    # one live entry is masked out beside the pads
    mask = np.asarray(g.edge_mask).copy()
    mask[17] = False
    return g, data, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _tables(g, mask):
    p = dict(vars(g))
    p["edge_mask"] = mask
    c = CooGraph.from_padded(type(g)(**p)).to("cpu")
    return c.dst_table, c.src_table


def _all_entries(ids):
    """The table of every entry of ids (no mask) as tensors."""
    ids = np.asarray(ids)
    return tuple(_t(a) for a in sorted_segments(
        ids, np.ones(ids.shape, bool), N))


@pytest.mark.parametrize("shape", [(), (5,), (3, 4)])
@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("ids_dtype", [torch.int32, torch.int64])
def test_segment_sum_mean_max_match_jax(case, shape, masked, ids_dtype):
    g, data, mask = case
    d = data[shape]
    m = mask if masked else None
    table = _tables(g, mask)[0] if masked else _all_entries(g.edge_dst)
    ids = jnp.asarray(g.edge_dst)
    tids = _t(g.edge_dst).to(ids_dtype)
    tm = None if m is None else _t(m)
    for name in ("segment_sum", "segment_mean"):
        want = getattr(jseg, name)(jnp.asarray(d), ids, N,
                                   None if m is None else jnp.asarray(m))
        got = getattr(seg, name)(_t(d), tids, N, tm, table)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=1e-6, err_msg=name)
    want = jseg.segment_max(jnp.asarray(d), ids, N,
                            None if m is None else jnp.asarray(m))
    got = seg.segment_max(_t(d), tids, N, tm)
    # empty segments hold -inf in both
    np.testing.assert_array_equal(np.isinf(got.numpy()),
                                  np.isinf(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    for j in (3, 10):
        assert np.isneginf(got.numpy()[j]).all()


@pytest.mark.parametrize("shape", [(), (3,)])
@pytest.mark.parametrize("with_self", [True, False])
@pytest.mark.parametrize("masked", [True, False])
def test_segment_softmax_matches_jax(case, shape, with_self, masked):
    g, data, mask = case
    d = data[(5,)][:, :shape[0]] if shape else data[()]
    rg = np.random.default_rng(2)
    self_l = rg.normal(size=(N,) + shape).astype(np.float32) * 3 \
        if with_self else None
    m = mask if masked else None
    w_j, ws_j = jseg.segment_softmax(
        jnp.asarray(d), jnp.asarray(g.edge_dst), N,
        None if m is None else jnp.asarray(m),
        None if self_l is None else jnp.asarray(self_l))
    table = _tables(g, mask)[0] if masked else _all_entries(g.edge_dst)
    w, ws = seg.segment_softmax(
        _t(d), _t(g.edge_dst), N, None if m is None else _t(m),
        None if self_l is None else _t(self_l), table)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), atol=ATOL)
    if with_self:
        np.testing.assert_allclose(ws.numpy(), np.asarray(ws_j), atol=ATOL)
        # an empty segment's self weight is 1
        np.testing.assert_allclose(ws.numpy()[[3, 10]], 1.0, atol=ATOL)
    else:
        assert ws is None and ws_j is None
    if masked:
        assert (w.numpy()[~mask] == 0).all()


def test_masked_entries_add_exactly_zero(case):
    """NaN in masked entries never reaches a sum (selected out, never
    multiplied)."""
    g, data, mask = case
    d = data[(5,)].copy()
    d[~mask] = np.nan
    dtab = _tables(g, mask)[0]
    got = seg.segment_sum(_t(d), _t(g.edge_dst), N, _t(mask), dtab)
    assert np.isfinite(got.numpy()).all()
    w, _ = seg.segment_softmax(_t(d[:, 0] * 1e4), _t(g.edge_dst), N,
                               _t(mask), _t(np.zeros(N, np.float32)), dtab)
    assert np.isfinite(w.numpy()).all()


def test_gather_and_tables(case):
    g, data, mask = case
    x = np.random.default_rng(3).normal(size=(N, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        seg.gather(_t(x), _t(g.edge_src), None).numpy(),
        np.asarray(jseg.gather(jnp.asarray(x), jnp.asarray(g.edge_src))))
    c = CooGraph.from_padded(g)
    # the destination table: the live edges in order, CSR by destination
    # (sorted_segments of the destination-sorted edges)
    live = np.asarray(g.edge_mask)
    np.testing.assert_array_equal(c.dst_perm[:c.dst_row_ptr[N]],
                                  np.flatnonzero(live))
    np.testing.assert_array_equal(
        c.dst_row_ptr, jgraph.csr_row_offsets(np.asarray(g.edge_dst)[live],
                                              N))
    # the source table: each source's live edges, ascending
    for j in range(N):
        sl = c.src_perm[c.src_row_ptr[j]:c.src_row_ptr[j + 1]]
        np.testing.assert_array_equal(
            sl, np.flatnonzero(live & (np.asarray(g.edge_src) == j)))
    assert c.src_row_ptr[20] == c.src_row_ptr[21]
    dev = c.to("cpu")
    assert isinstance(dev.dst_perm, torch.Tensor)
    assert CooGraph.from_padded(g, src_table=False).src_table is None


@pytest.mark.parametrize("seed", [0, 4])
def test_csr_row_offsets_match_jax(seed):
    rg = np.random.default_rng(seed)
    dst = np.sort(rg.integers(0, 50, 300))
    for n in (50, 64):
        np.testing.assert_array_equal(csr_row_offsets(dst, n),
                                      jgraph.csr_row_offsets(dst, n))


@pytest.mark.parametrize("shape", [(), (4,), (2, 3)])
def test_autograd_functions_match_plain_torch(case, shape):
    """Gradients of segment_sum (masked, through the live table) and of
    gather (by source, through the live source table and through a table
    of every entry) against autograd of plain torch."""
    g, data, mask = case
    rg = np.random.default_rng(5)
    dst, src = _t(g.edge_dst).long(), _t(g.edge_src).long()
    tm = _t(mask)
    dtab, stab = _tables(g, mask)
    x0 = _t(rg.normal(size=(N,) + shape).astype(np.float32))
    cot = _t(rg.normal(size=(N,) + shape).astype(np.float32))

    def run(plain):
        x = x0.clone().requires_grad_(True)
        if plain:
            gx = x[src]
            d = torch.where(tm.reshape((-1,) + (1,) * len(shape)), gx * 2.0,
                            torch.zeros_like(gx))
            out = torch.zeros_like(x).index_add(0, dst, d)
        else:
            gx = seg.gather(x, src, stab)
            out = seg.segment_sum(gx * 2.0, dst, N, tm, dtab)
        (out * cot).sum().backward()
        return out.detach(), x.grad

    (o1, g1), (o2, g2) = run(True), run(False)
    np.testing.assert_allclose(o2.numpy(), o1.numpy(), atol=ATOL)
    np.testing.assert_allclose(g2.numpy(), g1.numpy(), atol=ATOL)
    # a gather whose cotangent is nonzero on every entry needs the table
    # of every entry; with a gradient it refuses to run without one
    x = x0.clone().requires_grad_(True)
    with pytest.raises(ValueError, match="table"):
        seg.gather(x, src, None)
    (seg.gather(x, src, _all_entries(g.edge_src)) * 3.0).sum().backward()
    want = torch.zeros_like(x0).index_add(
        0, src, torch.full((E_PAD,) + shape, 3.0))
    np.testing.assert_allclose(x.grad.numpy(), want.numpy(), atol=ATOL)
