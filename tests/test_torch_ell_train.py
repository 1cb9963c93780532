"""PyTorch port vs JAX: the GAT layer on ELL graphs in training mode, and
the sorted-segment reduction (kernel F) that its backward ends in.

A k-NN graph as ``tests/test_ell_banded.py`` makes it (``make_knn_ell``:
1,500 random points padded to 2,048 nodes, k 8, the JAX package's builder)
goes through ``jax.grad`` of the JAX ``GATConvEllBanded(use_pallas=True,
spill_in_kernel=True)`` in training mode (the Pallas kernels C and C' in
interpret mode, ``band_ell`` with 256-row bands) and through autograd of
the port's ``GATConvEllBanded`` in training mode (on the CPU: kernel C's
plain version; on the card the same layer runs kernels C, C' and F), with
the same weights: outputs and the gradients of x and of every parameter
within rtol 5e-4 / atol 5e-5, the JAX package's own tolerances for its
fused backward. With attention dropout, JAX's streamed masks are captured
and mapped to the port's [N, K+1, heads] layout (2e-4). Kernel F's plain
version, over ``src_sorted_slots`` tables, is held against JAX's
``segment_reduce_sorted`` (interpret mode) on ``band_ell``'s spill tables
(1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bathymetric_gnn_tpu.models.conv_ell as jce
from bathymetric_gnn_tpu.config.config import (BucketConfig as JaxBucket,
                                               GraphConfig as JaxGraph)
from bathymetric_gnn_tpu.data.graph_build import GraphBuilder as JaxBuilder
from bathymetric_gnn_tpu.models.conv_ell import \
    GATConvEllBanded as JaxGATConvEllBanded
from bathymetric_gnn_tpu.ops.ell import coo_to_ell as jax_coo_to_ell
from bathymetric_gnn_tpu.ops.ell_banded import band_ell
from bathymetric_gnn_tpu.ops.pallas.segment_reduce import \
    segment_reduce_sorted as jax_segment_reduce_sorted
from bathymetric_gnn_tpu_torch.models import conv_ell as tce
from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr
from bathymetric_gnn_tpu_torch.ops.ell import (EllGraph, EllTrainGraph,
                                               src_sorted_slots)

torch.set_num_threads(2)

TOL = dict(rtol=5e-4, atol=5e-5)
DROP_TOL = dict(rtol=2e-4, atol=2e-4)


def make_knn_ell(n_points=1500, n_pad=2048, k=8, seed=0):
    rg = np.random.default_rng(seed)
    pos = rg.random((n_points, 2)).astype(np.float32) * 100.0
    depth = (30 + rg.normal(0, 2, n_points)).astype(np.float32)
    x = rg.normal(size=(n_points, 7)).astype(np.float32)
    gb = JaxBuilder(JaxGraph(), JaxBucket(node_buckets=(n_pad,)))
    bg = gb.build_knn_graph(x, pos, k=k, depth=depth)
    return jax_coo_to_ell(bg.graph, max_degree=k)


@pytest.fixture(scope="module")
def knn_case():
    g = make_knn_ell()
    banded = band_ell(g, band_rows=256)
    x = np.random.default_rng(3).normal(size=(2048, 16)).astype(np.float32)
    w = np.random.default_rng(13).normal(size=(2048, 24)).astype(np.float32)
    tg = EllGraph(**{f: torch.from_numpy(np.array(getattr(g, f)))
                     for f in EllGraph.__dataclass_fields__})
    return g, banded, x, w, tg


LAYERS = {
    "heads2_concat": dict(out_channels=12, heads=2),
    "heads1_mean": dict(out_channels=24, heads=1, concat=False),
    "no_self_loops": dict(out_channels=12, heads=2, add_self_loops=False),
}


def _jax_grads(layer, params, g, banded, x, w, rng=None):
    """Output and jax.grad of <out, w> (params, x), training mode."""
    rngs = {"dropout": rng} if rng is not None else {}

    def loss(p, xx):
        out = layer.apply({"params": p}, g, banded, xx, False, rngs=rngs)
        return jnp.sum(out * w[:, :out.shape[1]]), out

    (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(params, x)
    return np.asarray(out), np.asarray(gx), jax.tree_util.tree_map(
        np.asarray, gp)


def _port_grads(kw, params, tg, x, w, dropout=0.0):
    layer = tce.GATConvEllBanded(16, edge_dim=3, dropout=dropout,
                                 use_pallas=True, **kw)
    layer.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in params.items()})
    xt = torch.from_numpy(x).requires_grad_()
    out = layer.train()(tg, xt, torch.Generator().manual_seed(0))
    (out * torch.from_numpy(w[:, :out.shape[1]])).sum().backward()
    return (out.detach().numpy(), xt.grad.numpy(),
            {n: p.grad.numpy() for n, p in layer.named_parameters()})


def _init(kw, g, banded, x, dropout=0.0):
    layer = JaxGATConvEllBanded(edge_dim=3, use_pallas=True,
                                spill_in_kernel=True, dropout=dropout, **kw)
    params = jax.tree_util.tree_map(
        np.array, layer.init(jax.random.PRNGKey(7), g, banded, x)["params"])
    # a nonzero bias, so its gradient path is not trivially 0
    params["bias"] = np.random.default_rng(5).normal(
        0, 0.1, params["bias"].shape).astype(np.float32)
    return layer, params


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_train_layer_grads_match_jax(knn_case, case):
    g, banded, x, w, tg = knn_case
    kw = LAYERS[case]
    layer, params = _init(kw, g, banded, x)
    out_j, gx_j, gp_j = _jax_grads(layer, params, g, banded, x, w)
    out_t, gx_t, gp_t = _port_grads(kw, params, tg, x, w)
    np.testing.assert_allclose(out_t, out_j, **TOL)
    np.testing.assert_allclose(gx_t, gx_j, **TOL)
    assert sorted(gp_t) == sorted(gp_j)
    for name, ref in gp_j.items():
        np.testing.assert_allclose(gp_t[name], ref, **TOL, err_msg=name)
    assert not gx_t[1500:].any()         # padded nodes get no gradient


def _port_mask(dm, dm_sp, banded, n, k, heads):
    """JAX's captured wide masks ([T, H, (K+1) R] in-band + self, [T, H,
    S_max] spill) -> the port's [N, K+1, heads] (self loop at slot K):
    in-band slots read dm, spilled slots read dm_sp at (band, position in
    the band's spill list), as tests/test_ell_banded.py maps them."""
    dm = np.asarray(jce.banded_masks_wide_to_khn(dm, k, heads))
    dm_sp = np.asarray(dm_sp)
    mask = np.empty((n, k + 1, heads), np.float32)
    for kk in range(k + 1):
        mask[:, kk, :] = dm[kk * heads:(kk + 1) * heads, :].T
    sm = np.asarray(banded.spill_mask)
    sd = np.asarray(banded.spill_dst)[sm]
    sk = np.asarray(banded.spill_slot)[sm]
    r = banded.band_rows
    band_of = sd // r
    counts = np.bincount(band_of, minlength=n // r)
    starts = np.concatenate([[0], np.cumsum(counts)])
    mask[sd, sk, :] = dm_sp[band_of, :, np.arange(len(sd)) - starts[band_of]]
    return mask


@pytest.mark.parametrize("case", ["heads2_concat", "no_self_loops"])
def test_train_layer_dropout_matches_jax(knn_case, case, monkeypatch):
    """Attention dropout p = 0.3: JAX's streamed draw, captured and mapped
    to the port's layout, fed to the port's layer as its mask."""
    g, banded, x, w, tg = knn_case
    kw = LAYERS[case]
    p = 0.3
    layer, params = _init(kw, g, banded, x, dropout=p)
    captured = {}
    orig = jce.make_banded_dropout_masks

    def capture(*a, **k):
        captured["masks"] = orig(*a, **k)
        return captured["masks"]

    monkeypatch.setattr(jce, "make_banded_dropout_masks", capture)
    out_j, gx_j, gp_j = _jax_grads(layer, params, g, banded, x, w,
                                   rng=jax.random.PRNGKey(321))
    n, k = tg.nbr_src.shape
    heads = kw["heads"]
    mask = torch.from_numpy(_port_mask(*captured["masks"], banded, n, k,
                                       heads))
    assert set(np.unique(mask.numpy())) <= {0.0, np.float32(1 / (1 - p))}

    def streamed(gen, rate, n_, k_, h_):
        assert (rate, n_, k_, h_) == (p, n, k, heads)
        return mask

    monkeypatch.setattr(tce, "make_ell_dropout_mask", streamed)
    out_t, gx_t, gp_t = _port_grads(kw, params, tg, x, w, dropout=p)
    np.testing.assert_allclose(out_t, out_j, **DROP_TOL)
    np.testing.assert_allclose(gx_t, gx_j, **DROP_TOL)
    for name, ref in gp_j.items():
        np.testing.assert_allclose(gp_t[name], ref, **DROP_TOL,
                                   err_msg=name)


def test_segment_reduce_matches_jax(knn_case):
    """Kernel F's plain version over ``src_sorted_slots`` tables vs JAX's
    ``segment_reduce_sorted`` (interpret mode) as the JAX backward of the
    spill-row gather runs it (``_grr_bwd``: the cotangent permuted by
    ``spill_perm``, reduced over ``spill_src_sorted``)."""
    g, _, _, _, _ = knn_case
    n = g.num_nodes_padded
    banded = band_ell(g, band_rows=128, spill_pad=64)
    src = np.asarray(banded.spill_src_b).reshape(-1)
    live = np.asarray(banded.spill_dst_local_b)[:, 0, :].reshape(-1) >= 0
    s = src.shape[0]
    ct = np.random.default_rng(0).normal(size=(s, 16)).astype(np.float32)
    want = jax_segment_reduce_sorted(
        jnp.take(jnp.asarray(ct), banded.spill_perm, axis=0),
        banded.spill_src_sorted, banded.spill_red_first,
        banded.spill_red_jcount, n=n, max_j=banded.spill_red_maxj,
        interpret=True)
    # the spill rows as the slots of an [N, K'] ELL table (padded dead)
    kp = -(-s // n)
    nbr = np.zeros(n * kp, np.int32)
    nbr[:s] = src
    mask = np.zeros(n * kp, bool)
    mask[:s] = live
    ct_pad = np.zeros((n * kp, 16), np.float32)
    ct_pad[:s] = ct
    perm, row_ptr = src_sorted_slots(nbr.reshape(n, kp), mask.reshape(n, kp))
    got = sr.segment_reduce_sorted(torch.from_numpy(ct_pad),
                                   torch.from_numpy(perm),
                                   torch.from_numpy(row_ptr), n)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_src_sorted_slots_tables(knn_case):
    """perm lists each source's live slots in ascending slot order (a
    stable sort), dead slots and the slots of padded destinations sort
    past row_ptr[N]; the sum over a source's slots is that of index_add_."""
    _, _, _, _, tg = knn_case
    nbr, live = tg.nbr_src.numpy(), tg.nbr_mask.numpy().copy()
    node_mask = tg.node_mask.numpy().copy()
    node_mask[1400:1500] = False           # more padded destinations
    perm, row_ptr = src_sorted_slots(nbr, live, node_mask)
    n, k = nbr.shape
    flat_live = (live & node_mask[:, None]).reshape(-1)
    assert row_ptr[0] == 0 and row_ptr[-1] == flat_live.sum()
    assert np.all(np.diff(row_ptr) >= 0)
    for j in (0, 7, 733, 1399, 1499):
        seg = perm[row_ptr[j]:row_ptr[j + 1]]
        assert np.all(np.diff(seg) > 0)
        np.testing.assert_array_equal(
            seg, np.nonzero(flat_live & (nbr.reshape(-1) == j))[0])
    ct = torch.from_numpy(np.random.default_rng(1).normal(
        size=(n * k, 5)).astype(np.float32))
    ref = torch.zeros(n, 5).index_add_(
        0, torch.from_numpy(nbr.reshape(-1)[flat_live]).long(),
        ct[torch.from_numpy(flat_live)])
    got = sr.segment_reduce_reference(ct, torch.from_numpy(perm),
                                      torch.from_numpy(row_ptr), n)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    g2 = EllGraph(**{f: getattr(tg, f).numpy()
                     for f in EllGraph.__dataclass_fields__}
                  ).with_src_sorted_slots()
    assert isinstance(g2, EllTrainGraph)
    assert isinstance(g2.to("cpu"), EllTrainGraph)


def test_gat_rows_reference_is_the_gather_backward(knn_case):
    """Kernel F's mode (b) plain version (each source's rows alpha * dy[dst]
    + dl * att_src formed from per-slot coefficients) equals autograd of
    the message and logit gathers it is the backward of."""
    _, _, _, _, tg = knn_case
    n, k = tg.nbr_src.shape
    heads, c = 2, 6
    rg = torch.Generator().manual_seed(3)
    alpha = torch.randn(n * k, heads, generator=rg)
    dl = torch.randn(n * k, heads, generator=rg)
    dy = torch.randn(n, heads * c, generator=rg)
    att = torch.randn(1, heads, c, generator=rg)
    perm, row_ptr = src_sorted_slots(tg.nbr_src.numpy(), tg.nbr_mask.numpy(),
                                     tg.node_mask.numpy())
    got = sr.gat_rows_reference(alpha, dl, dy, att, torch.from_numpy(perm),
                                torch.from_numpy(row_ptr), n, k)
    xh = torch.zeros(n, heads, c, requires_grad=True)
    live = (tg.nbr_mask & tg.node_mask[:, None]).reshape(n, k, 1, 1)
    src = tg.nbr_src.long()
    msg = xh[src] * alpha.reshape(n, k, heads, 1)             # [N, K, h, C]
    logit = (xh[src] * att).sum(-1) * dl.reshape(n, k, heads)
    f = (torch.where(live, msg, torch.zeros_like(msg))
         * dy.reshape(n, 1, heads, c)).sum() + torch.where(
        live[..., 0], logit, torch.zeros_like(logit)).sum()
    f.backward()
    torch.testing.assert_close(got, xh.grad.reshape(n, heads * c),
                               rtol=1e-5, atol=1e-5)


def test_make_ell_dropout_mask():
    gen = torch.Generator().manual_seed(0)
    m = tce.make_ell_dropout_mask(gen, 0.1, 4096, 8, 4)
    assert m.shape == (4096, 9, 4) and m.dtype == torch.float32
    keep = torch.tensor(1 / 0.9)
    assert bool(((m == 0) | (m == keep)).all())
    assert abs((m == 0).float().mean().item() - 0.1) < 5e-3
    m2 = tce.make_ell_dropout_mask(torch.Generator().manual_seed(0), 0.1,
                                   4096, 8, 4)
    assert torch.equal(m, m2)
