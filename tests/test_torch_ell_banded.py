"""PyTorch port vs JAX: the banded ELL layout and the layer routes on it.

A k-NN graph as ``tests/test_ell_banded.py`` makes it (1,500 random points
padded to 2,048 nodes, k 8, the JAX package's builder; 2 heads of C 12)
split by the port's ``ops/ell_banded.band_ell`` and by the JAX one, with
bands of 128 and 256 rows:

- ``band_ell``: every ported field equals JAX's; the port's sorted tables
  equal a stable argsort (JAX's ``spill_perm`` / ``spill_perm_d``, and its
  sorted keys cut at every node);
- kernel E's plain version (``band_part_reference``) against the Pallas
  ``ell_gat_band_part_pallas`` in interpret mode: y, m, denom within 2e-5;
  the XLA band part and the two spill folds against JAX's, 2e-5;
- kernel D's plain version (through ``ell_gat_fused_v2``) against
  ``ell_gat_fused_pallas`` in interpret mode, with and without JAX's
  streamed masks: 2e-5; kernel D' (autograd of the plain version) against
  ``jax.grad`` through the Pallas custom VJP ``_fused_v2``: rtol 5e-4 /
  atol 5e-5, the JAX package's tolerance for its fused backward;
- ``GATConvEllBanded`` on its three routes (C, D, E, and E as JAX's XLA
  form) against the JAX layer of the same settings, serving (5e-5) and,
  on route D, training with and without dropout;
- ``EllBathymetricGNN(sparse_kernel="banded")`` against JAX's (rtol 5e-4 /
  atol 5e-5), ``NativeVRProcessor(sparse_kernel="banded")`` against JAX's
  processor (classes agree on >= 99.9 % of cells, confidence within
  2e-3), and the trainer's refusals of the ``"banded"`` route.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bathymetric_gnn_tpu.models.conv_ell as jce
from bathymetric_gnn_tpu.config.config import (BucketConfig as JaxBucket,
                                               Config as JaxConfig,
                                               GraphConfig as JaxGraph,
                                               ModelConfig as JaxModel)
from bathymetric_gnn_tpu.data.graph_build import GraphBuilder as JaxBuilder
from bathymetric_gnn_tpu.inference.native_vr import (
    NativeVRProcessor as JaxProcessor)
from bathymetric_gnn_tpu.models.gnn_ell import (
    EllBathymetricGNN as JaxEllGNN)
from bathymetric_gnn_tpu.ops import ell_banded as jeb
from bathymetric_gnn_tpu.ops.ell import coo_to_ell as jax_coo_to_ell
from bathymetric_gnn_tpu.ops.pallas.ell_gat_fused import (
    ell_gat_band_part_pallas, ell_gat_fused_pallas)
from bathymetric_gnn_tpu_torch.config.config import ModelConfig
from bathymetric_gnn_tpu_torch.inference.native_vr import NativeVRProcessor
from bathymetric_gnn_tpu_torch.models import conv_ell as tce
from bathymetric_gnn_tpu_torch.models.gnn_ell import make_ell_model
from bathymetric_gnn_tpu_torch.ops import ell_banded as teb
from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
from bathymetric_gnn_tpu_torch.ops.ell import EllGraph
from bathymetric_gnn_tpu_torch.utils.weights import (coo_state_dict,
                                                     state_dict_from_flax)

from test_torch_native_vr import (BUCKETS, BUDGET, MODEL, _compare, _port_cfg,
                                  _run, make_refinements, weights)  # noqa: F401

torch.set_num_threads(2)

TOL = dict(rtol=2e-5, atol=2e-5)
LAYER_TOL = dict(rtol=5e-5, atol=5e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)
DROP_TOL = dict(rtol=2e-4, atol=2e-4)
HEADS, C = 2, 12
N = 2048


def make_knn_ell(n_points=1500, n_pad=N, k=8, seed=0):
    rg = np.random.default_rng(seed)
    pos = rg.random((n_points, 2)).astype(np.float32) * 100.0
    depth = (30 + rg.normal(0, 2, n_points)).astype(np.float32)
    x = rg.normal(size=(n_points, 7)).astype(np.float32)
    gb = JaxBuilder(JaxGraph(), JaxBucket(node_buckets=(n_pad,)))
    bg = gb.build_knn_graph(x, pos, k=k, depth=depth)
    return jax_coo_to_ell(bg.graph, max_degree=k)


def _port_graph(g, tensors=False):
    conv = (lambda a: torch.from_numpy(np.array(a))) if tensors else np.array
    return EllGraph(**{f: conv(getattr(g, f))
                       for f in EllGraph.__dataclass_fields__})


@pytest.fixture(scope="module")
def knn_case():
    g = make_knn_ell()
    x = np.random.default_rng(3).normal(size=(N, 16)).astype(np.float32)
    w = np.random.default_rng(13).normal(size=(N, 24)).astype(np.float32)
    return g, x, w


@pytest.fixture(scope="module", params=[128, 256])
def bands(request, knn_case):
    """(R, JAX BandedEll, the port's BandedEll of tensors)."""
    g = knn_case[0]
    r = request.param
    return (r, jeb.band_ell(g, band_rows=r),
            teb.band_ell(_port_graph(g), band_rows=r).to("cpu"))


PORTED = ("loc_t", "spill_src", "spill_dst", "spill_slot", "spill_mask",
          "eattr_t", "mean_attr_t", "spill_eattr", "spill_src_b",
          "spill_dst_b", "spill_dst_local_b", "spill_eattr_b", "negmask_t",
          "spill_perm", "spill_perm_d")


def test_band_ell_matches_jax(knn_case, bands):
    g = knn_case[0]
    r, jb, pb = bands
    for f in PORTED:
        np.testing.assert_array_equal(getattr(pb, f).numpy(),
                                      np.asarray(getattr(jb, f)), err_msg=f)
    assert pb.band_rows == jb.band_rows == r and pb.num_bands == N // r
    assert pb.spill_fraction(g) == jb.spill_fraction(g) > 0
    cuts = np.arange(N + 1)
    for ptr, key in ((pb.spill_row_ptr, jb.spill_src_sorted),
                     (pb.spill_row_ptr_d, jb.spill_dst_sorted)):
        np.testing.assert_array_equal(
            ptr.numpy(), np.searchsorted(np.asarray(key), cuts))
    gsrc = np.asarray(jeb.banded_window_source(jb)).T          # [N, K]
    np.testing.assert_array_equal(teb.banded_window_source(pb).T.numpy(),
                                  gsrc)
    loc = np.asarray(jb.loc_t).T
    key = np.where(loc >= 0, gsrc, N).reshape(-1)
    perm = np.argsort(key, kind="stable")
    np.testing.assert_array_equal(pb.band_perm.numpy(), perm)
    np.testing.assert_array_equal(pb.band_row_ptr.numpy(),
                                  np.searchsorted(key[perm], cuts))
    src, valid = teb.window_sources(pb.loc_t, r)
    np.testing.assert_array_equal(valid.numpy(), loc.T >= 0)
    np.testing.assert_array_equal(src.numpy(), gsrc.T)


def test_band_ell_needs_whole_bands(knn_case):
    g = _port_graph(knn_case[0])
    with pytest.raises(ValueError, match="multiple of band_rows"):
        teb.band_ell(g, band_rows=384)
    with pytest.raises(ValueError, match="s_max"):
        teb.band_ell(g, band_rows=128, s_max=1)


def _streams(banded, seed=0, self_loop=True, edge=True):
    """Random kernel inputs on ``banded``'s layout (numpy): xh [N, H, C],
    the block-diagonal [att_src | att_dst] matrix, el_t (NEG_BIG in dead
    and spilled slots), el_self_t or None, the consistent attention dots,
    m_edge or None."""
    rg = np.random.default_rng(seed)
    f32 = np.float32
    loc = np.asarray(banded.loc_t)
    k = loc.shape[0]
    xh = rg.normal(size=(N, HEADS, C)).astype(f32)
    att = rg.normal(0, 0.3, (2, HEADS, C)).astype(f32)
    diag = (np.arange(HEADS * C)[:, None] // C == np.arange(HEADS)[None])
    a_cat = np.concatenate([diag * att[0].reshape(-1, 1),
                            diag * att[1].reshape(-1, 1)], 1).astype(f32)
    neg = np.repeat(np.where(loc < 0, f32(-1e30), f32(0)), HEADS, axis=0)
    el_t = (rg.normal(size=(k * HEADS, N)).astype(f32) if edge
            else np.zeros((k * HEADS, N), f32)) + neg
    el_self_t = rg.normal(size=(HEADS, N)).astype(f32) if self_loop else None
    a_src = (xh * att[0]).sum(-1).astype(f32)
    a_dst = (xh * att[1]).sum(-1).astype(f32)
    m_edge = rg.normal(0, 0.3, (3, HEADS)).astype(f32) if edge else None
    return dict(xh=xh, a_cat=a_cat, el_t=el_t, el_self_t=el_self_t,
                a_src=a_src, a_dst=a_dst, m_edge=m_edge)


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("self_loop", [True, False])
def test_band_part_matches_pallas(bands, self_loop):
    """Kernel E's plain version vs the Pallas band kernel (interpret)."""
    r, jb, pb = bands
    s = _streams(jb, self_loop=self_loop)
    want = ell_gat_band_part_pallas(
        _j(s["xh"]), _j(s["a_cat"]), _j(s["el_t"]), _j(s["el_self_t"]), jb,
        interpret=True)
    with torch.no_grad():
        got = eb.ell_gat_band_part(_t(s["xh"]), _t(s["a_cat"]), _t(s["el_t"]),
                                   _t(s["el_self_t"]), pb)
    for name, a, b in zip(("y", "m", "denom"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)


def test_spill_folds_match_jax(bands):
    """The XLA band part, ``banded_gat_spill_pass`` and the flat fold that
    completes kernel E, against the JAX functions on the same inputs."""
    r, jb, pb = bands
    s = _streams(jb, seed=1)
    k = np.asarray(jb.loc_t).shape[0]
    el_e = np.asarray(s["el_t"]).reshape(k, HEADS, N).transpose(2, 0, 1)
    el_e = np.where(el_e < -1e29, 0.0, el_e).astype(np.float32)
    y_j, m_j, d_j = jeb.banded_gat_band_part_xla(
        _j(s["xh"]), _j(s["a_src"]), _j(s["a_dst"]), _j(el_e),
        _j(s["el_self_t"].T), jb)
    y_t, m_t, d_t = teb.banded_gat_band_part_xla(
        _t(s["xh"]), _t(s["a_src"]), _t(s["a_dst"]), _t(el_e),
        _t(s["el_self_t"].T), pb)
    for a, b in ((y_t, y_j), (m_t, m_j), (d_t, d_j)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    want = jeb.banded_gat_spill_pass(y_j, m_j, d_j, _j(s["xh"]),
                                     _j(s["a_src"]), _j(s["a_dst"]),
                                     _j(s["m_edge"]), jb)
    got = teb.banded_gat_spill_pass(y_t, m_t, d_t, _t(s["xh"]),
                                    _t(s["a_src"]), _t(s["a_dst"]),
                                    _t(s["m_edge"]), pb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    y2, m, den = ell_gat_band_part_pallas(
        _j(s["xh"]), _j(s["a_cat"]), _j(s["el_t"]), _j(s["el_self_t"]), jb,
        interpret=True)
    ac = np.concatenate([s["a_src"], s["a_dst"]], 1)
    want = jeb.banded_gat_spill_pass_flat(
        y2, m, den, _j(s["xh"].reshape(N, -1)), _j(ac), _j(s["m_edge"]), jb,
        heads=HEADS)
    got = teb.banded_gat_spill_pass_flat(
        _t(y2), _t(m), _t(den), _t(s["xh"].reshape(N, -1)), _t(ac),
        _t(s["m_edge"]), pb, heads=HEADS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_masks(jb, seed=321, p=0.3):
    k = np.asarray(jb.loc_t).shape[0]
    return jce.make_banded_dropout_masks(
        jax.random.PRNGKey(seed), p, N, k, HEADS,
        np.asarray(jb.spill_dst_local_b).shape)


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("self_loop", [True, False])
def test_fused_v2_matches_pallas(bands, drop, self_loop):
    """Kernel D's plain version vs the Pallas kernel (interpret), with and
    without JAX's streamed masks, given to both unchanged."""
    r, jb, pb = bands
    s = _streams(jb, seed=2, self_loop=self_loop)
    masks = _jax_masks(jb) if drop else None
    want = ell_gat_fused_pallas(
        _j(s["xh"]), _j(s["a_src"]), _j(s["a_dst"]), _j(s["a_cat"]),
        _j(s["el_t"]), _j(s["el_self_t"]), _j(s["m_edge"]), jb,
        dropout_masks=masks, interpret=True)
    got = eb.ell_gat_fused_v2(
        _t(s["xh"]), _t(s["a_src"]), _t(s["a_dst"]), _t(s["a_cat"]),
        _t(s["el_t"]), _t(s["el_self_t"]), _t(s["m_edge"]), pb,
        dropout_masks=None if masks is None else tuple(
            _t(np.asarray(m)) for m in masks))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


V2_LEAVES = ("xh", "a_src", "a_dst", "a_cat", "el_t", "el_self_t", "m_edge")


@pytest.mark.parametrize("drop,self_loop", [(False, True), (True, True),
                                            (False, False)])
def test_fused_v2_grads_match_jax(knn_case, bands, drop, self_loop):
    """Kernel D' (autograd of D's plain version, m held constant) vs
    jax.grad through the Pallas custom VJP, every input's gradient."""
    r, jb, pb = bands
    s = _streams(jb, seed=3, self_loop=self_loop)
    masks = _jax_masks(jb, seed=7) if drop else None
    names = [n for n in V2_LEAVES if s[n] is not None]
    w = knn_case[2]

    def loss(*leaves):
        kw = dict(zip(names, leaves))
        out = ell_gat_fused_pallas(
            kw["xh"], kw["a_src"], kw["a_dst"], kw["a_cat"], kw["el_t"],
            kw.get("el_self_t"), kw.get("m_edge"), jb, dropout_masks=masks,
            interpret=True)
        return jnp.sum(out * w)

    want = jax.grad(loss, argnums=tuple(range(len(names))))(
        *[_j(s[n]) for n in names])
    leaves = {n: _t(s[n]).clone().requires_grad_() for n in names}
    out = eb.ell_gat_fused_v2(
        leaves["xh"], leaves["a_src"], leaves["a_dst"], leaves["a_cat"],
        leaves["el_t"], leaves.get("el_self_t"), leaves.get("m_edge"), pb,
        dropout_masks=None if masks is None else tuple(
            _t(np.asarray(m)) for m in masks))
    (out * _t(w)).sum().backward()
    for n, ref in zip(names, want):
        np.testing.assert_allclose(leaves[n].grad.numpy(), np.asarray(ref),
                                   **GRAD_TOL, err_msg=n)


def test_band_part_has_no_backward(bands):
    r, jb, pb = bands
    s = _streams(jb)
    xh = _t(s["xh"]).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        eb.ell_gat_band_part(xh, _t(s["a_cat"]), _t(s["el_t"]), None, pb)


ROUTES = {
    "C": dict(use_pallas=True),
    "D": dict(use_pallas=True, wide_kernel=False),
    "E": dict(use_pallas=True, spill_in_kernel=False),
    "E_xla": dict(),
}
LAYERS = {
    "heads2_concat": dict(out_channels=C, heads=HEADS),
    "heads1_mean": dict(out_channels=C, heads=1, concat=False),
    "no_self_loops": dict(out_channels=C, heads=HEADS, add_self_loops=False),
}


def _jax_layer(route, kw, dropout=0.0):
    return jce.GATConvEllBanded(edge_dim=3, dropout=dropout, **ROUTES[route],
                                **kw)


def _port_layer(route, kw, params, dropout=0.0):
    m = tce.GATConvEllBanded(16, edge_dim=3, dropout=dropout,
                             **ROUTES[route], **kw)
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in params.items()})
    return m


def _params(layer, g, banded, x):
    params = jax.tree_util.tree_map(
        np.array, layer.init(jax.random.PRNGKey(7), g, banded, x)["params"])
    params["bias"] = np.random.default_rng(5).normal(
        0, 0.1, params["bias"].shape).astype(np.float32)
    return params


@pytest.fixture(scope="module")
def band_pairs(knn_case):
    """{R: (JAX BandedEll, the port's of tensors)} for R 128 and 256."""
    g = knn_case[0]
    return {r: (jeb.band_ell(g, band_rows=r),
                teb.band_ell(_port_graph(g), band_rows=r).to("cpu"))
            for r in (128, 256)}


@pytest.mark.parametrize("route,r", [("C", 256), ("D", 128), ("D", 256),
                                     ("E", 128), ("E", 256),
                                     ("E_xla", 128)])
@pytest.mark.parametrize("case", ["heads2_concat", "no_self_loops"])
def test_banded_layer_routes_match_jax(knn_case, band_pairs, route, r,
                                       case):
    """Serving: the port's layer on each route vs the JAX layer of the
    same settings (route C reads no band layout)."""
    g, x, _ = knn_case
    jb, pb = band_pairs[r]
    kw = LAYERS[case]
    layer = _jax_layer(route, kw)
    params = _params(layer, g, jb, x)
    want = np.asarray(layer.apply({"params": params}, g, jb, x))
    port = _port_layer(route, kw, params).eval()
    assert port.route == route[0]
    with torch.no_grad():
        got = port(_port_graph(g, tensors=True), torch.from_numpy(x),
                   banded=pb).numpy()
    np.testing.assert_allclose(got, want, **LAYER_TOL)
    assert not got[1500:].any()


def _jax_train(layer, params, g, banded, x, w, rng=None):
    rngs = {"dropout": rng} if rng is not None else {}

    def loss(p, xx):
        out = layer.apply({"params": p}, g, banded, xx, False, rngs=rngs)
        return jnp.sum(out * w[:, :out.shape[1]]), out

    (_, out), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1),
                                            has_aux=True)(params, x)
    return np.asarray(out), np.asarray(gx), jax.tree_util.tree_map(
        np.asarray, gp)


@pytest.mark.parametrize("case,p", [("heads2_concat", 0.0),
                                    ("heads1_mean", 0.0),
                                    ("heads2_concat", 0.3),
                                    ("no_self_loops", 0.3)])
def test_route_d_trains_like_jax(knn_case, band_pairs, case, p,
                                 monkeypatch):
    """Route D in training mode (kernels D and D' on the card) vs jax.grad
    of the JAX layer with ``wide_kernel=False``: the output, x's gradient
    and every parameter's; with dropout p, JAX's streamed masks captured and
    fed to the port unchanged (its layout is the JAX one)."""
    g, x, w = knn_case
    jb, pb = band_pairs[256]
    kw = LAYERS[case]
    layer = _jax_layer("D", kw, dropout=p)
    params = _params(layer, g, jb, x)
    captured = {}
    orig = jce.make_banded_dropout_masks

    def capture(*a, **k):
        captured["masks"] = orig(*a, **k)
        return captured["masks"]

    monkeypatch.setattr(jce, "make_banded_dropout_masks", capture)
    out_j, gx_j, gp_j = _jax_train(layer, params, g, jb, x, w,
                                   jax.random.PRNGKey(321) if p else None)

    def streamed(gen, rate, n, k, heads, spill_shape):
        assert (rate, n, heads) == (p, N, kw["heads"])
        return tuple(_t(np.asarray(m)) for m in captured["masks"])

    monkeypatch.setattr(tce, "make_banded_dropout_masks", streamed)
    port = _port_layer("D", kw, params, dropout=p).train()
    xt = torch.from_numpy(x).requires_grad_()
    out = port(_port_graph(g, tensors=True), xt,
               torch.Generator().manual_seed(0), banded=pb)
    (out * torch.from_numpy(w[:, :out.shape[1]])).sum().backward()
    tol = DROP_TOL if p else GRAD_TOL
    np.testing.assert_allclose(out.detach().numpy(), out_j, **tol)
    np.testing.assert_allclose(xt.grad.numpy(), gx_j, **tol)
    for name, ref in gp_j.items():
        np.testing.assert_allclose(
            dict(port.named_parameters())[name].grad.numpy(), ref, **tol,
            err_msg=name)


def test_routes_refuse_as_jax(knn_case, band_pairs):
    """Attention dropout off the fused kernel raises JAX's
    NotImplementedError, with JAX's words; route E refuses a gradient; the
    banded routes need ``banded``."""
    g, x, _ = knn_case
    jb, pb = band_pairs[256]
    layer = _jax_layer("E_xla", LAYERS["heads2_concat"], dropout=0.1)
    params = _params(layer, g, jb, x)
    with pytest.raises(NotImplementedError) as jerr:
        layer.apply({"params": params}, g, jb, x, False,
                    rngs={"dropout": jax.random.PRNGKey(0)})
    tg = _port_graph(g, tensors=True)
    for route in ("E", "E_xla"):
        port = _port_layer(route, LAYERS["heads2_concat"], params,
                           dropout=0.1).train()
        with pytest.raises(NotImplementedError) as perr:
            port(tg, torch.from_numpy(x), torch.Generator(), banded=pb)
        assert str(perr.value) == str(jerr.value)
        port.dropout = 0.0
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            port(tg, torch.from_numpy(x), banded=pb)
    port = _port_layer("D", LAYERS["heads2_concat"], params).eval()
    with torch.no_grad(), pytest.raises(ValueError, match="BandedEll"):
        port(tg, torch.from_numpy(x))


def test_dropout_masks():
    gen = torch.Generator().manual_seed(0)
    dm, dm_sp = tce.make_banded_dropout_masks(gen, 0.1, 4096, 8, 4,
                                              (32, 1, 64))
    assert dm.shape == (9 * 4, 4096) and dm_sp.shape == (32, 4, 64)
    keep = torch.tensor(1 / 0.9)
    for m in (dm, dm_sp):
        assert m.dtype == torch.float32 and bool(((m == 0) | (m == keep))
                                                 .all())
    assert abs((dm == 0).float().mean().item() - 0.1) < 5e-3
    wide = np.random.default_rng(0).random((16, 4, 9 * 128)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tce.banded_masks_wide_to_khn(torch.from_numpy(wide), 8, 4).numpy(),
        np.asarray(jce.banded_masks_wide_to_khn(jnp.asarray(wide), 8, 4)))


def test_gather_rows_reduce_bwd(bands):
    """The spill-row gather's backward (kernel F mode (a)'s plain version
    over the BandedEll's tables) equals autograd of the gather of the live
    entries."""
    r, _, pb = bands
    table = torch.randn(N, 6, generator=torch.Generator().manual_seed(1))
    live = (pb.spill_dst_local_b.reshape(-1) >= 0)[:, None].float()
    for idx, perm, ptr in (
            (pb.spill_src_b.reshape(-1), pb.spill_perm, pb.spill_row_ptr),
            (pb.spill_dst_b.reshape(-1), pb.spill_perm_d,
             pb.spill_row_ptr_d)):
        a = table.clone().requires_grad_()
        b = table.clone().requires_grad_()
        ((teb.gather_rows_reduce_bwd(a, idx, perm, ptr) * live) ** 2
         ).sum().backward()
        ((b[idx.long()] * live) ** 2).sum().backward()
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model_case(knn_case):
    g = knn_case[0]
    jb = jeb.band_ell(g, band_rows=128)
    kw = dict(hidden_channels=16, num_layers=2, heads=2, dropout=0.0)
    variables = JaxEllGNN(**kw).init(jax.random.PRNGKey(0), g)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    rg = np.random.default_rng(11)
    for leaf in stats["GNNBackbone_0"].values():
        leaf["mean"] = rg.normal(0, 0.2, leaf["mean"].shape).astype(np.float32)
        leaf["var"] = rg.uniform(0.5, 2.0, leaf["var"].shape).astype(
            np.float32)
    v = {"params": params, "batch_stats": stats}
    model = JaxEllGNN(**kw, sparse_kernel="banded")
    with pytest.raises(ValueError) as jerr:
        model.apply(v, g)
    want = model.apply(v, g, banded=jb)
    sd = state_dict_from_flax(params, stats, "coo")
    return g, sd, {k: np.asarray(a) for k, a in want.items()}, jerr


def test_ell_model_banded_matches_jax(model_case):
    g, sd, want, jerr = model_case
    cfg = ModelConfig(hidden_channels=16, num_layers=2, heads=2)
    model = make_ell_model(cfg, 7, sparse_kernel="banded")
    model.load_state_dict(coo_state_dict(sd))
    model.eval()
    layers = [getattr(model.GNNBackbone_0, f"GATConv_{i}") for i in range(2)]
    assert [m.route for m in layers] == ["E", "E"]
    tg = _port_graph(g, tensors=True)
    pb = teb.band_ell(_port_graph(g), band_rows=128).to("cpu")
    with torch.no_grad():
        got = model(tg, banded=pb)
        with pytest.raises(ValueError) as perr:
            model(tg)
    assert str(perr.value) == str(jerr.value)
    for key in ("class_logits", "confidence", "correction"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=5e-4,
                                   atol=5e-5, err_msg=key)


def test_native_vr_banded_matches_jax(weights):  # noqa: F811
    """NativeVRProcessor on the ``"banded"`` route (kernel E's plain
    version and the spill fold, band_ell per chunk) vs JAX's processor on
    the same route and grids."""
    model, variables, sd = weights
    grids = make_refinements(16, seed=3, big=80)
    jcfg = JaxConfig(model=JaxModel(**MODEL, sparse_kernel="banded"),
                     graph=JaxGraph(knn_k=8))
    jproc = JaxProcessor(model, variables, jcfg, node_budget=BUDGET,
                         node_buckets=BUCKETS)
    cfg = _port_cfg()
    cfg.model.sparse_kernel = "banded"
    tproc = NativeVRProcessor(sd, cfg, node_budget=BUDGET,
                              node_buckets=BUCKETS, device="cpu")
    assert tproc.sparse_kernel == jproc.sparse_kernel == "banded"
    want, got = _run(jproc, grids), _run(tproc, grids)
    assert len(got) == len(want) == len(grids)
    n_valid = total_agree = 0
    for gr, wa, (depth, _, _) in zip(got, want, grids):
        valid = np.abs(depth) < 1e5
        agree, dconf, dcorr = _compare(gr, wa, valid)
        assert dconf <= 2e-3 and dcorr <= 2e-3, (dconf, dcorr)
        total_agree += agree * valid.sum()
        n_valid += valid.sum()
    assert total_agree / n_valid >= 0.999


def test_trainer_refuses_the_banded_route(tmp_path):
    """The k-NN trainer on ``sparse_kernel="banded"``: with dropout the JAX
    trainer's own refusal (its layer raises at the first step; the port's
    trainer raises the same error when it is built), without dropout a
    refusal naming ROADMAP (kernel E has no backward)."""
    from bathymetric_gnn_tpu.models.gnn import make_model as jax_make_model
    from bathymetric_gnn_tpu.training import datasets as jds
    from bathymetric_gnn_tpu.training import trainer as jtr
    from bathymetric_gnn_tpu_torch.config.config import Config
    from bathymetric_gnn_tpu_torch.training import trainer as ttr

    from conftest import make_ramp_surface

    jcfg = JaxConfig()
    for k, v in dict(hidden_channels=8, num_layers=2, heads=2,
                     sparse_kernel="banded", dropout=0.1).items():
        setattr(jcfg.model, k, v)
    jcfg.graph.knn_k = 8
    jcfg.bucket.node_buckets = (1024,)
    jcfg.training.batch_size = 2
    ds = jds.SyntheticTileDataset([make_ramp_surface(48, 48, seed=1)], jcfg,
                                  tile_size=32, overlap=8, seed=5)
    sample = ds[0]
    jt = jtr.Trainer(jcfg, jax_make_model(jcfg.model, sample.graph.x.shape[-1],
                                          sample.graph.edge_attr.shape[-1]),
                     ds, output_dir=str(tmp_path / "jax"))
    assert jt.sparse_kernel == "banded"
    state = jt.init_state(sample.graph)
    graph, targets = next(iter(jds.epoch_batches(ds, 2,
                                                 np.random.default_rng(0))))
    g, banded = jt._sparse_batch(graph)
    with pytest.raises(NotImplementedError) as jerr:
        jt._train_step(state, g, banded, targets, jax.random.PRNGKey(0),
                       jnp.float32(1e-3))
    cfg = Config()
    for k, v in dict(hidden_channels=8, num_layers=2, heads=2,
                     sparse_kernel="banded", dropout=0.1).items():
        setattr(cfg.model, k, v)
    cfg.graph.knn_k = 8
    with pytest.raises(NotImplementedError) as perr:
        ttr.Trainer(cfg, None, output_dir=str(tmp_path / "port"),
                    device="cpu")
    assert str(perr.value) == str(jerr.value)
    cfg.model.dropout = 0.0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttr.Trainer(cfg, None, output_dir=str(tmp_path / "port0"),
                    device="cpu")


def test_banded_ell_to_keeps_band_rows(bands):
    r, _, pb = bands
    moved = pb.to("cpu")
    assert moved.band_rows == r
    assert all(isinstance(getattr(moved, f.name), torch.Tensor)
               for f in dataclasses.fields(moved) if f.name != "band_rows")
