"""PyTorch port vs JAX: the GAT layer on ELL graphs and the ELL model.

A k-NN graph as ``tests/test_ell_banded.py`` makes it (1,500 random
points, padded to 2,048 nodes, k 8, built by the JAX package's builder)
goes through the JAX ``GATConvEllBanded(use_pallas=True)`` (the Pallas
kernel C in interpret mode; ``band_ell`` with 256-row bands) and
``GATConvELL``, and through the port's ``GATConvEllBanded`` (on the CPU:
kernel C's plain version, ``ell_gat_reference``) and ``GATConvELL``, with
the same weights. Tolerance 5e-5, the JAX package's own for the banded
kernel against the plain layer. The full ``EllBathymetricGNN`` (hidden 16,
2 layers, 2 heads, random BatchNorm statistics) goes through the weight
bridge (flax COO tree -> the port's grid-named state_dict -> the ELL
model's keys): logits, confidence and correction within rtol 5e-4 / atol
5e-5, the JAX test's bounds.
"""

import jax
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.config.config import (BucketConfig as JaxBucket,
                                               GraphConfig as JaxGraph)
from bathymetric_gnn_tpu.data.graph_build import GraphBuilder as JaxBuilder
from bathymetric_gnn_tpu.models.conv_ell import (
    GATConvELL as JaxGATConvELL, GATConvEllBanded as JaxGATConvEllBanded)
from bathymetric_gnn_tpu.models.gnn_ell import (
    EllBathymetricGNN as JaxEllGNN)
from bathymetric_gnn_tpu.ops.ell import coo_to_ell as jax_coo_to_ell
from bathymetric_gnn_tpu.ops.ell_banded import band_ell
from bathymetric_gnn_tpu_torch.config.config import ModelConfig
from bathymetric_gnn_tpu_torch.models.conv_ell import (GATConvELL,
                                                       GATConvEllBanded)
from bathymetric_gnn_tpu_torch.models.gnn_ell import (EllBathymetricGNN,
                                                      make_ell_model)
from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
from bathymetric_gnn_tpu_torch.ops.ell import EllGraph
from bathymetric_gnn_tpu_torch.utils.weights import (coo_state_dict,
                                                     state_dict_from_flax)

from test_torch_knn_graph import ensure_jax_native_kit

torch.set_num_threads(2)

TOL = dict(rtol=5e-5, atol=5e-5)


@pytest.fixture(scope="module")
def knn_case():
    ensure_jax_native_kit()
    rg = np.random.default_rng(0)
    pos = rg.random((1500, 2)).astype(np.float32) * 100.0
    depth = (30 + rg.normal(0, 2, 1500)).astype(np.float32)
    x = rg.normal(size=(1500, 7)).astype(np.float32)
    gb = JaxBuilder(JaxGraph(), JaxBucket(node_buckets=(2048,)))
    g = jax_coo_to_ell(gb.build_knn_graph(x, pos, k=8, depth=depth).graph,
                       max_degree=8)
    banded = band_ell(g, band_rows=256)
    h = np.random.default_rng(3).normal(size=(2048, 16)).astype(np.float32)
    tg = EllGraph(**{f: torch.from_numpy(np.array(getattr(g, f)))
                     for f in EllGraph.__dataclass_fields__})
    return g, banded, h, tg


LAYERS = {
    "heads2_concat": dict(out_channels=12, heads=2),
    "heads1_mean": dict(out_channels=12, heads=1, concat=False),
    "no_self_loops": dict(out_channels=12, heads=2, add_self_loops=False),
}


def _port_layer(cls, kw, params):
    # GATConvEllBanded on route C, as JAX's use_pallas=True
    extra = dict(use_pallas=True) if cls is GATConvEllBanded else {}
    m = cls(16, edge_dim=3, **kw, **extra)
    m.load_state_dict({k: torch.from_numpy(np.array(v))
                       for k, v in params.items()})
    return m.eval()


@pytest.mark.parametrize("case", sorted(LAYERS))
def test_banded_layer_matches_jax(knn_case, case):
    g, banded, h, tg = knn_case
    kw = LAYERS[case]
    jband = JaxGATConvEllBanded(edge_dim=3, use_pallas=True, **kw)
    v = jband.init(jax.random.PRNGKey(7), g, banded, h)
    # a nonzero bias, so the kernel's bias epilogue is exercised
    params = jax.tree_util.tree_map(np.array, v["params"])
    params["bias"] = np.random.default_rng(5).normal(
        0, 0.1, params["bias"].shape).astype(np.float32)
    v = {"params": params}
    want_pallas = np.asarray(jband.apply(v, g, banded, h))
    want_xla = np.asarray(JaxGATConvELL(edge_dim=3, **kw).apply(v, g, h))
    with torch.no_grad():
        got = _port_layer(GATConvEllBanded, kw, params)(
            tg, torch.from_numpy(h)).numpy()
        plain = _port_layer(GATConvELL, kw, params)(
            tg, torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want_pallas, **TOL)
    np.testing.assert_allclose(got, want_xla, **TOL)
    np.testing.assert_allclose(plain, want_xla, **TOL)
    assert not got[1500:].any()       # padded nodes are 0


def test_isolated_and_ragged_nodes(knn_case):
    """Nodes with fewer than K live slots and with none: the plain version
    against the port's GATConvELL (an isolated node keeps its self term
    only; without a self loop its output is 0 + bias)."""
    _, _, h, tg = knn_case
    mask = tg.nbr_mask.clone()
    mask[:40] = False
    mask[40:80, 3:] = False
    g2 = EllGraph(**{**tg.__dict__, "nbr_mask": mask})
    rg = np.random.default_rng(9)
    for kw in (LAYERS["heads2_concat"], LAYERS["no_self_loops"]):
        params = {}
        ref = GATConvELL(16, edge_dim=3, **kw)
        for name, p in ref.named_parameters():
            params[name] = rg.normal(0, 0.3, p.shape).astype(np.float32)
        with torch.no_grad():
            got = _port_layer(GATConvEllBanded, kw, params)(
                g2, torch.from_numpy(h))
            want = _port_layer(GATConvELL, kw, params)(
                g2, torch.from_numpy(h))
        torch.testing.assert_close(got, want, **TOL)
        if not kw.get("add_self_loops", True):
            bias = torch.from_numpy(params["bias"])
            torch.testing.assert_close(got[:40], bias.expand(40, -1))


def test_kernel_wrapper_has_no_backward(knn_case):
    """The serving entry (kernel C's inference form) still has no backward
    and raises under grad; the layer itself is differentiable (the training
    entry, kernels C and C' on the card): its gradients equal autograd of
    the plain GATConvELL on the same weights."""
    _, _, h, tg = knn_case
    layer = GATConvEllBanded(16, 12, heads=2, edge_dim=3,
                             use_pallas=True).eval()
    xh = (torch.from_numpy(h) @ layer.lin_src).detach().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ef.ell_gat_fused(xh, layer.att_src, layer.att_dst, tg.nbr_src,
                         tg.nbr_mask)
    plain = GATConvELL(16, 12, heads=2, edge_dim=3)
    plain.load_state_dict(layer.state_dict())
    w = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2048, 24)).astype(np.float32))
    grads = []
    for m in (layer.train(), plain.train()):
        x = torch.from_numpy(h).requires_grad_()
        (m(tg, x) * w).sum().backward()
        grads.append([x.grad] + [p.grad for p in m.parameters()])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=5e-4, atol=5e-5)


@pytest.fixture(scope="module")
def model_case(knn_case):
    g, banded, _, tg = knn_case
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
    want = JaxEllGNN(**kw, sparse_kernel="banded_pallas").apply(
        v, g, banded=banded)
    sd = state_dict_from_flax(params, stats, "coo")
    return tg, sd, {k: np.asarray(a) for k, a in want.items()}


@pytest.mark.parametrize("sparse_kernel", ["banded_pallas", "xla"])
def test_ell_model_matches_jax(model_case, sparse_kernel):
    tg, sd, want = model_case
    cfg = ModelConfig(hidden_channels=16, num_layers=2, heads=2)
    model = make_ell_model(cfg, 7, sparse_kernel=sparse_kernel)
    model.load_state_dict(coo_state_dict(sd))
    with torch.no_grad():
        got = model.eval()(tg)
    for key in ("class_logits", "confidence", "correction"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=5e-4,
                                   atol=5e-5, err_msg=key)


def test_non_gat_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        EllBathymetricGNN(7, gnn_type="GCN")


def test_reference_matches_layer_math(knn_case):
    """ell_gat_reference on a given xh equals the JAX GATConvELL on the
    same weights (its attention dots of xh, not of x @ (W att))."""
    g, _, h, tg = knn_case
    kw = LAYERS["heads2_concat"]
    v = JaxGATConvELL(edge_dim=3, **kw).init(jax.random.PRNGKey(2), g, h)
    want = np.asarray(JaxGATConvELL(edge_dim=3, **kw).apply(v, g, h))
    layer = _port_layer(GATConvELL, kw, jax.tree_util.tree_map(
        np.array, v["params"]))
    with torch.no_grad():
        xh = torch.from_numpy(h) @ layer.lin_src
        el, el_self = layer._edge_terms(tg)
        got = ef.ell_gat_reference(xh, layer.att_src, layer.att_dst,
                                   tg.nbr_src, tg.nbr_mask, el, el_self,
                                   bias=layer.bias, node_mask=tg.node_mask)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
