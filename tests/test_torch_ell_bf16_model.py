"""PyTorch port vs JAX: the bf16 ELL layer and model
(``compute_dtype="bfloat16"``).

On the k-NN graph of ``tests/test_torch_ell_banded.py`` (1,500 random points
padded to 2,048 nodes, k 8, 128-row bands), with the JAX package's Pallas
kernels in interpret mode:

- ``GATConvEllBanded(compute_dtype="bfloat16")`` serving on routes C, D and
  E against the JAX layer in the matching configuration (E against
  ``use_pallas=True, spill_in_kernel=False``, the Pallas band kernel): the
  output dtype is JAX's (bf16 on C and D, f32 on E), max |d| <= 1e-2 *
  max(|ref|, 1) and >= 99 % of the entries within one bf16 step;
- the same layer training on routes C and D with attention dropout, JAX's
  streamed draw captured and fed to the port: the output, x's gradient and
  every parameter's within a relative L2 error of 2e-2 and a worst entry of
  5e-2 of the leaf's largest |entry|;
- ``MaskedBatchNorm``'s bf16 eval pass (affine-folded, bf16 out) against
  JAX's, one bf16 step;
- ``EllBathymetricGNN(compute_dtype="bfloat16")`` (hidden 16, 2 layers,
  2 heads, random BatchNorm statistics) serving on ``"banded_pallas"``
  (route C), with ``wide_kernel=False`` (route D) and on ``"banded"``
  (route E; JAX's XLA form) against the JAX model: classes agree on
  >= 99 % of the live nodes, confidence within 1e-2; and one bf16 train
  step's gradients (batch-statistics BatchNorm through ``_bn_lowp``,
  dropout 0) on routes C and D against ``jax.grad`` of the JAX model, every
  parameter within 2e-2 of its norm plus twice the distance between JAX's
  bf16 gradient and the f32 one (measured: up to 5 % of a head bias's norm on
  route C, whose kernel sums spill messages unrounded; GAT biases that a
  batch-statistics BatchNorm cancels carry rounding noise only).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bathymetric_gnn_tpu.models.conv_ell as jce
import bathymetric_gnn_tpu.models.gnn_ell as jgnn
from bathymetric_gnn_tpu.models.layers import MaskedBatchNorm as JaxBN
from bathymetric_gnn_tpu.ops import ell_banded as jeb
from bathymetric_gnn_tpu_torch.config.config import ModelConfig
from bathymetric_gnn_tpu_torch.models import conv_ell as tce
from bathymetric_gnn_tpu_torch.models.gnn_ell import make_ell_model
from bathymetric_gnn_tpu_torch.models.layers import MaskedBatchNorm
from bathymetric_gnn_tpu_torch.ops import ell_banded as teb
from bathymetric_gnn_tpu_torch.utils.weights import (coo_state_dict,
                                                     state_dict_from_flax)

from test_torch_ell_banded import LAYERS, N, _port_graph, make_knn_ell
from test_torch_ell_bf16 import assert_bf16_close, assert_grad_close
from test_torch_ell_train import _port_mask

torch.set_num_threads(2)

R = 128
ROUTES = {
    "C": dict(use_pallas=True),
    "D": dict(use_pallas=True, wide_kernel=False),
    "E": dict(use_pallas=True, spill_in_kernel=False),
}
LIVE = 1500


@pytest.fixture(scope="module")
def case():
    g = make_knn_ell()
    rg = np.random.default_rng(3)
    x = rg.normal(size=(N, 16)).astype(np.float32)
    w = np.random.default_rng(13).normal(size=(N, 24)).astype(np.float32)
    return (g, jeb.band_ell(g, band_rows=R), _port_graph(g, tensors=True),
            teb.band_ell(_port_graph(g), band_rows=R).to("cpu"), x, w)


def _layers(route, kw, g, jb, x, dropout=0.0):
    """The JAX and the port's bf16 layer of one route, the same weights
    (and a nonzero bias)."""
    layer = jce.GATConvEllBanded(edge_dim=3, dropout=dropout,
                                 compute_dtype="bfloat16", **ROUTES[route],
                                 **kw)
    params = jax.tree_util.tree_map(
        np.array, layer.init(jax.random.PRNGKey(7), g, jb, x)["params"])
    params["bias"] = np.random.default_rng(5).normal(
        0, 0.1, params["bias"].shape).astype(np.float32)
    port = tce.GATConvEllBanded(16, edge_dim=3, dropout=dropout,
                                compute_dtype="bfloat16", **ROUTES[route],
                                **kw)
    port.load_state_dict({k: torch.from_numpy(np.array(v))
                          for k, v in params.items()})
    assert port.route == route
    return layer, params, port


@pytest.mark.parametrize("route,case_name,x_dtype", [
    ("C", "heads2_concat", "float32"), ("C", "heads1_mean", "bfloat16"),
    ("D", "heads2_concat", "float32"), ("D", "no_self_loops", "bfloat16"),
    ("E", "heads2_concat", "float32"), ("E", "no_self_loops", "bfloat16")])
def test_bf16_layer_routes_match_jax(case, route, case_name, x_dtype):
    """Serving, from an f32 input (the first layer's) or a bf16 one (a
    deeper layer's, after the bf16 BatchNorm)."""
    g, jb, tg, pb, x, _ = case
    xj = jnp.asarray(x).astype(x_dtype)
    layer, params, port = _layers(route, LAYERS[case_name], g, jb, x)
    want = layer.apply({"params": params}, g, jb, xj)
    with torch.no_grad():
        got = port.eval()(tg, torch.from_numpy(
            np.array(xj.astype(jnp.float32))).to(getattr(torch, x_dtype)),
            banded=pb)
    assert str(want.dtype) == str(got.dtype).split(".")[1], (want.dtype,
                                                             got.dtype)
    assert got.dtype == (torch.float32 if route == "E" else torch.bfloat16)
    assert_bf16_close(got.float().numpy(), want.astype(jnp.float32))
    assert not got[LIVE:].float().any()


@pytest.mark.parametrize("route", ["C", "D"])
def test_bf16_layer_trains_like_jax(case, route, monkeypatch):
    """Training with attention dropout 0.3 (routes C and D): JAX's
    streamed draw captured and mapped to the port's layout; the output,
    x's gradient and every parameter's against jax.grad."""
    g, jb, tg, pb, x, w = case
    p = 0.3
    kw = LAYERS["heads2_concat"]
    layer, params, port = _layers(route, kw, g, jb, x, dropout=p)
    captured = {}
    orig = jce.make_banded_dropout_masks

    def capture(*a, **k):
        captured["masks"] = orig(*a, **k)
        return captured["masks"]

    monkeypatch.setattr(jce, "make_banded_dropout_masks", capture)
    wj = jnp.asarray(w[:, :24])

    def loss(pr, xx):
        out = layer.apply({"params": pr}, g, jb, xx, False,
                          rngs={"dropout": jax.random.PRNGKey(321)})
        return jnp.sum(out.astype(jnp.float32) * wj), out

    (_, out_j), (gp_j, gx_j) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    masks = captured["masks"]
    k = tg.nbr_src.shape[1]
    if route == "C":
        dmask = torch.from_numpy(_port_mask(*masks, jb, N, k, kw["heads"]))
        monkeypatch.setattr(tce, "make_ell_dropout_mask",
                            lambda *a: dmask)
    else:
        monkeypatch.setattr(tce, "make_banded_dropout_masks", lambda *a: tuple(
            torch.from_numpy(np.array(m)) for m in masks))
    xt = torch.from_numpy(x).requires_grad_()
    out = port.train()(tg, xt, torch.Generator().manual_seed(0), banded=pb)
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(w[:, :24])).sum().backward()
    assert_bf16_close(out.detach().float().numpy(),
                      out_j.astype(jnp.float32), "out")
    assert_grad_close(xt.grad.numpy(), np.asarray(gx_j), "x")
    named = dict(port.named_parameters())
    for name, ref in gp_j.items():
        assert_grad_close(named[name].grad.numpy(), np.asarray(ref), name)


@pytest.mark.parametrize("relu", [True, False])
def test_bf16_batchnorm_eval_matches_jax(relu):
    rg = np.random.default_rng(0)
    f = 24
    x = jnp.asarray(rg.normal(0, 2, (512, f)), jnp.bfloat16)
    mask = rg.random(512) < 0.8
    stats = {"mean": rg.normal(0, 0.5, f).astype(np.float32),
             "var": rg.uniform(0.3, 3.0, f).astype(np.float32)}
    params = {"scale": rg.normal(1, 0.2, f).astype(np.float32),
              "bias": rg.normal(0, 0.2, f).astype(np.float32)}
    want = JaxBN(f).apply({"params": params, "batch_stats": stats}, x,
                          jnp.asarray(mask), True, fuse_relu=relu)
    bn = MaskedBatchNorm(f).eval()
    bn.load_state_dict({k: torch.from_numpy(v)
                        for k, v in {**params, **stats}.items()})
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).bfloat16()
    with torch.no_grad():
        got = bn(xt, torch.from_numpy(mask), fuse_relu=relu)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - np.asarray(want.astype(jnp.float32)))
    step = 2.0 ** (np.floor(np.log2(np.maximum(
        np.abs(np.asarray(want.astype(jnp.float32))), 1e-30))) - 7)
    assert bool((d <= step).all()) and (d == 0).mean() > 0.99
    assert not got[~torch.from_numpy(mask)].float().any()


MODEL = dict(hidden_channels=16, num_layers=2, heads=2)
SPARSE = {"C": ("banded_pallas", True), "D": ("banded_pallas", False),
          "E": ("banded", True)}


@pytest.fixture(scope="module")
def weights(case):
    """Random JAX ELL-model weights with random BatchNorm statistics, and
    the port's state_dict of them."""
    g = case[0]
    variables = jgnn.EllBathymetricGNN(**MODEL, dropout=0.0).init(
        jax.random.PRNGKey(0), g)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    rg = np.random.default_rng(11)
    for leaf in stats["GNNBackbone_0"].values():
        leaf["mean"] = rg.normal(0, 0.2, leaf["mean"].shape).astype(np.float32)
        leaf["var"] = rg.uniform(0.5, 2.0, leaf["var"].shape).astype(
            np.float32)
    return params, stats, coo_state_dict(state_dict_from_flax(params, stats,
                                                              "coo"))


def _jax_model(route, monkeypatch):
    sk, wide = SPARSE[route]
    if not wide:   # the JAX backbone has no switch: build its layers so
        monkeypatch.setattr(jgnn, "GATConvEllBanded", functools.partial(
            jce.GATConvEllBanded, wide_kernel=False))
    return jgnn.EllBathymetricGNN(**MODEL, dropout=0.0, sparse_kernel=sk,
                                  compute_dtype="bfloat16")


def _port_model(route, sd, dtype="bfloat16"):
    sk, wide = SPARSE[route]
    model = make_ell_model(ModelConfig(**MODEL), 7, sparse_kernel=sk,
                           compute_dtype=dtype)
    model.load_state_dict(sd)
    for i in range(MODEL["num_layers"]):
        conv = getattr(model.GNNBackbone_0, f"GATConv_{i}")
        conv.wide_kernel = wide
        assert conv.route == route and conv.compute_dtype == dtype
    return model


@pytest.mark.parametrize("route", ["C", "D", "E"])
def test_bf16_model_matches_jax(case, weights, route, monkeypatch):
    g, jb, tg, pb, _, _ = case
    params, stats, sd = weights
    want = _jax_model(route, monkeypatch).apply(
        {"params": params, "batch_stats": stats}, g, banded=jb)
    with torch.no_grad():
        got = _port_model(route, sd).eval()(tg, banded=pb)
    live = np.asarray(g.node_mask).astype(bool)
    for key in ("class_logits", "confidence", "correction"):
        assert got[key].dtype == torch.float32
        assert bool(torch.isfinite(got[key]).all())
    agree = (got["predicted_class"].numpy()[live]
             == np.asarray(want["predicted_class"])[live]).mean()
    dconf = np.abs(got["confidence"].numpy()[live]
                   - np.asarray(want["confidence"])[live]).max()
    assert agree >= 0.99 and dconf <= 1e-2, (agree, dconf)


@pytest.mark.parametrize("route", ["C", "D"])
def test_bf16_train_step_grads_match_jax(case, weights, route, monkeypatch):
    """One bf16 training forward (batch-statistics BatchNorm, dropout 0)
    and the gradient of a weighted sum of the three heads' outputs over
    the live nodes, every parameter against jax.grad of the JAX bf16 model.
    Through two layers, batch-statistics BatchNorm and the heads, bf16
    rounding is no longer small against every leaf (a GAT bias that a
    batch-statistics BatchNorm cancels has a gradient of rounding noise
    alone), so the tolerance is measured against bf16's own effect: per
    leaf, |port - JAX bf16| <= 2e-2 |JAX bf16| + 2 |JAX bf16 - f32| in L2,
    the f32 gradient taken from the port's f32 model, which the f32 tests
    hold against JAX's."""
    g, jb, tg, pb, _, w = case
    params, stats, sd = weights
    live = np.asarray(g.node_mask, np.float32)
    wl = jnp.asarray(w[:, :3] * live[:, None])
    wc = jnp.asarray(w[:, 3] * live)
    wr = jnp.asarray(w[:, 4] * live)

    def loss(p):
        out, _ = jmodel.apply({"params": p, "batch_stats": stats}, g,
                              deterministic=False, mutable=["batch_stats"],
                              banded=jb)
        return (jnp.sum(out["class_logits"] * wl)
                + jnp.sum(out["confidence"] * wc)
                + jnp.sum(out["correction"] * wr))

    def port_grads(dtype):
        model = _port_model(route, sd, dtype).train()
        out = model(tg, banded=pb)
        (torch.sum(out["class_logits"] * torch.from_numpy(np.array(wl)))
         + torch.sum(out["confidence"] * torch.from_numpy(np.array(wc)))
         + torch.sum(out["correction"] * torch.from_numpy(np.array(wr)))
         ).backward()
        return model

    jmodel = _jax_model(route, monkeypatch)
    want = coo_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jax.grad(loss)(params)), stats,
        "coo"))
    model = port_grads("bfloat16")
    # the f32 step's gradients, the port's (its f32 steps match JAX's:
    # tests/test_torch_knn_trainer.py, test_torch_ell_banded.py)
    g32 = {n: p.grad for n, p in port_grads("float32").named_parameters()}
    named = dict(model.named_parameters())
    assert sorted(named) == sorted(k for k in want if k in named)
    for name, p in named.items():
        ref = want[name].double()
        err = (p.grad.double() - ref).norm()
        noise = (ref - g32[name].double()).norm()
        assert err <= 2e-2 * ref.norm() + 2 * noise, (name, err, noise)
