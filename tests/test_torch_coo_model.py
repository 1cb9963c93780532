"""PyTorch port vs JAX: the COO conv layers and the COO model.

A random padded graph (node 7 isolated, node 11 with no incoming edge,
pads at N - 1; hidden 16 / 2 layers / 2 heads, plus one default-width
model on a graph of a few hundred nodes) goes through the JAX modules of
``models/conv.py`` and ``models/gnn.py`` and through the port's
``models/conv.py`` and ``models/gnn.py`` (on the CPU: kernel F's plain
version behind every segment sum) with the same weights (the full model
through the weight bridge: flax COO tree -> grid-named state_dict -> the
model's keys):

- each conv layer (GAT heads 1 / 2, concat or head mean, with and without
  edge attributes; GCN; SAGE; GIN) within atol 2e-5, and its gradients
  (input and parameters) against ``jax.grad`` within rtol 5e-4;
- ``BathymetricGNN`` of all four types in eval mode (random BatchNorm
  statistics): classes >= 99.9 % equal, confidence within 2e-3;
  ``predict_with_thresholds``; the parameter count at the default config;
- the model's gradients in training mode (batch statistics, dropout 0)
  against ``jax.grad`` within rtol 5e-4;
- GAT at dropout 0.3 with JAX's keep masks streamed into the port's layer;
- the weight bridge of each type: a JAX tree -> port -> checkpoint ->
  port -> flax gives the same arrays.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.models import conv as jconv
from bathymetric_gnn_tpu.models import gnn as jgnn
from bathymetric_gnn_tpu.ops.graph import make_padded_graph as jax_padded
from bathymetric_gnn_tpu_torch.config.config import ModelConfig
from bathymetric_gnn_tpu_torch.models import conv as tconv
from bathymetric_gnn_tpu_torch.models import gnn as tgnn
from bathymetric_gnn_tpu_torch.ops.graph import CooGraph, make_padded_graph
from bathymetric_gnn_tpu_torch.utils.weights import (coo_state_dict,
                                                     flax_from_state_dict,
                                                     grid_state_dict,
                                                     load_state_dict,
                                                     save_checkpoint,
                                                     state_dict_from_flax)

torch.set_num_threads(2)

TYPES = ("GAT", "GCN", "GraphSAGE", "GIN")
LAYER_TOL = dict(rtol=2e-5, atol=2e-5)


def graphs(n=60, n_pad=64, deg=6, seed=0, f=7, fe=3):
    """The same random graph as a JAX PaddedGraph and a port CooGraph (of
    CPU tensors, with both tables)."""
    rg = np.random.default_rng(seed)
    src = rg.integers(0, n, n * deg)
    dst = rg.integers(0, n, n * deg)
    keep = (src != 7) & (dst != 7) & (dst != 11)
    ei = np.stack([src[keep], dst[keep]])
    x = rg.normal(size=(n, f)).astype(np.float32)
    attr = rg.normal(size=(ei.shape[1], fe)).astype(np.float32)
    kw = dict(n_pad=n_pad, e_pad=n_pad * deg)
    jg = jax_padded(x, ei, attr if fe else None, **kw)
    tg = CooGraph.from_padded(make_padded_graph(
        x, ei, attr if fe else None, **kw)).to("cpu")
    return jg, tg


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = torch.from_numpy(np.array(v))
    return out


@pytest.fixture(scope="module")
def case():
    jg, tg = graphs()
    h = np.random.default_rng(3).normal(size=(64, 16)).astype(np.float32)
    return jg, tg, h


GAT = {
    "heads2_concat_edges": dict(out_channels=12, heads=2, edge_dim=3),
    "heads1_mean_edges": dict(out_channels=12, heads=1, concat=False,
                              edge_dim=3),
    "heads2_mean_no_edges": dict(out_channels=12, heads=2, concat=False),
    "heads1_concat_no_edges": dict(out_channels=12, heads=1),
}
OTHER = {"GCN": (jconv.GCNConv, tconv.GCNConv),
         "SAGE": (jconv.SAGEConv, tconv.SAGEConv),
         "GIN": (jconv.GINConv, tconv.GINConv)}


def _layer_pair(name, in_channels=16):
    """(JAX module, port module class, port kwargs) of a layer case."""
    if name in GAT:
        kw = GAT[name]
        return (jconv.GATConv(**kw), tconv.GATConv,
                dict(kw, in_channels=in_channels))
    jcls, tcls = OTHER[name]
    return jcls(12), tcls, dict(in_channels=in_channels, out_channels=12)


def _port(tcls, kw, params):
    kw = dict(kw)
    out = kw.pop("out_channels")
    m = tcls(kw.pop("in_channels"), out, **kw)
    m.load_state_dict(flat(params))
    return m


@pytest.mark.parametrize("name", sorted(GAT) + sorted(OTHER))
def test_layer_and_its_gradients_match_jax(case, name):
    jg, tg, h = case
    jmod, tcls, kw = _layer_pair(name)
    params = jax.jit(jmod.init)(jax.random.PRNGKey(1), jg, h)["params"]
    if "bias" in params:    # a nonzero bias, so it is exercised
        params = dict(params, bias=jnp.linspace(-0.5, 0.5,
                                                params["bias"].shape[0]))
    want = np.asarray(jmod.apply({"params": params}, jg, h))
    layer = _port(tcls, kw, params).eval()
    x = torch.from_numpy(h).requires_grad_(True)
    got = layer(tg, x)
    np.testing.assert_allclose(got.detach().numpy(), want, **LAYER_TOL)
    assert np.abs(want[~np.asarray(jg.node_mask)]).max() == 0.0
    # an isolated node attends only to itself
    assert np.isfinite(want[7]).all()

    cot = np.random.default_rng(4).normal(size=want.shape).astype(
        np.float32)

    def jloss(p, xx):
        return jnp.sum(jmod.apply({"params": p}, jg, xx) * cot)

    gp, gx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(params,
                                                       jnp.asarray(h))
    (got * torch.from_numpy(cot)).sum().backward()
    grads = dict(flat(gp), x=torch.from_numpy(np.array(gx)))
    ports = dict(layer.named_parameters(), x=x)
    for k, want_g in grads.items():
        g_ = ports[k].grad.numpy()
        scale = np.abs(want_g.numpy()).max()
        np.testing.assert_allclose(g_, want_g.numpy(), rtol=5e-4,
                                   atol=5e-4 * scale + 1e-7, err_msg=k)


def test_gat_dropout_with_streamed_masks_matches_jax(case):
    """JAX's GATConv at dropout 0.3 (its two keep masks recorded from
    ``jax.random.bernoulli``) and the port's layer given the same masks."""
    jg, tg, h = case
    kw = dict(out_channels=12, heads=2, edge_dim=3, dropout=0.3)
    jmod = jconv.GATConv(**kw)
    params = jmod.init(jax.random.PRNGKey(1), jg, h)["params"]
    masks = []
    real = jax.random.bernoulli

    def record(*a, **k):
        masks.append(real(*a, **k))
        return masks[-1]

    with mock.patch.object(jax.random, "bernoulli", record):
        want = np.asarray(jmod.apply({"params": params}, jg, h,
                                     deterministic=False,
                                     rngs={"dropout": jax.random.PRNGKey(9)}))
    assert [m.shape for m in masks] == [(jg.edge_src.shape[0], 2), (64, 2)]
    layer = _port(tconv.GATConv, dict(kw, in_channels=16), params).train()
    keep = tuple(torch.from_numpy(np.array(m)) for m in masks)
    got = layer(tg, torch.from_numpy(h), attn_keep=keep)
    np.testing.assert_allclose(got.detach().numpy(), want, **LAYER_TOL)
    # dropped weights differ from the eval-mode output
    assert np.abs(want - np.asarray(jmod.apply({"params": params}, jg, h))
                  ).max() > 1e-3
    # without streamed masks the port draws its own from the generator
    got2 = layer(tg, torch.from_numpy(h),
                 dropout_rng=torch.Generator().manual_seed(0))
    assert got2.shape == got.shape and torch.isfinite(got2).all()


def _jax_model(gnn_type, jg, hidden=16, layers=2, heads=2, seed=0):
    """The JAX model and its variables (random BatchNorm statistics)."""
    jm = jgnn.BathymetricGNN(hidden_channels=hidden, num_layers=layers,
                             heads=heads, gnn_type=gnn_type, dropout=0.0)
    v = jax.jit(jm.init)(jax.random.PRNGKey(seed), jg)
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    rg = np.random.default_rng(seed + 10)
    stats = jax.tree_util.tree_map(
        lambda a: (rg.uniform(0.5, 2.0, a.shape) if a.ndim else a
                   ).astype(np.float32), v["batch_stats"])
    stats = {"GNNBackbone_0": {
        k: {"mean": rg.normal(0, 0.3, s["mean"].shape).astype(np.float32),
            "var": s["var"]}
        for k, s in stats["GNNBackbone_0"].items()}}
    return jm, {"params": params, "batch_stats": stats}


def _port_model(gnn_type, jg, v, hidden=16, layers=2, heads=2):
    """A new port model holding the JAX variables ``v``."""
    cfg = ModelConfig(hidden_channels=hidden, num_layers=layers, heads=heads,
                      gnn_type=gnn_type, dropout=0.0)
    tm = tgnn.make_model(cfg, int(jg.x.shape[-1]))
    tm.load_state_dict(coo_state_dict(state_dict_from_flax(
        v["params"], v["batch_stats"], "coo")))
    return tm


@pytest.fixture(scope="module")
def models(case):
    """models(gnn_type) -> (JAX model, variables, a new port model) on the
    case graph; the JAX model is initialised once for each type."""
    jg = case[0]
    made = {}

    def get(gnn_type):
        if gnn_type not in made:
            made[gnn_type] = _jax_model(gnn_type, jg)
        jm, v = made[gnn_type]
        return jm, v, _port_model(gnn_type, jg, v)

    return get


def _check_outputs(got, want, classes=0.999, conf=2e-3):
    agree = np.mean(got["predicted_class"].numpy()
                    == np.asarray(want["predicted_class"]))
    assert agree >= classes, agree
    np.testing.assert_allclose(got["confidence"].detach().numpy(),
                               np.asarray(want["confidence"]), atol=conf)
    for k in ("class_logits", "correction", "node_embedding"):
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), rtol=5e-4,
                                   atol=5e-4, err_msg=k)


@pytest.mark.parametrize("gnn_type", TYPES)
def test_model_matches_jax(case, models, gnn_type):
    jg, tg, _ = case
    jm, v, tm = models(gnn_type)
    want = jgnn.predict_with_thresholds(jax.jit(jm.apply)(v, jg), 0.5,
                                        0.45)
    with torch.no_grad():
        got = tgnn.predict_with_thresholds(tm.eval()(tg), 0.5, 0.45)
    _check_outputs(got, want)
    for k in ("action", "auto_correct", "needs_review"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)


@pytest.mark.parametrize("gnn_type", ["GAT", "GIN"])
def test_default_width_model_matches_jax(gnn_type):
    """hidden 64, 4 layers, 4 heads on a graph of a few hundred nodes."""
    jg, tg = graphs(n=300, n_pad=320, deg=8, seed=5)
    wide = dict(hidden=64, layers=4, heads=4)
    jm, v = _jax_model(gnn_type, jg, seed=2, **wide)
    tm = _port_model(gnn_type, jg, v, **wide)
    with torch.no_grad():
        got = tm.eval()(tg)
    _check_outputs(got, jax.jit(jm.apply)(v, jg))


def test_parameter_count_at_default_config():
    jg, _ = graphs()
    cfg = ModelConfig()
    for t in TYPES:
        jm = jgnn.BathymetricGNN(hidden_channels=cfg.hidden_channels,
                                 num_layers=cfg.num_layers, heads=cfg.heads,
                                 gnn_type=t)
        n_jax = sum(int(np.prod(p.shape)) for p in jax.tree_util.tree_leaves(
            jax.eval_shape(jm.init, jax.random.PRNGKey(0), jg)["params"]))
        cfg.gnn_type = t
        tm = tgnn.make_model(cfg, 7)
        assert sum(p.numel() for p in tm.parameters()) == n_jax, t


@pytest.mark.parametrize("gnn_type", TYPES)
def test_model_gradients_match_jax(case, models, gnn_type):
    """Training mode (batch statistics), dropout 0: the gradient of a
    loss on every output of every parameter, against jax.grad."""
    jg, tg, _ = case
    jm, v, tm = models(gnn_type)
    rg = np.random.default_rng(6)
    cl = rg.normal(size=(64, 3)).astype(np.float32)
    cc = rg.normal(size=64).astype(np.float32)

    def jloss(p):
        out, _ = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, jg,
                          deterministic=True, use_running_average=False,
                          mutable=["batch_stats"])
        return (jnp.sum(out["class_logits"] * cl)
                + jnp.sum((out["confidence"] + out["correction"]) * cc))

    want = flat(jax.jit(jax.grad(jloss))(v["params"]))
    tm.train()
    out = tm(tg)
    (torch.sum(out["class_logits"] * torch.from_numpy(cl))
     + torch.sum((out["confidence"] + out["correction"])
                 * torch.from_numpy(cc))).backward()
    got = dict(tm.named_parameters())
    top = max(np.abs(w.numpy()).max() for w in want.values())
    for k, w in want.items():
        g_ = got[k].grad.numpy()
        np.testing.assert_allclose(g_, w.numpy(), rtol=5e-4,
                                   atol=5e-4 * np.abs(w.numpy()).max()
                                   + 1e-6 * top, err_msg=k)


@pytest.mark.parametrize("gnn_type", TYPES)
def test_weight_bridge_round_trip(models, gnn_type, tmp_path):
    """A JAX COO tree -> the port's state_dict -> a port checkpoint -> the
    port's model -> a flax tree again: the same arrays, the backbone
    included (the bridge used to drop a non-GAT backbone)."""
    _, v, tm = models(gnn_type)
    sd = state_dict_from_flax(v["params"], v["batch_stats"], "coo")
    conv = tgnn.CONV_NAMES[gnn_type]
    top = {k.split(".")[0] for k in sd}
    assert {f"{'GridGATConv' if gnn_type == 'GAT' else conv}_{i}"
            for i in range(2)} <= top
    save_checkpoint(tmp_path / "ckpt", sd, meta={"param_layout": "coo"})
    sd2, meta = load_state_dict(tmp_path / "ckpt")
    assert meta["trained_layout"] == "coo"
    tm.load_state_dict(coo_state_dict(sd2))
    assert grid_state_dict(tm.state_dict()).keys() == sd.keys()
    params, stats = flax_from_state_dict(coo_state_dict(sd2))
    want_p, got_p = flat(v["params"]), flat(params)
    want_s, got_s = flat(v["batch_stats"]), flat(stats)
    assert got_p.keys() == want_p.keys() and got_s.keys() == want_s.keys()
    for k in want_p:
        np.testing.assert_array_equal(got_p[k].numpy(), want_p[k].numpy())
    for k in want_s:
        np.testing.assert_array_equal(got_s[k].numpy(), want_s[k].numpy())
