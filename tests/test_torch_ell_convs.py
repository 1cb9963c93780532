"""PyTorch port vs JAX: the GCN, GraphSAGE and GIN layers on the ELL
layout and the ELL model of each type.

A random padded graph (node 7 isolated, node 11 with no incoming edge) is
packed into the ELL layout by each package's ``coo_to_ell`` and goes
through ``GCNConvELL``, ``SAGEConvELL`` and ``GINConvELL`` of both
packages with the same weights (atol 2e-5), and through
``EllBathymetricGNN`` of every type (hidden 16, 2 layers, 2 heads, random
BatchNorm statistics, the weights through the bridge): classes >= 99.9 %
equal, confidence within 2e-3, and on the default route's slab ELL graphs
through ``NativeVRProcessor`` in ``tests/test_torch_coo_serving.py``.
"""

import jax
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.models import conv_ell as jce
from bathymetric_gnn_tpu.models.gnn_ell import EllBathymetricGNN as JaxEll
from bathymetric_gnn_tpu.ops.ell import coo_to_ell as jax_coo_to_ell
from bathymetric_gnn_tpu.ops.graph import make_padded_graph as jax_padded
from bathymetric_gnn_tpu_torch.config.config import ModelConfig
from bathymetric_gnn_tpu_torch.models import conv_ell as tce
from bathymetric_gnn_tpu_torch.models.gnn_ell import make_ell_model
from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell
from bathymetric_gnn_tpu_torch.ops.graph import make_padded_graph
from bathymetric_gnn_tpu_torch.utils.weights import (coo_state_dict,
                                                     state_dict_from_flax)

from test_torch_coo_model import flat

torch.set_num_threads(2)

K = 12


@pytest.fixture(scope="module")
def case():
    rg = np.random.default_rng(0)
    n, n_pad = 90, 96
    src = rg.integers(0, n, n * 6)
    dst = rg.integers(0, n, n * 6)
    keep = (src != 7) & (dst != 7) & (dst != 11)
    ei = np.stack([src[keep], dst[keep]])
    # bounded in-degree for the ELL width
    order = np.argsort(ei[1], kind="stable")
    ei = ei[:, order]
    rank = np.arange(ei.shape[1]) - np.searchsorted(ei[1], ei[1])
    ei = ei[:, rank < K]
    x = rg.normal(size=(n, 7)).astype(np.float32)
    attr = rg.normal(size=(ei.shape[1], 3)).astype(np.float32)
    kw = dict(n_pad=n_pad, e_pad=n_pad * K)
    jg = jax_coo_to_ell(jax_padded(x, ei, attr, **kw), max_degree=K)
    tg = coo_to_ell(make_padded_graph(x, ei, attr, **kw),
                    max_degree=K).to("cpu")
    h = rg.normal(size=(n_pad, 16)).astype(np.float32)
    return jg, tg, h


LAYERS = {"GCN": (jce.GCNConvELL, tce.GCNConvELL),
          "SAGE": (jce.SAGEConvELL, tce.SAGEConvELL),
          "GIN": (jce.GINConvELL, tce.GINConvELL)}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(case, name):
    jg, tg, h = case
    jcls, tcls = LAYERS[name]
    params = jax.jit(jcls(12).init)(jax.random.PRNGKey(1), jg, h)["params"]
    if "bias" in params:
        params = dict(params, bias=np.linspace(-0.5, 0.5, 12,
                                               dtype=np.float32))
    want = np.asarray(jcls(12).apply({"params": params}, jg, h))
    layer = tcls(16, 12)
    layer.load_state_dict(flat(params))
    with torch.no_grad():
        got = layer.eval()(tg, torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    assert np.abs(got.numpy()[~np.asarray(jg.node_mask)]).max() == 0.0


@pytest.mark.parametrize("gnn_type", ["GAT", "GCN", "GraphSAGE", "GIN"])
def test_ell_model_of_each_type_matches_jax(case, gnn_type):
    jg, tg, _ = case
    kw = dict(hidden_channels=16, num_layers=2, heads=2)
    jm = JaxEll(**kw, gnn_type=gnn_type, dropout=0.0)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jg)
    params = jax.tree_util.tree_map(np.array, v["params"])
    stats = jax.tree_util.tree_map(np.array, v["batch_stats"])
    rg = np.random.default_rng(3)
    for leaf in stats["GNNBackbone_0"].values():
        leaf["mean"] = rg.normal(0, 0.2, leaf["mean"].shape).astype(
            np.float32)
        leaf["var"] = rg.uniform(0.5, 2.0, leaf["var"].shape).astype(
            np.float32)
    want = jax.jit(jm.apply)({"params": params, "batch_stats": stats}, jg)
    model = make_ell_model(ModelConfig(**kw, gnn_type=gnn_type), 7)
    model.load_state_dict(coo_state_dict(state_dict_from_flax(
        params, stats, "coo")))
    with torch.no_grad():
        got = model.eval()(tg)
    agree = np.mean(got["predicted_class"].numpy()
                    == np.asarray(want["predicted_class"]))
    assert agree >= 0.999, agree
    np.testing.assert_allclose(got["confidence"].numpy(),
                               np.asarray(want["confidence"]), atol=2e-3)
    np.testing.assert_allclose(got["class_logits"].numpy(),
                               np.asarray(want["class_logits"]), rtol=5e-4,
                               atol=5e-5)
