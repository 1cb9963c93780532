"""PyTorch port vs JAX: GridBathymetricGNN with bridged weights, the
weight bridge itself (grid and COO layouts) and MaskedBatchNorm.

Weights come from a JAX init (hidden 16, 2 layers, heads 2) with random
BatchNorm statistics, go through ``utils/weights.state_dict_from_flax``
into the port, and both models see the same numpy inputs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.config.config import ModelConfig
from bathymetric_gnn_tpu.data.graph_build import GraphBuilder, build_grid_inputs
from bathymetric_gnn_tpu.models.gnn import make_model
from bathymetric_gnn_tpu.models.grid_gat import GridBathymetricGNN as JaxGNN
from bathymetric_gnn_tpu.models.grid_gat import params_from_coo as jax_from_coo
from bathymetric_gnn_tpu.models.layers import MaskedBatchNorm as JaxBN
from bathymetric_gnn_tpu_torch.models.grid_gat import GridBathymetricGNN
from bathymetric_gnn_tpu_torch.models.layers import MaskedBatchNorm
from bathymetric_gnn_tpu_torch.utils.weights import (flax_from_state_dict,
                                                     state_dict_from_flax)

from conftest import make_ramp_surface

torch.set_num_threads(2)

KW = dict(hidden_channels=16, num_layers=2, heads=2)
KEYS = ("class_logits", "confidence", "correction")


def _inputs(h=32, w=128, seed=0):
    rg = np.random.default_rng(seed)
    depth = make_ramp_surface(h, w, seed=seed)
    valid = np.ones((h, w), bool)
    valid[4:8, 20:60] = False
    valid[rg.random((h, w)) < 0.02] = False
    depth[~valid] = np.nan
    out = build_grid_inputs(np.nan_to_num(depth).astype(np.float32), valid)
    return tuple(np.array(a) for a in out[:4])


def _random_stats(tree, rg):
    """Non-trivial BatchNorm running stats, so the epilogue fold is
    exercised (an init has mean 0, var 1)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_stats(v, rg)
        elif k == "var":
            out[k] = rg.uniform(0.5, 2.0, v.shape).astype(np.float32)
        else:
            out[k] = rg.normal(0, 0.2, v.shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def jax_vars():
    feats, v, nbr, eattr = _inputs()
    variables = JaxGNN(**KW).init(jax.random.PRNGKey(0), feats, v, nbr,
                                  eattr)
    rg = np.random.default_rng(1)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    for i in range(KW["num_layers"]):
        bn = params[f"MaskedBatchNorm_{i}"]
        bn["scale"] = rg.uniform(0.5, 1.5, bn["scale"].shape).astype(
            np.float32)
        bn["bias"] = rg.normal(0, 0.1, bn["bias"].shape).astype(np.float32)
    stats = _random_stats(variables["batch_stats"], rg)
    return params, stats


def _port_model(params, stats, layout="grid", compute_dtype=torch.float32):
    sd = state_dict_from_flax(params, stats, layout)
    in_ch = sd["MLPFeatureExtractor_0.TorchLinear_0.kernel"].shape[0]
    m = GridBathymetricGNN(in_ch, compute_dtype=compute_dtype, **KW)
    m.load_state_dict(sd)
    return m.eval()


def _port_apply(model, inputs):
    with torch.no_grad():
        out = model(*(torch.from_numpy(a)[None] for a in inputs))
    return {k: v[0].float().numpy() for k, v in out.items()}


@pytest.mark.parametrize("use_pallas", [False, True])
def test_model_matches_jax(jax_vars, use_pallas):
    """Port (CPU: plain layer version, BN folded into the epilogue) vs the
    JAX model on its XLA path and on its Pallas path (interpret): logits,
    confidence and correction within 2e-3, the tolerance
    tests/test_pallas_fused.py uses between those two JAX paths; classes
    agree everywhere but at logit near-ties."""
    params, stats = jax_vars
    inputs = _inputs()
    want = JaxGNN(**KW, use_pallas=use_pallas).apply(
        {"params": params, "batch_stats": stats}, *inputs)
    got = _port_apply(_port_model(params, stats), inputs)
    for key in KEYS:
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=2e-3, atol=2e-3, err_msg=key)
    agree = np.mean(got["predicted_class"]
                    == np.asarray(want["predicted_class"]))
    assert agree > 0.999, agree


def test_model_bf16_close_to_jax_pallas_bf16(jax_vars):
    """bf16 layer I/O on both sides (port plain version vs JAX Pallas
    interpret): per-layer bf16 roundings may flip differently (see
    test_torch_grid_gat_kernel), so hold classes (>99% agree) and
    confidence (atol 2e-2), as tests/test_pallas_fused.py holds bf16."""
    params, stats = jax_vars
    inputs = _inputs()
    want = JaxGNN(**KW, use_pallas=True, compute_dtype="bfloat16").apply(
        {"params": params, "batch_stats": stats}, *inputs)
    got = _port_apply(_port_model(params, stats,
                                  compute_dtype=torch.bfloat16), inputs)
    agree = np.mean(got["predicted_class"]
                    == np.asarray(want["predicted_class"]))
    assert agree > 0.99, agree
    np.testing.assert_allclose(got["confidence"],
                               np.asarray(want["confidence"], np.float32),
                               atol=2e-2)


def test_train_mode_batch_stats_match_jax(jax_vars):
    """Train mode (no epilogue fold): MaskedBatchNorm normalizes with the
    masked batch moments and updates the running stats (unbiased), as
    the JAX model with use_running_average=False. f32: 2e-3 on outputs,
    1e-4 relative on the updated stats."""
    params, stats = jax_vars
    inputs = _inputs()
    want, upd = JaxGNN(**KW).apply(
        {"params": params, "batch_stats": stats}, *inputs,
        deterministic=True, use_running_average=False,
        mutable=["batch_stats"])
    model = _port_model(params, stats).train()
    with torch.no_grad():
        got = model(*(torch.from_numpy(a)[None] for a in inputs))
    for key in KEYS:
        np.testing.assert_allclose(got[key][0].numpy(),
                                   np.asarray(want[key]), rtol=2e-3,
                                   atol=2e-3, err_msg=key)
    _, new_stats = flax_from_state_dict(model.state_dict())
    for name, leaf in new_stats.items():
        for s in ("mean", "var"):
            np.testing.assert_allclose(
                leaf[s], np.asarray(upd["batch_stats"][name][s]),
                rtol=1e-4, atol=1e-5, err_msg=f"{name}.{s}")


def test_masked_batchnorm_train_matches_jax():
    """MaskedBatchNorm alone, both modes, with padded rows masked out."""
    rg = np.random.default_rng(5)
    x = rg.normal(3.0, 2.0, (50, 6)).astype(np.float32)
    mask = rg.random(50) > 0.3
    x[~mask] = 1e3  # padding must not reach the moments
    jbn = JaxBN(6)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(mask))
    y_j, upd = jbn.apply(variables, jnp.asarray(x), jnp.asarray(mask),
                         fuse_relu=True, mutable=["batch_stats"])
    bn = MaskedBatchNorm(6).train()
    y_t = bn(torch.from_numpy(x), torch.from_numpy(mask), fuse_relu=True)
    np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    for s in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, s).numpy(),
                                   np.asarray(upd["batch_stats"][s]),
                                   rtol=1e-5, atol=1e-6)
    y_j2 = jbn.apply({"params": variables["params"], **upd},
                     jnp.asarray(x), jnp.asarray(mask),
                     use_running_average=True)
    y_t2 = bn.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(y_t2.detach().numpy(), np.asarray(y_j2),
                               rtol=1e-5, atol=1e-5)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


def test_bridge_round_trip_grid(jax_vars):
    params, stats = jax_vars
    p2, s2 = flax_from_state_dict(state_dict_from_flax(params, stats))
    for tree, back in ((params, p2), (stats, s2)):
        a, b = dict(_leaves(tree)), dict(_leaves(back))
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_bridge_coo_layout():
    """A COO-layout (graph Trainer) checkpoint drives the port's grid
    model: same outputs as the JAX grid model on ``params_from_coo``."""
    cfg = ModelConfig(**KW)
    depth = make_ramp_surface(24, 24)
    gb = GraphBuilder()
    bg = gb.build_graph(depth, np.ones_like(depth, bool))
    variables = make_model(cfg, in_channels=7, edge_dim=3).init(
        jax.random.PRNGKey(2), bg.graph)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = _random_stats(variables["batch_stats"],
                          np.random.default_rng(3))
    assert "GNNBackbone_0" in params
    inputs = _inputs(24, 40, seed=4)
    want = JaxGNN(**KW).apply(
        {"params": jax_from_coo(params, 2),
         "batch_stats": jax_from_coo(stats, 2)}, *inputs)
    got = _port_apply(_port_model(params, stats, layout="coo"), inputs)
    for key in KEYS:
        np.testing.assert_allclose(got[key], np.asarray(want[key]),
                                   rtol=2e-3, atol=2e-3, err_msg=key)
