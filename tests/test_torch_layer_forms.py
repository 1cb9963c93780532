"""PyTorch port vs JAX: the layer forms the port used to refuse.

- ``GridGATConv`` with ``concat=False`` and 2 heads (the head mean): the
  output against the JAX layer's XLA form and its Pallas form (interpret
  mode: the kernel with a zero bias, then the head mean and the bias),
  with the folded BatchNorm epilogue against the Pallas form's, and the
  gradients of every parameter and of x against ``jax.grad`` of the XLA
  form (rtol 1e-4, atol 1e-5; the grid layer tests' own bounds are
  looser);
- ``GATConvELL`` in training mode with attention dropout 0.3: the JAX
  layer's Bernoulli masks (recorded from ``jax.random.bernoulli``) fed to
  the port's streamed-mask form; output and gradients against the JAX
  layer's (rtol 1e-5, atol 1e-6);
- ``inference/pipeline.apply_confidence_temperature`` against JAX's
  (``tests/test_inference.py:247-256``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.data.graph_build import build_grid_inputs
from bathymetric_gnn_tpu.inference import pipeline as jpipe
from bathymetric_gnn_tpu.models.conv_ell import GATConvELL as JaxGATConvELL
from bathymetric_gnn_tpu.models.grid_gat import GridGATConv as JaxGridGATConv
from bathymetric_gnn_tpu.ops.ell import EllGraph as JaxEllGraph
from bathymetric_gnn_tpu_torch.inference import pipeline as tpipe
from bathymetric_gnn_tpu_torch.models import conv_ell
from bathymetric_gnn_tpu_torch.models.grid_gat import GridGATConv
from bathymetric_gnn_tpu_torch.ops.ell import EllGraph

from conftest import make_ramp_surface

HEADS, C, F_IN = 2, 8, 12


def _np_params(params):
    return {k: torch.from_numpy(np.array(v)) for k, v in params.items()}


@pytest.fixture(scope="module")
def grid_case():
    depth = make_ramp_surface(16, 24)
    valid = np.ones(depth.shape, bool)
    valid[5:8, 3:9] = False
    feats, v, nbr, eattr, _ = build_grid_inputs(depth, valid)
    rg = np.random.default_rng(0)
    x = (rg.normal(size=(16, 24, F_IN)) * valid[..., None]
         ).astype(np.float32)
    layer = JaxGridGATConv(out_channels=C, heads=HEADS, concat=False)
    params = layer.init(jax.random.PRNGKey(1), x, v, nbr, eattr)["params"]
    params = dict(params, bias=jnp.asarray(rg.normal(0, 0.3, C),
                                           jnp.float32))
    port = GridGATConv(F_IN, C, heads=HEADS, concat=False)
    port.load_state_dict(_np_params(params))
    t = [torch.from_numpy(np.array(a))[None] for a in (x, v, nbr, eattr)]
    return dict(x=x, v=v, nbr=nbr, eattr=eattr, params=params, port=port,
                t=t)


def test_grid_head_mean_forward_matches_jax(grid_case):
    c = grid_case
    args = (c["x"], c["v"], c["nbr"], c["eattr"])
    xla = JaxGridGATConv(out_channels=C, heads=HEADS, concat=False).apply(
        {"params": c["params"]}, *args)
    pallas = JaxGridGATConv(out_channels=C, heads=HEADS, concat=False,
                            use_pallas=True).apply({"params": c["params"]},
                                                   *args)
    with torch.no_grad():
        got = c["port"].eval()(*c["t"])[0].numpy()
    assert got.shape == (16, 24, C)
    np.testing.assert_allclose(got, np.asarray(xla), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=1e-5,
                               atol=1e-6)


def test_grid_head_mean_folded_batchnorm_matches_jax(grid_case):
    c = grid_case
    rg = np.random.default_rng(2)
    sc = (rg.random(C) + 0.5).astype(np.float32)
    sh = rg.normal(0, 0.1, C).astype(np.float32)
    want = JaxGridGATConv(out_channels=C, heads=HEADS, concat=False,
                          use_pallas=True).apply(
        {"params": c["params"]}, c["x"], c["v"], c["nbr"], c["eattr"],
        bn_scale=jnp.asarray(sc), bn_bias=jnp.asarray(sh), fuse_relu=True)
    with torch.no_grad():
        got = c["port"].eval()(*c["t"], bn_scale=torch.from_numpy(sc),
                               bn_bias=torch.from_numpy(sh),
                               fuse_relu=True)[0].numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


def test_grid_head_mean_gradients_match_jax(grid_case):
    c = grid_case
    ct = np.random.default_rng(4).normal(size=(16, 24, C)).astype(
        np.float32)
    layer = JaxGridGATConv(out_channels=C, heads=HEADS, concat=False)

    def loss(params, x):
        out = layer.apply({"params": params}, x, c["v"], c["nbr"],
                          c["eattr"])
        return jnp.sum(out * ct)

    gp, gx = jax.grad(loss, argnums=(0, 1))(c["params"], c["x"])
    port = c["port"].train()
    x = c["t"][0].clone().requires_grad_()
    for p in port.parameters():
        p.grad = None
    (port(x, *c["t"][1:])[0] * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(x.grad[0].numpy(), np.asarray(gx),
                               rtol=1e-4, atol=1e-5)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def _ell_case(n=64, k=5, fe=3, seed=0):
    rg = np.random.default_rng(seed)
    nbr_src = rg.integers(0, n, (n, k)).astype(np.int32)
    nbr_mask = rg.random((n, k)) > 0.2
    nbr_mask[:3] = False                 # nodes with no live slot
    nbr_src[~nbr_mask] = 0
    node_mask = np.ones(n, bool)
    node_mask[-4:] = False
    arrays = dict(
        x=rg.normal(size=(n, F_IN)).astype(np.float32), nbr_src=nbr_src,
        nbr_mask=nbr_mask,
        edge_attr=(rg.normal(size=(n, k, fe)) * nbr_mask[..., None]
                   ).astype(np.float32),
        node_mask=node_mask, pos=np.zeros((n, 2), np.float32),
        local_std=np.ones(n, np.float32), graph_id=np.zeros(n, np.int32))
    return (JaxEllGraph(**{a: jnp.asarray(v) for a, v in arrays.items()}),
            EllGraph(**{a: torch.from_numpy(v) for a, v in arrays.items()}))


@pytest.mark.parametrize("concat", [True, False])
def test_ell_layer_dropout_matches_jax(monkeypatch, concat):
    p = 0.3
    jg, tg = _ell_case()
    layer = JaxGATConvELL(out_channels=C, heads=HEADS, concat=concat,
                          dropout=p, edge_dim=3)
    params = layer.init(jax.random.PRNGKey(0), jg, jg.x)["params"]
    rngs = {"dropout": jax.random.PRNGKey(7)}
    drawn = []
    real = jax.random.bernoulli

    def recording(key, prob, shape):
        out = real(key, prob, shape)
        drawn.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", recording)
    want = layer.apply({"params": params}, jg, jg.x, deterministic=False,
                       rngs=rngs)
    monkeypatch.setattr(jax.random, "bernoulli", real)
    keep, keep_self = drawn
    ct = np.random.default_rng(5).normal(size=want.shape).astype(np.float32)

    def loss(params, x):
        out = layer.apply({"params": params}, jg, x, deterministic=False,
                          rngs=rngs)
        return jnp.sum(out * ct)

    gp, gx = jax.grad(loss, argnums=(0, 1))(params, jg.x)

    # the same draw in the port's streamed layout [N, K+1, heads]
    dmask = torch.from_numpy(np.concatenate(
        [keep, keep_self[:, None]], 1).astype(np.float32) / (1 - p))
    masks = []

    def fed(generator, rate, n, k, heads):
        assert (rate, n, k, heads) == (p, *keep.shape[:2], HEADS)
        masks.append(dmask)
        return dmask

    monkeypatch.setattr(conv_ell, "make_ell_dropout_mask", fed)
    port = conv_ell.GATConvELL(F_IN, C, heads=HEADS, concat=concat,
                               edge_dim=3, dropout=p)
    port.load_state_dict(_np_params(params))
    port.train()
    x = tg.x.clone().requires_grad_()
    got = port(tg, x, torch.Generator().manual_seed(0))
    (got * torch.from_numpy(ct)).sum().backward()
    assert len(masks) == 1
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(gx), rtol=1e-4,
                               atol=1e-5)
    for name, prm in port.named_parameters():
        np.testing.assert_allclose(prm.grad.numpy(), np.asarray(gp[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)


def test_apply_confidence_temperature_matches_jax():
    c = np.linspace(0.01, 0.99, 50).astype(np.float32)
    for t in (0.5, 1.0, 2.5):
        got = tpipe.apply_confidence_temperature(c, t)
        np.testing.assert_allclose(got, jpipe.apply_confidence_temperature(
            c, t), rtol=1e-6)
        np.testing.assert_allclose(
            got, tpipe.apply_confidence_calibration(c, 1.0 / t, 0.0),
            rtol=1e-6)
        assert got.dtype == np.float32
