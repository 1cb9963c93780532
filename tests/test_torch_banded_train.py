"""PyTorch port vs JAX: training on the ``sparse_kernel="banded"`` route.

The JAX trainer trains there at dropout 0: its layers run
``use_pallas=False``, the XLA band part and spill pass
(``ops/ell_banded.banded_gat_band_part_xla`` + ``banded_gat_spill_pass``)
that ``jax.grad`` differentiates, with no Pallas kernel on the way. The
port's ``GATConvEllBanded`` on route E runs the same math, differentiated
by autograd, whenever a gradient is wanted (it serves through kernel E).

- the layer in training mode (routes "E" and "E_xla", dropout 0) against
  ``jax.grad`` of JAX's XLA route: the output, x's gradient and every
  parameter's within rtol 5e-4 / atol 5e-5, the JAX package's tolerance
  for its fused backward;
- one ``Trainer`` step (hidden 16, 2 layers, 2 heads, f32) against the JAX
  trainer's on the same weights and batch: every loss term and the
  gradient the step clips and hands to AdamW, leaf by leaf, within rtol
  5e-4 / atol 5e-5 (the losses' scale), and the BatchNorm statistics after
  the step within the same;
- ``Trainer.train`` for one epoch on the CPU on this route: checkpoints and
  ``calibration.json`` written, finite losses;
- with dropout > 0 both trainers refuse, with JAX's own words.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.models.gnn import make_model as jax_make_model
from bathymetric_gnn_tpu.training import datasets as jds
from bathymetric_gnn_tpu.training import trainer as jtr
from bathymetric_gnn_tpu_torch.training import datasets as tds
from bathymetric_gnn_tpu_torch.training import optim as topt
from bathymetric_gnn_tpu_torch.training import trainer as ttr
from bathymetric_gnn_tpu_torch.utils.weights import (coo_state_dict,
                                                     state_dict_from_flax)

from test_torch_ell_banded import (LAYERS, _jax_layer, _params, _port_graph,
                                   _port_layer, band_pairs,  # noqa: F401
                                   knn_case)  # noqa: F401
from test_torch_knn_graph import ensure_jax_native_kit
from test_torch_knn_trainer import Fixed, _configs, _grids

torch.set_num_threads(2)

TOL = dict(rtol=5e-4, atol=5e-5)
LR = 1e-3


@pytest.mark.parametrize("route", ["E", "E_xla"])
@pytest.mark.parametrize("case", ["heads2_concat", "no_self_loops"])
def test_route_e_trains_like_jax_xla(knn_case, band_pairs, route, case):
    """Route E in training mode at dropout 0 (the plain band part and
    spill pass under autograd) against jax.grad of the JAX layer with
    use_pallas=False: output, d x and every parameter's gradient."""
    g, x, w = knn_case
    jb, pb = band_pairs[128]
    kw = LAYERS[case]
    layer = _jax_layer("E_xla", kw)
    params = _params(layer, g, jb, x)

    def loss(p, xx):
        out = layer.apply({"params": p}, g, jb, xx, False)
        return jnp.sum(out * w[:, :out.shape[1]]), out

    (_, out_j), (gp_j, gx_j) = jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True)(params, x)
    port = _port_layer(route, kw, params).train()
    assert port.route == "E"
    xt = torch.from_numpy(x).requires_grad_()
    out = port(_port_graph(g, tensors=True), xt, banded=pb)
    (out * torch.from_numpy(w[:, :out.shape[1]])).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j), **TOL)
    named = dict(port.named_parameters())
    for name, ref in gp_j.items():
        np.testing.assert_allclose(named[name].grad.numpy(), np.asarray(ref),
                                   **TOL, err_msg=name)


def _banded_configs(dropout=0.0):
    jcfg, cfg = _configs(dropout)
    for c in (jcfg, cfg):
        c.model.sparse_kernel = "banded"
    return jcfg, cfg


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    """The JAX and the port trainers on the ``"banded"`` route on the same
    fixed samples, the port's model holding the JAX model's weights."""
    ensure_jax_native_kit()   # not JAX's NumPy k-NN: it breaks ties apart
    jcfg, cfg = _banded_configs()
    jfix = Fixed(jds.SyntheticTileDataset(_grids(), jcfg, tile_size=32,
                                          overlap=8, seed=5))
    tfix = Fixed(tds.SyntheticTileDataset(_grids(), cfg, tile_size=32,
                                          overlap=8, seed=5))
    sample = jfix[0]
    jt = jtr.Trainer(jcfg, jax_make_model(jcfg.model,
                                          sample.graph.x.shape[-1],
                                          sample.graph.edge_attr.shape[-1]),
                     jfix, output_dir=str(tmp_path_factory.mktemp("jax")))
    assert jt.sparse_kernel == "banded"
    jstate = jt.init_state(sample.graph)
    tt = ttr.Trainer(cfg, tfix, output_dir=str(tmp_path_factory.mktemp(
        "port")), device="cpu")
    assert tt.sparse_kernel == "banded"
    tt.huber_delta = jt.huber_delta     # the step check starts level
    tstate = tt.init_state(tfix[0].graph)
    tstate.model.load_state_dict(coo_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats), "coo")))
    layers = [getattr(tstate.model.GNNBackbone_0, f"GATConv_{i}")
              for i in range(2)]
    assert [m.route for m in layers] == ["E", "E"]
    return jt, jstate, jfix, tt, tstate, tfix


def test_banded_train_step_matches_jax(trainers, monkeypatch):
    """One step on the same batch: the losses, the gradient handed to the
    clip (before it), and the BatchNorm statistics after the step."""
    jt, jstate, jfix, tt, tstate, tfix = trainers
    jg, jtg = jds.collate_samples([jfix[0], jfix[1]])
    g, banded = jt._sparse_batch(jg)
    loss_fn = jtr.make_loss_fn(jt.ell_model, jt.config.training,
                               jt.class_weights, jt.huber_delta, True)
    targets = jax.tree.map(lambda t: t.reshape((-1,) + t.shape[2:]), jtg)
    (_, (jl, _, _)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
        jstate.params, jstate.batch_stats, g, targets,
        jax.random.PRNGKey(0), banded)
    want = coo_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, grads),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats), "coo"))
    jstate, jl2, _ = jt._train_step(jstate, g, banded, jtg,
                                    jax.random.PRNGKey(0), jnp.float32(LR))

    seen = {}
    clip = topt.clip_by_global_norm_

    def spy(grads_, max_norm):
        seen["grads"] = [gr.clone() for gr in grads_]
        return clip(grads_, max_norm)

    monkeypatch.setattr(topt, "clip_by_global_norm_", spy)
    tg, ttg = tds.collate_samples([tfix[0], tfix[1]])
    ell = tt.sparse_batch(tg)
    tl, _ = tt.train_step(tstate, ell.to("cpu"),
                          ttr._to_device_targets(ttg, "cpu"), LR,
                          tt.banded_batch(ell).to("cpu"))
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), **TOL,
                                   err_msg=k)
        np.testing.assert_allclose(float(jl2[k]), float(jl[k]), rtol=1e-6)
    named = [n for n, _ in tstate.model.named_parameters()]
    for name, gr in zip(named, seen["grads"]):
        np.testing.assert_allclose(gr.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)
    after = coo_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats), "coo"))
    sd = tstate.model.state_dict()
    for name in after:
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(sd[name].numpy(),
                                       after[name].numpy(), **TOL,
                                       err_msg=name)
    assert tstate.step == 1


def test_banded_trainer_runs_an_epoch(tmp_path):
    _, cfg = _banded_configs()
    cfg.training.epochs = 1
    ds = tds.SyntheticTileDataset(_grids()[:1], cfg, tile_size=32,
                                  overlap=8, seed=5)
    tt = ttr.Trainer(cfg, ds, output_dir=str(tmp_path), device="cpu")
    state = tt.train()
    assert state.step >= 2
    assert np.isfinite(tt.history["train_loss"][0])
    for name in ("best", "last", "final"):
        assert (tmp_path / name / "model.pt").exists()
        assert (tmp_path / name / "calibration.json").exists()
    for p in state.model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()


def test_banded_trainer_refuses_dropout_as_jax(tmp_path):
    """With dropout JAX's layer raises at the first step; the port's
    trainer raises the same error when it is built."""
    ensure_jax_native_kit()
    jcfg, cfg = _banded_configs(dropout=0.1)
    ds = jds.SyntheticTileDataset(_grids()[:1], jcfg, tile_size=32,
                                  overlap=8, seed=5)
    sample = ds[0]
    jt = jtr.Trainer(jcfg, jax_make_model(jcfg.model,
                                          sample.graph.x.shape[-1],
                                          sample.graph.edge_attr.shape[-1]),
                     ds, output_dir=str(tmp_path / "jax"))
    state = jt.init_state(sample.graph)
    graph, targets = next(iter(jds.epoch_batches(ds, 2,
                                                 np.random.default_rng(0))))
    g, banded = jt._sparse_batch(graph)
    with pytest.raises(NotImplementedError) as jerr:
        jt._train_step(state, g, banded, targets, jax.random.PRNGKey(0),
                       jnp.float32(LR))
    with pytest.raises(NotImplementedError) as perr:
        ttr.Trainer(cfg, None, output_dir=str(tmp_path / "port"),
                    device="cpu")
    assert str(perr.value) == str(jerr.value)
