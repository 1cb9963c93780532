"""PyTorch port vs JAX: the graph trainer on its COO path.

The JAX ``Trainer`` with ``knn_k == 0`` (its defaults: the COO model on
grid-connectivity tile graphs, ``make_loss_fn`` and ``_make_step``) and the
port's ``Trainer`` on the same fixed samples (``SyntheticTileDataset``,
tiles of 32, node bucket 1024, batches of 2, dropout 0, hidden 16, 2
layers, 2 heads) from the same weights (bridged with ``utils/weights``),
for GAT and GCN:

- one train step: every loss term within rtol 5e-4 and every parameter
  and BatchNorm statistic after the step within rtol 5e-4 of JAX's (an
  element whose gradient is ~0, below 1e-6 of the largest, moves by the
  learning rate of either sign in Adam's first step: 2 x LR of slack);
- ``calibrate_confidence`` (Platt fit over the COO forward) within 1e-4 of
  JAX's;
- ``cli.train --trainer graph --device cpu`` without ``--knn-k`` (the COO
  path) for one epoch with ``--gnn-type GCN`` and GAT, whose checkpoint
  ``cli.inference_native`` then serves from a VR BAG; and the trainer takes
  the COO path where JAX does (``sparse_kernel="xla"`` or a non-GAT type
  with ``knn_k > 0``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.config.config import Config as JaxConfig
from bathymetric_gnn_tpu.models.gnn import make_model as jax_make_model
from bathymetric_gnn_tpu.training import datasets as jds
from bathymetric_gnn_tpu.training import trainer as jtr
from bathymetric_gnn_tpu_torch.cli import inference_native as port_native
from bathymetric_gnn_tpu_torch.cli import train as tcli
from bathymetric_gnn_tpu_torch.config.config import Config
from bathymetric_gnn_tpu_torch.io.bag import write_vr_bag
from bathymetric_gnn_tpu_torch.io.geotiff import write_geotiff
from bathymetric_gnn_tpu_torch.models.gnn import BathymetricGNN
from bathymetric_gnn_tpu_torch.training import datasets as tds
from bathymetric_gnn_tpu_torch.training import trainer as ttr
from bathymetric_gnn_tpu_torch.utils.weights import (coo_state_dict,
                                                     load_state_dict,
                                                     state_dict_from_flax)

from conftest import make_ramp_surface
from test_torch_vr_default import make_refinements

torch.set_num_threads(2)

MODEL = dict(hidden_channels=16, num_layers=2, heads=2)
CW = (1.2, 0.8, 1.5)
LR = 1e-3


def _configs(gnn_type):
    cfgs = []
    for cls in (JaxConfig, Config):
        c = cls()
        for k, v in MODEL.items():
            setattr(c.model, k, v)
        c.model.gnn_type = gnn_type
        c.model.dropout = 0.0
        c.bucket.node_buckets = (1024,)
        c.training.class_weights = CW
        c.training.batch_size = 2
        cfgs.append(c)
    return cfgs


def _grids():
    a = make_ramp_surface(64, 64, seed=1)
    a[20:30, 10:40] = np.nan
    return [a, make_ramp_surface(48, 64, seed=2)]


class Fixed:
    """A dataset of samples drawn once, so both trainers see the same
    noise whatever order they read it in."""

    def __init__(self, ds):
        self.samples = [ds[i] for i in range(len(ds))]
        self.counts = ds.class_counts()
        self.corrections = ds.sample_normalized_corrections()

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]

    def class_counts(self):
        return self.counts

    def sample_normalized_corrections(self):
        return self.corrections


def _bridged(jstate):
    return coo_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats), "coo"))


def _trainers(gnn_type, tmp_path):
    jcfg, cfg = _configs(gnn_type)
    jfix = Fixed(jds.SyntheticTileDataset(_grids(), jcfg, tile_size=32,
                                          overlap=8, seed=5))
    tfix = Fixed(tds.SyntheticTileDataset(_grids(), cfg, tile_size=32,
                                          overlap=8, seed=5))
    sample = jfix[0]
    jmodel = jax_make_model(jcfg.model, sample.graph.x.shape[-1],
                            sample.graph.edge_attr.shape[-1])
    jt = jtr.Trainer(jcfg, jmodel, jfix, output_dir=str(tmp_path / "jax"))
    assert not jt.use_banded_training
    jstate = jt.init_state(sample.graph)
    tt = ttr.Trainer(cfg, tfix, output_dir=str(tmp_path / "port"),
                     device="cpu")
    assert not tt.use_banded_training and tt.sparse_kernel == "xla"
    tt.huber_delta = jt.huber_delta     # the step check starts level
    tstate = tt.init_state(tfix[0].graph)
    assert isinstance(tstate.model, BathymetricGNN)
    tstate.model.load_state_dict(_bridged(jstate))
    return jt, jstate, jfix, tt, tstate, tfix


@pytest.mark.parametrize("gnn_type", ["GAT", "GCN"])
def test_train_step_and_calibration_match_jax(gnn_type, tmp_path):
    jt, jstate, jfix, tt, tstate, tfix = _trainers(gnn_type, tmp_path)
    init = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    jg, jtg = jds.collate_samples([jfix[0], jfix[1]])
    jstate, jl, jacc = jt._train_step(jstate, jg, jtg, jax.random.PRNGKey(0),
                                      jnp.float32(LR))
    tg, ttg = tds.collate_samples([tfix[0], tfix[1]])
    g = tt.sparse_batch(tg)
    assert g.src_perm is not None
    tl, tacc = tt.train_step(tstate, g.to("cpu"),
                             ttr._to_device_targets(ttg, "cpu"), LR)
    for k in jl:
        np.testing.assert_allclose(float(tl[k]), float(jl[k]), rtol=5e-4,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(tacc), float(jacc), atol=2e-3)
    grads = {n: p.grad for n, p in tstate.model.named_parameters()}
    tiny = 1e-6 * max(gr.abs().max().item() for gr in grads.values())
    want, got = _bridged(jstate), tstate.model.state_dict()
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        slack = (torch.where(grads[name].abs() < tiny, 2.02 * LR, 0.0)
                 if name in grads else 0.0)
        allowed = 5e-4 * w.abs() + 1e-6 * w.abs().max() + slack
        assert bool(((got[name] - w).abs() <= allowed).all()), name
        assert not torch.equal(got[name], init[name]) or name.endswith(
            ("mean", "var")), name

    # the Platt fit over the COO forward, against JAX's on the same state
    tstate.model.load_state_dict(_bridged(jstate))
    a = tt.calibrate_confidence(tstate)
    jt.calibrate_confidence(jstate)
    info = json.loads((tt.output_dir / "calibration.json").read_text())
    jinfo = json.loads((jt.output_dir / "calibration.json").read_text())
    assert info["confidence_scale"] == a
    assert info["fit_on"] == jinfo["fit_on"]
    assert info["fit_nodes"] == jinfo["fit_nodes"]
    np.testing.assert_allclose(
        [info["confidence_scale"], info["confidence_bias"]],
        [jinfo["confidence_scale"], jinfo["confidence_bias"]], rtol=1e-4,
        atol=1e-4)


def test_trainer_takes_the_coo_path_where_jax_does(tmp_path):
    """sparse_kernel "xla" with knn_k > 0, and a non-GAT type with
    knn_k > 0, train the COO model, as in JAX (trainer.py:200-211)."""
    cases = [("GAT", "xla"), ("GIN", "auto"), ("GraphSAGE", "banded_pallas")]
    for gnn_type, sk in cases:
        _, cfg = _configs(gnn_type)
        cfg.graph.knn_k = 8
        cfg.model.sparse_kernel = sk
        t = ttr.Trainer(cfg, Fixed(tds.SyntheticTileDataset(
            [make_ramp_surface(32, 32, seed=3)], cfg, tile_size=32,
            overlap=8, seed=1)), output_dir=str(tmp_path / sk),
            device="cpu")
        assert not t.use_banded_training and t.sparse_kernel == "xla"


@pytest.mark.parametrize("gnn_type", ["GCN", "GAT"])
def test_cli_train_coo_then_serve_on_cpu(tmp_path, gnn_type, capsys):
    """cli.train --trainer graph --device cpu at its defaults (no
    --knn-k): best/, last/, final/ with calibration.json; then
    cli.inference_native serves best/ from a VR BAG on the default
    route."""
    data = tmp_path / "data"
    data.mkdir()
    d = make_ramp_surface(80, 80, seed=4)
    d[30:40, 20:50] = np.nan
    write_geotiff(data / "clean.tif", d[None], pixel_scale=(1.0, 1.0),
                  origin=(0.0, 0.0), nodata=float("nan"))
    run = tmp_path / "run"
    state = tcli.main(["--data-dir", str(data), "--output-dir", str(run),
                       "--batch-size", "2", "--tile-size", "32",
                       "--overlap", "8", "--hidden-channels", "8",
                       "--num-layers", "2", "--heads", "2", "--epochs", "1",
                       "--gnn-type", gnn_type, "--device", "cpu"])
    assert isinstance(state.model, BathymetricGNN) and state.step >= 2
    for p in state.model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()
    hist = json.loads((run / "history.json").read_text())
    assert np.isfinite(hist["train_loss"] + hist["val_loss"]).all()
    for name in ("best", "last", "final"):
        cal = json.loads((run / name / "calibration.json").read_text())
        assert "fit_on" in cal and cal["confidence_scale"] > 0
    sd, meta = load_state_dict(run / "best")
    assert meta["trained_layout"] == "coo"
    conv = "GCNConv_0" if gnn_type == "GCN" else "GridGATConv_0"
    assert any(k.startswith(conv) for k in sd)
    assert Config.load(run / "best" / "config.yaml").graph.knn_k == 0

    refs = [(i // 3, i % 3, depth, unc, res[0]) for i, (depth, unc, res) in
            enumerate(make_refinements(5, seed=2, extra=((60, 60),)))]
    bag = tmp_path / "in.bag"
    write_vr_bag(bag, (2, 3), 64.0, refs, origin=(1000.0, 2000.0))
    capsys.readouterr()
    stats = port_native.main(["--input", str(bag), "--output",
                              str(tmp_path / "out.bag"), "--model",
                              str(run / "best"), "--device", "cpu"])
    assert stats["grids"] == 6 and stats["total_nodes"] > 0
    assert 0.0 < stats["mean_confidence"] < 1.0
