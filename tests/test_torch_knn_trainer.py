"""PyTorch port vs JAX: the graph trainer on k-NN tile graphs.

The port's ``SyntheticTileDataset`` (``knn_k=8``) against the JAX one
(same grids, config and seed: the same noise, graphs and targets, class
counts and Huber delta); ``merge_stacked``; two training steps of the
port's ``Trainer`` (CPU: kernel C's plain version and autograd) against
the JAX ``Trainer._train_step`` on its banded route
(``sparse_kernel="banded_pallas"``: the Pallas kernels C, C' and F in
interpret mode) from the same weights (bridged with ``utils/weights``) on
the same batches, dropout 0 (hidden 16, 2 layers, 2 heads); ``fit_platt``;
the confidence calibration against a Platt fit built here from JAX's ELL
forward and JAX's ``fit_platt``; and a 1-epoch ``cli.train --trainer graph
--knn-k 8 --device cpu`` run whose checkpoint the port's
``NativeVRProcessor`` serves, with ``--resume``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.config.config import Config as JaxConfig
from bathymetric_gnn_tpu.models.gnn import make_model as jax_make_model
from bathymetric_gnn_tpu.ops.graph import merge_stacked as jax_merge_stacked
from bathymetric_gnn_tpu.training import datasets as jds
from bathymetric_gnn_tpu.training import trainer as jtr
from bathymetric_gnn_tpu_torch.cli import train as tcli
from bathymetric_gnn_tpu_torch.config.config import Config
from bathymetric_gnn_tpu_torch.inference.native_vr import NativeVRProcessor
from bathymetric_gnn_tpu_torch.io.geotiff import write_geotiff
from bathymetric_gnn_tpu_torch.ops.graph import merge_stacked
from bathymetric_gnn_tpu_torch.training import datasets as tds
from bathymetric_gnn_tpu_torch.training import trainer as ttr
from bathymetric_gnn_tpu_torch.utils.weights import (coo_state_dict,
                                                     grid_state_dict,
                                                     load_state_dict,
                                                     state_dict_from_flax)

from conftest import make_ramp_surface
from test_torch_knn_graph import (_check_graph,
                                  ensure_jax_native_kit)

torch.set_num_threads(2)

MODEL = dict(hidden_channels=16, num_layers=2, heads=2)
CW = (1.2, 0.8, 1.5)
LR = 1e-3


def _configs(dropout=0.0):
    cfgs = []
    for cls in (JaxConfig, Config):
        c = cls()
        for k, v in MODEL.items():
            setattr(c.model, k, v)
        c.model.dropout = dropout
        c.model.sparse_kernel = "banded_pallas"
        c.graph.knn_k = 8
        c.bucket.node_buckets = (1024,)
        c.training.class_weights = CW
        c.training.batch_size = 2
        cfgs.append(c)
    return cfgs


def _grids():
    a = make_ramp_surface(64, 64, seed=1)
    a[20:30, 10:40] = np.nan
    return [a, make_ramp_surface(56, 64, seed=2)]


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


@pytest.fixture(scope="module")
def datasets():
    ensure_jax_native_kit()   # not JAX's NumPy k-NN: it breaks ties apart
    jcfg, cfg = _configs()
    j = jds.SyntheticTileDataset(_grids(), jcfg, tile_size=32, overlap=8,
                                 seed=5)
    t = tds.SyntheticTileDataset(_grids(), cfg, tile_size=32, overlap=8,
                                 seed=5)
    return jcfg, cfg, j, t


def test_synthetic_dataset_matches_jax(datasets):
    """The same tiles, noise, graphs and targets sample after sample
    (features within the graph builder's tolerances), the same class
    counts and Huber-delta sample."""
    _, _, j, t = datasets
    assert len(t) == len(j) > 8
    for i in range(len(j)):
        a, b = j[i], t[i]
        assert a.num_nodes == b.num_nodes
        _check_graph(b.graph, a.graph)
        np.testing.assert_array_equal(b.targets["labels"],
                                      a.targets["labels"])
        np.testing.assert_array_equal(b.targets["noise_mask"],
                                      a.targets["noise_mask"])
        # the correction targets divide by local_std, which the two
        # featurizations give within 1e-4 (absolute)
        np.testing.assert_allclose(b.targets["correction"],
                                   a.targets["correction"], rtol=1e-3,
                                   atol=1e-4)
    np.testing.assert_array_equal(t.class_counts(), j.class_counts())
    cj, ct = j.sample_normalized_corrections(), \
        t.sample_normalized_corrections()
    assert ct.shape == cj.shape and ct.size > 0
    np.testing.assert_allclose(ct, cj, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        ttr.Trainer.fit_platt(np.zeros(1), np.ones(1)),
        jtr.Trainer.fit_platt(np.zeros(1), np.ones(1)))


def test_collate_and_merge_stacked_match_jax(datasets):
    _, _, j, t = datasets
    jg, jt = jds.collate_samples([j[0], j[3], j[5]])
    tg, tt = tds.collate_samples([t[0], t[3], t[5]])
    assert tt.keys() == jt.keys()
    for k in ("labels", "noise_mask"):
        np.testing.assert_array_equal(tt[k], jt[k])
    np.testing.assert_allclose(tt["correction"], jt["correction"],
                               rtol=1e-3, atol=1e-4)
    jm, tm = jax_merge_stacked(jg), merge_stacked(tg)
    for f in ("edge_src", "edge_dst", "edge_mask", "node_mask", "graph_id",
              "pos"):
        np.testing.assert_array_equal(getattr(tm, f),
                                      np.asarray(getattr(jm, f)), err_msg=f)
    assert tm.x.shape == jm.x.shape == (3 * 1024, jm.x.shape[1])
    assert np.all(np.diff(tm.edge_dst) >= 0)
    # both datasets read in the same order, so their noise stays level
    jb = list(jds.epoch_batches(j, 4, np.random.default_rng(0)))
    batches = list(tds.epoch_batches(t, 4, np.random.default_rng(0)))
    assert len(batches) == len(jb) == len(t) // 4
    assert batches[0][0].x.shape[:2] == (4, 1024)
    for (bg, bt), (jg_, jt_) in zip(batches, jb):
        np.testing.assert_array_equal(bg.edge_src, jg_.edge_src)
        np.testing.assert_array_equal(bt["labels"], jt_["labels"])


@pytest.fixture(scope="module")
def trainers(datasets, tmp_path_factory):
    """The JAX and the port trainers on the same fixed samples, the port's
    model holding the JAX model's initial weights."""
    jcfg, cfg, j, t = datasets
    jfix, tfix = Fixed(j), Fixed(t)
    sample = jfix[0]
    jmodel = jax_make_model(jcfg.model, sample.graph.x.shape[-1],
                            sample.graph.edge_attr.shape[-1])
    jt = jtr.Trainer(jcfg, jmodel, jfix,
                     output_dir=str(tmp_path_factory.mktemp("jax")))
    assert jt.use_banded_training
    jstate = jt.init_state(sample.graph)
    tt = ttr.Trainer(cfg, tfix, output_dir=str(tmp_path_factory.mktemp(
        "port")), device="cpu")
    np.testing.assert_allclose(tt.huber_delta, jt.huber_delta, rtol=1e-4)
    np.testing.assert_array_equal(tt.class_weights.numpy(),
                                  np.asarray(jt.class_weights))
    tt.huber_delta = jt.huber_delta     # the step check starts level
    tstate = tt.init_state(tfix[0].graph)
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    stats = jax.tree_util.tree_map(np.asarray, jstate.batch_stats)
    tstate.model.load_state_dict(coo_state_dict(
        state_dict_from_flax(params, stats, "coo")))
    return jt, jstate, jfix, tt, tstate, tfix


def _bridged(jstate):
    """The JAX train state's weights as the port's ELL model's
    state_dict."""
    return coo_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        jax.tree_util.tree_map(np.asarray, jstate.batch_stats), "coo"))


def test_two_train_steps_match_jax(trainers):
    """Two steps on the same batches: every loss term within rtol 1e-4
    (the second step's losses hold the parameters after the first), and
    every parameter and BatchNorm statistic after each step within 1e-5 of
    its leaf's scale, plus what Adam makes of f32 noise: its update
    divides each gradient by that gradient's own size, so the move carries
    the gradient's relative f32 error (1e-4 of the move: a sum over nodes
    that cancels), and where the update is ill-conditioned:
    - an element whose gradient in a step is ~0 (below 1e-6 of the
      largest: each GAT bias is followed by a batch-statistics BatchNorm,
      which cancels it; a hidden unit ReLU keeps shut for the batch) moves
      by up to the learning rate of either sign on each side: 2 x LR of
      slack for that step;
    - after the second step, an element whose two gradients nearly cancel
      in Adam's first moment (|m| / sqrt(v) < 0.5, bias-corrected) moves by
      a difference of nearly equal terms: LR of slack;
    - a BatchNorm's running mean tracks the mean of its input, which the
      GAT bias before it shifts: momentum x the two sides' difference of
      that bias at the step's start."""
    jt, jstate, jfix, tt, tstate, tfix = trainers
    opt = tstate.optimizer
    named = [n for n, _ in tstate.model.named_parameters()]
    init = {k: v.clone() for k, v in tstate.model.state_dict().items()}
    slack = {n: torch.zeros_like(p) for n, p in
             tstate.model.named_parameters()}
    bias_gap = {}
    for step, (a, b) in enumerate(((0, 1), (2, 3)), 1):
        for name, gap in bias_gap.items():
            bn = name.replace("GATConv_", "MaskedBatchNorm_").replace(
                ".bias", ".mean")
            slack[bn] = slack.get(bn, 0.0) + 0.1 * gap
        jg, jtg = jds.collate_samples([jfix[a], jfix[b]])
        g, banded = jt._sparse_batch(jg)
        jstate, jl, jacc = jt._train_step(
            jstate, g, banded, jtg, jax.random.PRNGKey(0), jnp.float32(LR))
        tg, ttg = tds.collate_samples([tfix[a], tfix[b]])
        tl, tacc = tt.train_step(tstate, tt.sparse_batch(tg).to("cpu"),
                                 ttr._to_device_targets(ttg, "cpu"), LR)
        for k in jl:
            np.testing.assert_allclose(float(tl[k]), float(jl[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(float(tacc), float(jacc), atol=2e-3)
        assert tstate.step == step

        grads = {n: p.grad for n, p in tstate.model.named_parameters()}
        tiny = 1e-6 * max(gr.abs().max().item() for gr in grads.values())
        want, got = _bridged(jstate), tstate.model.state_dict()
        assert sorted(got) == sorted(want)
        for n, mu, nu in zip(named, opt.mu, opt.nu):
            slack[n] += torch.where(grads[n].abs() < tiny, 2.02 * LR, 0.0)
            if step > 1:
                m_hat, v_hat = mu / (1 - opt.b1 ** step), nu / (
                    1 - opt.b2 ** step)
                slack[n] += torch.where(m_hat.abs() < 0.5 * v_hat.sqrt(),
                                        LR, 0.0)
        for name, w in want.items():
            scale = w.abs().max().item()
            allowed = (1e-5 * scale + 1e-4 * (w - init[name]).abs()
                       + slack.get(name, 0.0))
            assert bool(((got[name] - w).abs() <= allowed).all()), (
                name, step, scale)
        bias_gap = {n: (got[n] - want[n]).abs() for n in want
                    if "GATConv_" in n and n.endswith(".bias")}


def test_calibration_matches_jax_platt_fit(trainers):
    """calibrate_confidence (the port's ELL forward, eval mode) against
    the same Platt fit built from JAX's ELL forward on the same batches
    and JAX's fit_platt."""
    jt, jstate, jfix, tt, tstate, tfix = trainers
    tstate.model.load_state_dict(_bridged(jstate))
    a = tt.calibrate_confidence(tstate)
    info = json.loads((tt.output_dir / "calibration.json").read_text())
    assert info["confidence_scale"] == a

    params = jstate.params
    stats = jstate.batch_stats
    confs, ys, sws, sel = [], [], [], []
    for graph, targets in jds.epoch_batches(jfix, 2, np.random.default_rng(0),
                                            shuffle=False):
        g, banded = jt._sparse_batch(graph)
        out = jt.ell_model.apply({"params": params, "batch_stats": stats},
                                 g, deterministic=True, banded=banded)
        m = np.asarray(g.node_mask).astype(bool)
        confs.append(np.asarray(out["confidence"], np.float64)[m])
        pc = np.asarray(out["predicted_class"])[m]
        corr_t = np.asarray(targets["correction"], np.float64).reshape(-1)[m]
        corr_p = np.asarray(out["correction"], np.float64)[m]
        delta = corr_t ** 2 - (corr_p - corr_t) ** 2
        ys.append(delta > 0)
        sws.append(np.abs(delta))
        sel.append(pc == 2)
    c = np.clip(np.concatenate(confs), 1e-6, 1 - 1e-6)
    sel = np.concatenate(sel)
    fit_on = "predicted-noise" if sel.sum() >= 200 else "all"
    if fit_on == "all":
        sel = np.ones_like(sel)
    assert info["fit_on"] == fit_on
    z = np.log(c[sel] / (1 - c[sel]))
    a_j, b_j = jtr.Trainer.fit_platt(
        z, np.concatenate(ys).astype(np.float64)[sel],
        np.concatenate(sws)[sel])
    np.testing.assert_allclose([info["confidence_scale"],
                                info["confidence_bias"]], [a_j, b_j],
                               rtol=1e-4, atol=1e-4)


def test_fit_platt_matches_jax():
    rg = np.random.default_rng(0)
    for _ in range(3):
        z = rg.normal(0, 2, 4000)
        y = (rg.random(4000) < 1 / (1 + np.exp(-(0.7 * z - 0.3)))
             ).astype(np.float64)
        sw = rg.uniform(0.1, 3.0, 4000)
        for w in (None, sw):
            np.testing.assert_allclose(ttr.Trainer.fit_platt(z, y, w),
                                       jtr.Trainer.fit_platt(z, y, w),
                                       rtol=1e-9, atol=1e-9)


def test_trainer_refuses_the_coo_path(datasets, tmp_path):
    """Named for the refusal this path had before it was ported; it now
    checks that the path works: with knn_k 0 or sparse_kernel
    "xla" the trainer builds the COO model (models/gnn.BathymetricGNN) and
    its batches carry the COO edge tables."""
    from bathymetric_gnn_tpu_torch.models.gnn import BathymetricGNN
    from bathymetric_gnn_tpu_torch.ops.graph import CooGraph

    _, cfg, _, t = datasets
    for sec, key, val in (("graph", "knn_k", 0),
                          ("model", "sparse_kernel", "xla")):
        c = Config.from_dict(cfg.to_dict())
        setattr(getattr(c, sec), key, val)
        tr = ttr.Trainer(c, t, output_dir=str(tmp_path), device="cpu")
        assert not tr.use_banded_training and tr.sparse_kernel == "xla"
        assert isinstance(tr.init_state(t[0].graph).model, BathymetricGNN)
        g, *_ = next(tr._host_batches(t, shuffle=True))
        assert isinstance(g, CooGraph) and g.src_perm is not None


def test_cli_train_knn_then_serve_on_cpu(tmp_path):
    """cli.train --trainer graph --knn-k 8 --device cpu, 1 epoch: best/,
    last/, final/ (grid-named weights, trained_layout "coo"),
    calibration.json beside each, metrics.jsonl; NativeVRProcessor serves
    best/; --resume continues from last/."""
    data = tmp_path / "data"
    data.mkdir()
    d = make_ramp_surface(80, 80, seed=4)
    d[30:40, 20:50] = np.nan
    write_geotiff(data / "clean.tif", d[None], pixel_scale=(1.0, 1.0),
                  origin=(0.0, 0.0), nodata=float("nan"))
    run = tmp_path / "run"
    argv = ["--trainer", "graph", "--knn-k", "8", "--data-dir", str(data),
            "--output-dir", str(run), "--batch-size", "2", "--tile-size",
            "32", "--overlap", "8", "--hidden-channels", "8",
            "--num-layers", "2", "--heads", "2", "--device", "cpu"]
    state = tcli.main(argv + ["--epochs", "1"])
    assert state.step >= 2
    for name in ("best", "last", "final"):
        for f in ("model.pt", "meta.json", "config.yaml", "train_state.pt",
                  "calibration.json"):
            assert (run / name / f).exists(), (name, f)
        cal = json.loads((run / name / "calibration.json").read_text())
        assert "fit_on" in cal and cal["confidence_scale"] > 0
    metrics = [json.loads(s) for s in
               (run / "metrics.jsonl").read_text().splitlines()]
    assert len(metrics) == 1 and np.isfinite(metrics[0]["train_loss"])
    assert metrics[0]["edges_per_s"] > 0
    for p in state.model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()

    sd, meta = load_state_dict(run / "best")
    assert meta["trained_layout"] == "coo" and meta["param_layout"] == "grid"
    assert any(k.startswith("GridGATConv_") for k in sd)
    assert grid_state_dict(coo_state_dict(sd)).keys() == sd.keys()
    cfg = Config.load(run / "config.yaml")
    proc = NativeVRProcessor(sd, cfg, device="cpu")
    grid = (20 + np.random.default_rng(0).normal(0, 1, (30, 30))
            ).astype(np.float32)
    out = proc.process_grid(grid, np.full_like(grid, 0.2), (1.0, 1.0))
    assert set(np.unique(out["classification"])) <= {0, 1, 2}
    assert np.isfinite(out["confidence"]).all()

    resumed = tcli.main(argv + ["--epochs", "2", "--resume"])
    assert resumed.step == 2 * state.step
    assert len(json.loads((run / "history.json").read_text())[
        "train_loss"]) == 1
