"""PyTorch port vs JAX: the dense-grid trainer.

One ``BatchedGridGNN`` training step (dropout 0, hidden 16, 2 layers, 2
heads) against ``jax.value_and_grad`` of the JAX trainer's loss on the
same weights (bridged with ``utils/weights``) and the same batch; clip +
AdamW against optax; the schedulers; the datasets array for array; and a
tiny ``cli.train --device cpu`` run whose checkpoint ``cli.inference
--device cpu`` serves.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bathymetric_gnn_tpu.config.config import Config as JaxConfig
from bathymetric_gnn_tpu.config.constants import (CORRECTION_NORM_CAP,
                                                  CORRECTION_NORM_FLOOR)
from bathymetric_gnn_tpu.data.graph_build import \
    build_grid_inputs as jax_build
from bathymetric_gnn_tpu.models.grid_batched import \
    BatchedGridGNN as JaxBatched
from bathymetric_gnn_tpu.training import grid_trainer as jgt
from bathymetric_gnn_tpu.training import losses as JL
from bathymetric_gnn_tpu.training import trainer as jtr
from bathymetric_gnn_tpu_torch.cli import inference as icli
from bathymetric_gnn_tpu_torch.cli import train as tcli
from bathymetric_gnn_tpu_torch.config.config import Config
from bathymetric_gnn_tpu_torch.io.geotiff import read_geotiff, write_geotiff
from bathymetric_gnn_tpu_torch.training import grid_trainer as tgt
from bathymetric_gnn_tpu_torch.training import trainer as ttr
from bathymetric_gnn_tpu_torch.training.optim import (AdamW,
                                                      clip_by_global_norm_)
from bathymetric_gnn_tpu_torch.utils.weights import (flax_from_state_dict,
                                                     state_dict_from_flax)

from conftest import make_ramp_surface

torch.set_num_threads(2)

MODEL = dict(hidden_channels=16, num_layers=2, heads=2)
CW = (1.2, 0.8, 1.5)


def _configs(dropout=0.0):
    cfgs = []
    for cls in (JaxConfig, Config):
        c = cls()
        for k, v in MODEL.items():
            setattr(c.model, k, v)
        c.model.dropout = dropout
        c.training.class_weights = CW
        cfgs.append(c)
    return cfgs


def _surface(h=96, w=96, hole=False, seed=0):
    d = make_ramp_surface(h, w, seed=seed)
    if hole:
        d[40:50, 30:60] = np.nan
    return d


def _jax_loss(model, cfg, cw):
    """The JAX GridTrainer's loss (grid_trainer.py:218-268), training form."""
    tc = cfg.training

    def loss(params, batch_stats, batch):
        feats, v, nbr, eattr, local_std = jax.vmap(
            lambda d, m: jax_build(d, m, resolution=(1.0, 1.0),
                                   connectivity=8))(batch["noisy"],
                                                    batch["valid"])
        out, upd = model.apply({"params": params, "batch_stats": batch_stats},
                               feats, v, nbr, eattr, deterministic=False,
                               rngs={"dropout": jax.random.PRNGKey(0)},
                               mutable=["batch_stats"])
        corr_t = jnp.clip(batch["raw_correction"]
                          / jnp.maximum(local_std, CORRECTION_NORM_FLOOR),
                          -CORRECTION_NORM_CAP, CORRECTION_NORM_CAP)
        outputs = {k: (o.reshape(-1, o.shape[-1])
                       if k in ("class_logits", "class_probs")
                       else o.reshape(-1)) for k, o in out.items()}
        labels = batch["labels"].reshape(-1)
        losses = JL.combined_loss(
            outputs, {"labels": labels, "correction": corr_t.reshape(-1),
                      "noise_mask": labels == 2},
            batch["valid"].reshape(-1), class_weights=cw,
            classification_weight=tc.classification_weight,
            correction_weight=tc.correction_weight,
            confidence_weight=tc.confidence_weight,
            feature_preservation_weight=tc.feature_preservation_weight,
            shoal_safety_weight=tc.shoal_safety_weight,
            label_smoothing=tc.label_smoothing, correction_delta=1.0)
        return losses["total"], (losses, upd["batch_stats"])
    return loss


def test_one_step_matches_jax_value_and_grad(tmp_path):
    """Loss terms within 1e-5, every parameter gradient within 1e-4 of its
    leaf's scale plus 1e-6 of the largest gradient (a leaf whose true
    gradient is ~0, such as the extractor's last bias, which every
    following BatchNorm cancels, is f32 noise on both sides), and the
    updated BatchNorm statistics within 1e-5. The conv biases are followed
    by batch-stats BatchNorm, so their true gradient is 0: both sides are
    held below 3e-2 instead, as tests/test_pallas_fused.py holds them."""
    jcfg, cfg = _configs()
    ds = tgt.SyntheticGridDataset([_surface()], cfg, tile_size=32,
                                  overlap=8, seed=1)
    batch = tgt.collate_grids([ds[i] for i in range(3)])
    trainer = tgt.GridTrainer(cfg, ds, output_dir=str(tmp_path),
                              device="cpu")
    state = trainer.init_state()

    model = JaxBatched(**MODEL, dropout=0.0)
    feats, v, nbr, eattr, _ = jax.vmap(lambda d, m: jax_build(d, m))(
        jnp.asarray(batch["noisy"]), jnp.asarray(batch["valid"]))
    variables = model.init(jax.random.PRNGKey(3), feats, v, nbr, eattr)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    state.model.load_state_dict(state_dict_from_flax(params, stats))

    (lj, (lossesj, statsj)), gj = jax.jit(jax.value_and_grad(
        _jax_loss(model, jcfg, jnp.asarray(CW)), has_aux=True))(
        params, stats, {k: jnp.asarray(a) for k, a in batch.items()})

    losses, _ = trainer.loss_fn(state.model, batch, train=True)
    losses["total"].backward()
    for k in lossesj:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(lossesj[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    gt, st = flax_from_state_dict(
        {n: p.grad for n, p in state.model.named_parameters()})
    assert not st
    flat_t = dict(jax.tree_util.tree_leaves_with_path(gt))
    flat_j = jax.tree_util.tree_leaves_with_path(gj)
    assert len(flat_t) == len(flat_j) == len(list(
        state.model.parameters()))
    big = max(np.abs(np.asarray(a)).max() for _, a in flat_j)
    for path, a in flat_j:
        a, b = np.asarray(a), np.asarray(flat_t[path])
        name = jax.tree_util.keystr(path)
        if "GridGATConv" in name and "'bias'" in name:
            assert np.abs(a).max() < 3e-2 and np.abs(b).max() < 3e-2, name
            continue
        scale = np.abs(a).max()
        assert np.abs(a - b).max() <= 1e-4 * scale + 1e-6 * big, (
            name, scale, big)
    _, new_stats = flax_from_state_dict(state.model.state_dict())
    for name, leaf in new_stats.items():
        for s in ("mean", "var"):
            np.testing.assert_allclose(leaf[s], np.asarray(statsj[name][s]),
                                       rtol=1e-5, atol=1e-6)


def test_clip_adamw_matches_optax():
    """Three steps of clip_by_global_norm(1) + AdamW with a learning rate
    set per step (inject_hyperparams), the first and last clipped, the
    second not: parameters within 1e-5 relative of optax's."""
    rg = np.random.default_rng(0)
    params = {"a": rg.normal(size=(5, 7)).astype(np.float32),
              "b": rg.normal(size=(7,)).astype(np.float32),
              "c": rg.normal(size=(3, 2, 4)).astype(np.float32)}
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.inject_hyperparams(optax.adamw)(
                          learning_rate=1e-3, weight_decay=1e-4))
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    ost = opt.init(jp)
    tp = [torch.from_numpy(params[k].copy()) for k in sorted(params)]
    adam = AdamW(tp, weight_decay=1e-4)
    for scale, lr in ((3.0, 1e-3), (0.05, 5e-4), (10.0, 2e-3)):
        g = {k: (rg.normal(size=v.shape) * scale).astype(np.float32)
             for k, v in params.items()}
        inj = ost[1]
        ost = (ost[0], inj._replace(hyperparams={
            **inj.hyperparams, "learning_rate": jnp.float32(lr)}))
        upd, ost = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                              ost, jp)
        jp = optax.apply_updates(jp, upd)
        tg = [torch.from_numpy(g[k]) for k in sorted(params)]
        norm = clip_by_global_norm_(tg, 1.0)
        assert (float(norm) >= 1.0) == (scale > 1.0)
        adam.step(tg, lr)
        for k, t in zip(sorted(params), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)


def test_schedulers_match_jax():
    for epoch in range(0, 80):
        assert ttr.cosine_warm_restarts(epoch, 1e-3, 10, 2) == \
            jtr.cosine_warm_restarts(epoch, 1e-3, 10, 2)
    jp, tp = jtr.PlateauScheduler(1e-3), ttr.PlateauScheduler(1e-3)
    vals = [1.0, 0.9, 0.95, 0.95, 0.96, 0.97, 0.99, 1.0, 0.5] + [0.6] * 14
    for v in vals:
        assert tp.step(v) == jp.step(v)
    g1, g2 = ttr.make_dropout_key(7), ttr.make_dropout_key(7)
    assert torch.equal(torch.rand(5, generator=g1),
                       torch.rand(5, generator=g2))


@pytest.mark.parametrize("features", [False, True])
def test_synthetic_dataset_matches_jax(features):
    """Same clean grids, config and seed: the same tiles, the same noisy
    depths, masks, labels and corrections, sample after sample, and the
    same class counts (numpy draws in the same order)."""
    jcfg, cfg = _configs()
    jcfg.synthetic_noise.feature_enabled = features
    cfg.synthetic_noise.feature_enabled = features
    grids = [_surface(hole=True), _surface(70, 110, seed=2)]
    jds = jgt.SyntheticGridDataset(grids, jcfg, tile_size=32, overlap=8,
                                   seed=5)
    tds = tgt.SyntheticGridDataset(grids, cfg, tile_size=32, overlap=8,
                                   seed=5)
    assert len(tds) == len(jds) > 4
    np.testing.assert_array_equal(tds.class_counts(), jds.class_counts())
    for i in range(len(jds)):
        a, b = jds[i], tds[i]
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=f"{i} {k}")
    np.testing.assert_array_equal(
        tgt.collate_grids([tds[0], tds[1]])["noisy"].shape, (2, 32, 32))


def test_ground_truth_dataset_matches_jax(tmp_path):
    rg = np.random.default_rng(1)
    labels = rg.integers(-1, 3, (80, 80)).astype(np.float32)
    bands = np.stack([labels] + [rg.normal(size=(80, 80)).astype(np.float32)
                                 for _ in range(4)])
    write_geotiff(tmp_path / "gt.tif", bands, pixel_scale=(1.0, 1.0),
                  origin=(0.0, 0.0), nodata=float("nan"))
    files = [str(tmp_path / "gt.tif")]
    jds = jgt.GroundTruthGridDataset(files, tile_size=32, overlap=8)
    tds = tgt.GroundTruthGridDataset(files, tile_size=32, overlap=8)
    assert len(tds) == len(jds) > 0
    np.testing.assert_array_equal(tds.class_counts(), jds.class_counts())
    for i in range(len(jds)):
        for k, v in jds[i].items():
            np.testing.assert_array_equal(tds[i][k], v)


def _write_survey(path):
    d = _surface(96, 96, hole=True, seed=4)
    write_geotiff(path, d[None], pixel_scale=(1.0, 1.0), origin=(0.0, 0.0),
                  nodata=float("nan"))


def test_cli_train_then_serve_on_cpu(tmp_path):
    """cli.train --trainer grid --device cpu writes best/, last/, final/
    and history.json with finite losses on a survey with a NaN hole;
    --resume continues from last/; cli.inference --device cpu serves the
    final checkpoint."""
    data = tmp_path / "data"
    data.mkdir()
    _write_survey(data / "clean.tif")
    run = tmp_path / "run"
    argv = ["--trainer", "grid", "--data-dir", str(data), "--output-dir",
            str(run), "--batch-size", "2", "--tile-size", "32", "--overlap",
            "8", "--hidden-channels", "8", "--num-layers", "2", "--heads",
            "2", "--device", "cpu"]
    state = tcli.main(argv + ["--epochs", "2"])
    per_epoch = state.step // 2
    assert per_epoch >= 2
    hist = json.loads((run / "history.json").read_text())
    assert len(hist["train_loss"]) == 2
    assert np.isfinite(hist["train_loss"] + hist["val_loss"]).all()
    for name in ("best", "last", "final"):
        for f in ("model.pt", "meta.json", "config.yaml", "train_state.pt"):
            assert (run / name / f).exists(), (name, f)
    meta = json.loads((run / "final" / "meta.json").read_text())
    assert meta["param_layout"] == "grid" and meta["epoch"] == 1
    for p in state.model.parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all()

    resumed = tcli.main(argv + ["--epochs", "3", "--resume"])
    assert resumed.step == 3 * per_epoch
    assert len(json.loads((run / "history.json").read_text())[
        "train_loss"]) == 1

    out = tmp_path / "served.tif"
    stats = icli.main(["--input", str(data / "clean.tif"), "--output",
                       str(out), "--model", str(run / "final"),
                       "--tile-size", "32", "--overlap", "8",
                       "--device", "cpu"])
    # bands: depth, classification, confidence, correction, valid (the
    # survey has no uncertainty band)
    bands, _ = read_geotiff(out)
    valid = np.isfinite(read_geotiff(data / "clean.tif")[0][0])
    assert stats["tiles_processed"] > 0 and bands.shape[0] == 5
    assert np.isfinite(bands[2][valid]).all()
    assert set(np.unique(bands[1][valid])) <= {0.0, 1.0, 2.0}


@pytest.mark.parametrize("extra", [
    ["--trainer", "graph"],
    ["--trainer", "grid", "--knn-k", "8"],
    ["--trainer", "grid", "--gnn-type", "GCN"],
])
def test_cli_unported_options_exit(tmp_path, extra):
    with pytest.raises(SystemExit, match="queue 1 item 11"):
        tcli.main(["--data-dir", str(tmp_path), "--device", "cpu"] + extra)
