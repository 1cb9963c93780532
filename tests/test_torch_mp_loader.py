"""PyTorch port vs JAX: the worker-process loader (``utils/mp_loader``).

The port's ``ProcessSampleLoader`` builds whole samples in spawned
workers (``raw_item`` and ``finalize``, torch on one thread) and keeps the
JAX loader's contract: the epoch order shuffled by the caller's rng, then
``base = rng.integers(1 << 30)``, sample ``i`` drawn with seed
``base + i``, batches in submission order, the ragged tail dropped.

- the loader's batches against that contract replayed in-process through
  the JAX ``SyntheticTileDataset`` (as JAX's own loader test replays it),
  within the grid-graph and dataset parity tolerances of
  ``test_torch_grid_graph.py`` and ``test_torch_knn_trainer.py`` (edges
  and labels exact; features rtol 1e-5 / atol 1e-4, the local std atol
  1e-4, edge attributes 1e-5 / 1e-5; corrections 1e-3 / 1e-4), and against
  the port's own replay within 1e-6;
- 1 worker against 2: the same bits;
- a ground-truth dataset through the workers against in-process loading
  within 1e-6: a tile the parent's cache holds is not sent to a worker,
  what the workers build lands in that cache, and a second epoch sends
  nothing;
- a ``Trainer`` epoch with ``num_workers=2`` against ``num_workers=0`` on
  a ground-truth dataset: losses and weights within 1e-6, the workers
  gone when ``train`` returns; the loader made once, reused across epochs
  and closed when ``train`` returns or raises (a stand-in loader);
- a graph build's bits at 1 torch thread (a worker's) and at 4 on a tile
  of more than 32,768 cells;
- ``TypeError`` for a dataset without ``raw_item``.

Pools use at most 2 workers; four tests start one.
"""

import multiprocessing as mp

import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.config.config import BucketConfig as JaxBucket
from bathymetric_gnn_tpu.config.config import Config as JaxConfig
from bathymetric_gnn_tpu.config.config import ModelConfig as JaxModel
from bathymetric_gnn_tpu.training import datasets as jds
from bathymetric_gnn_tpu_torch.config.config import (BucketConfig, Config,
                                                     ModelConfig)
from bathymetric_gnn_tpu_torch.data.ground_truth import compute_ground_truth
from bathymetric_gnn_tpu_torch.io.geotiff import write_geotiff
from bathymetric_gnn_tpu_torch.training import datasets as tds
from bathymetric_gnn_tpu_torch.training import trainer as ttr
from bathymetric_gnn_tpu_torch.utils import mp_loader
from bathymetric_gnn_tpu_torch.utils.mp_loader import ProcessSampleLoader

from conftest import make_ramp_surface

BS = 2
GRAPH_FIELDS = ("x", "edge_src", "edge_dst", "edge_attr", "edge_mask",
                "node_mask", "local_std", "pos")


def _synthetic(cfg_cls, model_cls, bucket_cls, ds_mod):
    cfg = cfg_cls(model=model_cls(hidden_channels=8, num_layers=2),
                  bucket=bucket_cls(node_buckets=(2048,)))
    grids = [make_ramp_surface(80, 80, seed=i) for i in range(2)]
    return ds_mod.SyntheticTileDataset(grids, cfg, tile_size=40, overlap=8,
                                       min_valid_ratio=0.0, seed=0)


def _replay(ds, rng, bs, collate):
    """The loader's seeding contract, in-process."""
    order = np.arange(len(ds))
    rng.shuffle(order)
    base = int(rng.integers(1 << 30))
    order = order[:len(ds) - len(ds) % bs]
    return [collate([ds.finalize(ds.raw_item(int(i), seed=base + int(i)))
                     for i in order[s:s + bs]])
            for s in range(0, len(order), bs)]


def _assert_batches_close(got, want, tol=1e-6):
    assert len(got) == len(want)
    for (g1, t1), (g2, t2) in zip(got, want):
        for f in GRAPH_FIELDS:
            np.testing.assert_allclose(np.asarray(getattr(g1, f)),
                                       np.asarray(getattr(g2, f)),
                                       rtol=tol, atol=tol, err_msg=f)
        for k in t2:
            np.testing.assert_allclose(t1[k], t2[k], rtol=tol, atol=tol,
                                       err_msg=k)


@pytest.fixture(scope="module")
def synthetic():
    ds = _synthetic(Config, ModelConfig, BucketConfig, tds)
    with ProcessSampleLoader(ds, num_workers=2) as loader:
        got = list(loader.epoch_batches(BS, np.random.default_rng(5)))
    return ds, got


def test_loader_matches_jax_contract(synthetic):
    ds, got = synthetic
    assert len(got) == len(ds) // BS == 9
    jds_ = _synthetic(JaxConfig, JaxModel, JaxBucket, jds)
    want = _replay(jds_, np.random.default_rng(5), BS, jds.collate_samples)
    assert len(got) == len(want)
    for (g1, t1), (g2, t2) in zip(got, want):
        for f in ("edge_src", "edge_dst", "edge_mask", "node_mask", "pos"):
            np.testing.assert_array_equal(getattr(g1, f),
                                          np.asarray(getattr(g2, f)),
                                          err_msg=f)
        np.testing.assert_allclose(g1.x, np.asarray(g2.x), rtol=1e-5,
                                   atol=1e-4)
        np.testing.assert_allclose(g1.edge_attr, np.asarray(g2.edge_attr),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(g1.local_std, np.asarray(g2.local_std),
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(t1["labels"], t2["labels"])
        np.testing.assert_array_equal(t1["noise_mask"], t2["noise_mask"])
        np.testing.assert_allclose(t1["correction"], t2["correction"],
                                   rtol=1e-3, atol=1e-4)
    # and the port's own replay: equal to in-process building
    _assert_batches_close(got, _replay(ds, np.random.default_rng(5), BS,
                                       tds.collate_samples))


def test_worker_count_does_not_change_bits(synthetic):
    ds, got2 = synthetic
    with ProcessSampleLoader(ds, num_workers=1) as loader:
        got1 = list(loader.epoch_batches(BS, np.random.default_rng(5)))
    assert len(got1) == len(got2)
    for (g1, t1), (g2, t2) in zip(got1, got2):
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(getattr(g1, f), getattr(g2, f),
                                          err_msg=f)
        for k in t2:
            np.testing.assert_array_equal(t1[k], t2[k], err_msg=k)


@pytest.fixture(scope="module")
def gt_file(tmp_path_factory):
    """A ground-truth raster of a 72 x 72 clean/noisy pair (spikes, a
    +0.05 m offset, a NaN hole) made by the port's compute_ground_truth."""
    d = tmp_path_factory.mktemp("gt")
    rg = np.random.default_rng(3)
    clean = make_ramp_surface(72, 72, seed=4)
    clean[30:40, 10:30] = np.nan
    noisy = clean + 0.05
    hit = rg.random(clean.shape) < 0.05
    noisy[hit] += rg.uniform(-2, 2, hit.sum()).astype(np.float32)
    unc = rg.uniform(0.1, 0.4, clean.shape).astype(np.float32)
    kw = dict(pixel_scale=(1.0, 1.0), origin=(1000.0, 2000.0),
              nodata=float("nan"))
    write_geotiff(d / "clean.tif", clean[None], **kw)
    write_geotiff(d / "noisy.tif", np.stack([noisy, unc]), **kw)
    return compute_ground_truth(d / "clean.tif", d / "noisy.tif",
                                d / "out")["output"]


def _gt_config():
    cfg = Config()
    cfg.model.hidden_channels, cfg.model.num_layers = 16, 2
    cfg.model.heads = 2
    cfg.bucket.node_buckets = (1024,)
    cfg.training.batch_size = BS
    cfg.training.epochs = 1
    return cfg


def _gt_dataset(path, cfg):
    return tds.GroundTruthTileDataset([path], cfg, tile_size=32, overlap=8)


def test_ground_truth_dataset_through_workers(gt_file):
    ds = _gt_dataset(gt_file, _gt_config())
    assert len(ds) == 9
    first = ds[3]                       # in the parent's cache before
    with ProcessSampleLoader(ds, num_workers=2) as loader:
        tasks = []
        submit = loader._pool.submit
        loader._pool.submit = lambda fn, i, seed: (tasks.append(i),
                                                   submit(fn, i, seed))[1]
        got = list(loader.epoch_batches(BS, np.random.default_rng(7)))
        used = sorted(tasks)
        # what the workers built is now in the parent's cache: a second
        # epoch, and in-process loading, build nothing again
        again = list(loader.epoch_batches(BS, np.random.default_rng(7)))
    order = np.arange(9)
    np.random.default_rng(7).shuffle(order)
    assert 3 in order[:8] and used == sorted(set(order[:8].tolist()) - {3})
    assert all(ds.cached(i) is not None for i in used)
    assert ds.cached(3) is first and len(tasks) == len(used)
    want = list(tds.epoch_batches(_gt_dataset(gt_file, _gt_config()), BS,
                                  np.random.default_rng(7)))
    _assert_batches_close(got, want)
    _assert_batches_close(again, want)
    assert set(np.unique(np.concatenate(
        [t["labels"].ravel() for _, t in got]))) <= {0, 2}


def test_trainer_epoch_with_workers_matches_in_process(gt_file, tmp_path):
    runs = {}
    for workers in (0, 2):
        cfg = _gt_config()
        cfg.training.num_workers = workers
        tr = ttr.Trainer(cfg, _gt_dataset(gt_file, cfg),
                         output_dir=str(tmp_path / f"w{workers}"),
                         device="cpu")
        state = tr.train()
        assert tr._mp_loader is None
        runs[workers] = (tr.history, {k: v.clone() for k, v in
                                      state.model.state_dict().items()})
    assert not mp.active_children()
    (h0, p0), (h2, p2) = runs[0], runs[2]
    for k in ("train_loss", "train_acc", "val_loss", "val_acc"):
        np.testing.assert_allclose(h2[k], h0[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    assert h0["train_loss"][0] > 0
    for k in p0:
        np.testing.assert_allclose(p2[k].numpy(), p0[k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


class _StandIn:
    """A loader that builds in-process, recording its life."""

    made, closed = [], []

    def __init__(self, dataset, num_workers=2):
        self.dataset = dataset
        _StandIn.made.append(self)

    def epoch_batches(self, bs, rng):
        return tds.epoch_batches(self.dataset, bs, rng)

    def close(self):
        _StandIn.closed.append(self)


def test_trainer_loader_lifecycle(gt_file, tmp_path, monkeypatch):
    monkeypatch.setattr(mp_loader, "ProcessSampleLoader", _StandIn)
    _StandIn.made.clear()
    _StandIn.closed.clear()
    cfg = _gt_config()
    cfg.training.num_workers = 2
    cfg.training.epochs = 2
    ds = _gt_dataset(gt_file, cfg)
    tr = ttr.Trainer(cfg, ds, output_dir=str(tmp_path / "a"), device="cpu")
    tr.train()
    assert len(_StandIn.made) == 1 and _StandIn.closed == _StandIn.made
    assert len(tr.history["train_loss"]) == 2 and tr._mp_loader is None

    tr = ttr.Trainer(cfg, ds, output_dir=str(tmp_path / "b"), device="cpu")

    def boom(*a, **k):
        raise RuntimeError("step failed")

    monkeypatch.setattr(tr, "train_step", boom)
    with pytest.raises(RuntimeError, match="step failed"):
        tr.train()
    assert len(_StandIn.made) == 2 and _StandIn.closed == _StandIn.made
    assert tr._mp_loader is None


def test_graph_build_bits_do_not_depend_on_threads(tmp_path):
    """A tile of more than 32,768 cells (torch splits a sum that long
    across its threads) builds the same graph and targets at 1 thread, as
    a worker runs, and at 4."""
    rg = np.random.default_rng(0)      # a sum whose rounding moves
    yy, xx = np.mgrid[0:200, 0:200].astype(np.float32)
    clean = (25.0 + 0.02 * xx + 0.01 * yy + 0.5 * np.sin(xx / 17.0)
             + rg.normal(0, 0.02, xx.shape)).astype(np.float32)
    noisy = clean + 0.05
    hit = rg.random(clean.shape) < 0.02
    noisy[hit] += rg.uniform(-2, 2, hit.sum()).astype(np.float32)
    kw = dict(pixel_scale=(1.0, 1.0), origin=(0.0, 200.0),
              nodata=float("nan"))
    write_geotiff(tmp_path / "clean.tif", clean[None], **kw)
    write_geotiff(tmp_path / "noisy.tif", noisy[None], **kw)
    gt = compute_ground_truth(tmp_path / "clean.tif", tmp_path / "noisy.tif",
                              tmp_path / "gt")["output"]
    ds = tds.GroundTruthTileDataset([gt], Config(), tile_size=200,
                                    overlap=8)
    raw = ds.raw_item(0)
    assert raw["noisy"].size > 32768
    threads = torch.get_num_threads()
    try:
        built = []
        for n in (4, 1):
            torch.set_num_threads(n)
            built.append(ds.finalize(raw))
    finally:
        torch.set_num_threads(threads)
    (a, b) = built
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(a.graph, f),
                                      getattr(b.graph, f), err_msg=f)
    for k in a.targets:
        np.testing.assert_array_equal(a.targets[k], b.targets[k], err_msg=k)


def test_unsplittable_dataset_raises():
    with pytest.raises(TypeError, match="raw_item"):
        ProcessSampleLoader([1, 2, 3], num_workers=1)
