"""PyTorch port vs JAX: the model-quality metrics and the evaluation CLI.

``training/evaluation.compute_metrics`` and ``cli/evaluate_model`` of the
port against JAX's on seeded rasters: the same dict (keys, rounding,
``None`` where a class or threshold is empty) with and without a
confidence band, a valid mask and an empty selection; the CLI's JSON
equal, file for file, on an inference-style output (depth, uncertainty,
classification, confidence bands, NaN at invalid cells) against a 5-band
ground truth of another shape.
"""

import json

import numpy as np
import pytest

from bathymetric_gnn_tpu.cli import evaluate_model as jcli
from bathymetric_gnn_tpu.training import evaluation as jev
from bathymetric_gnn_tpu_torch.cli import evaluate_model as tcli
from bathymetric_gnn_tpu_torch.io.geotiff import write_geotiff
from bathymetric_gnn_tpu_torch.training import evaluation as tev


def _rasters(seed, shape=(40, 50)):
    rg = np.random.default_rng(seed)
    labels = rg.choice([0, 1, 2], shape, p=[0.7, 0.05, 0.25])
    labels[rg.random(shape) < 0.1] = -1
    pred = np.where(rg.random(shape) < 0.8, labels, rg.integers(0, 3, shape))
    pred = np.maximum(pred, 0)
    conf = rg.uniform(0.3, 1.0, shape).astype(np.float32)
    return pred, labels, conf


@pytest.mark.parametrize("case", ["full", "no_confidence", "mask",
                                  "one_class", "empty"])
def test_compute_metrics_matches_jax(case):
    pred, labels, conf = _rasters(1)
    kw = {}
    if case == "no_confidence":
        conf = None
    elif case == "mask":
        kw["valid_mask"] = np.random.default_rng(2).random(labels.shape) > 0.3
    elif case == "one_class":
        labels = np.where(labels >= 0, 0, -1)
    elif case == "empty":
        labels = np.full_like(labels, -1)
    want = jev.compute_metrics(pred, labels, conf, **kw)
    got = tev.compute_metrics(pred, labels, conf, **kw)
    assert got == want
    assert json.dumps(got) == json.dumps(want)
    if case == "full":
        assert set(got) >= {"accuracy", "macro_f1", "per_class",
                            "confusion_matrix", "calibration"}
        assert tev.print_metrics(got) == jev.print_metrics(want)


def test_cli_matches_jax(tmp_path):
    pred, labels, conf = _rasters(3, (48, 60))
    depth = np.random.default_rng(4).normal(30, 1, pred.shape)
    invalid = labels < 0
    bands = np.stack([depth, np.full(pred.shape, 0.2), pred, conf,
                      np.zeros(pred.shape)]).astype(np.float32)
    bands[:, invalid & (np.arange(60) < 30)] = np.nan
    gt = np.zeros((5, 44, 64), np.float32)
    gt[0] = np.pad(labels, ((0, 0), (0, 4)), constant_values=-1)[:44]
    kw = dict(pixel_scale=(1.0, 1.0), origin=(0.0, 100.0))
    write_geotiff(tmp_path / "pred.tif", bands, nodata=float("nan"), **kw)
    write_geotiff(tmp_path / "gt.tif", gt, nodata=-1.0, **kw)
    argv = ["--predictions", str(tmp_path / "pred.tif"), "--ground-truth",
            str(tmp_path / "gt.tif"), "--class-band", "3",
            "--confidence-band", "4"]
    jcli.main(argv + ["--output-json", str(tmp_path / "jax.json")])
    got = tcli.main(argv + ["--output-json", str(tmp_path / "port.json")])
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "jax.json").read_text()
    assert got == json.loads((tmp_path / "port.json").read_text())
    assert got["n_cells"] == int(((gt[0][:44, :60] >= 0)
                                  & np.isfinite(bands[2][:44])).sum())
