"""PyTorch port vs JAX: tiled survey inference end to end, the port's
CLI from a port checkpoint, and the port's isolation from JAX.

The same weights (a JAX init with random BatchNorm statistics, bridged
with ``utils/weights``) go through the JAX ``BathymetricPipeline``
(``use_variables`` + ``process``) and the port's pipeline on the CPU, on a
synthetic two-band GeoTIFF (depth, uncertainty) with tile 64, overlap 16
and tile_batch 4, in two cases: 96x160 with a 7-feature model (six full
tiles: one batch of four and two single-tile dispatches), and 50x160 with
an 8-feature model that reads the uncertainty band (three ragged 50x64
tiles, each dispatched alone).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.config.config import (Config as JaxConfig,
                                               InferenceConfig as JaxInf,
                                               ModelConfig as JaxModel,
                                               TileConfig as JaxTile)
from bathymetric_gnn_tpu.data.graph_build import build_grid_inputs
from bathymetric_gnn_tpu.inference.pipeline import (
    BathymetricPipeline as JaxPipeline)
from bathymetric_gnn_tpu.io.geotiff import read_geotiff, write_geotiff
from bathymetric_gnn_tpu.models.grid_gat import GridBathymetricGNN as JaxGNN
from bathymetric_gnn_tpu_torch.cli import inference as port_cli
from bathymetric_gnn_tpu_torch.config.config import (Config, InferenceConfig,
                                                     ModelConfig, TileConfig)
from bathymetric_gnn_tpu_torch.inference.pipeline import BathymetricPipeline
from bathymetric_gnn_tpu_torch.utils.weights import (save_checkpoint,
                                                     state_dict_from_flax)

from conftest import make_ramp_surface

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
MODEL = dict(hidden_channels=16, num_layers=2, heads=2)
TILE = dict(tile_size=64, overlap=16, min_valid_ratio=0.05)
THRESHOLD = 0.3
CALIBRATION = {"confidence_scale": 2.0, "confidence_bias": 0.5}


def _port_cfg():
    return Config(model=ModelConfig(**MODEL), tile=TileConfig(**TILE),
                  inference=InferenceConfig(auto_correct_threshold=THRESHOLD))


CASES = {"full_tiles": ((96, 160), 7, 6), "ragged_unc": ((50, 160), 8, 3)}


@pytest.fixture(scope="module", params=sorted(CASES))
def setup(request, tmp_path_factory):
    shape, in_channels, n_tiles = CASES[request.param]
    d = tmp_path_factory.mktemp("survey")
    rg = np.random.default_rng(7)
    depth = make_ramp_surface(*shape, seed=7)
    spikes = rg.random(depth.shape) < 0.02
    depth[spikes] += rg.uniform(-3, 3, spikes.sum()).astype(np.float32)
    valid = np.ones(depth.shape, bool)
    valid[30:42, 70:100] = False
    depth[~valid] = np.nan
    unc = rg.uniform(0.1, 0.4, depth.shape).astype(np.float32)
    src = d / "survey.tif"
    write_geotiff(src, np.stack([depth, unc]), pixel_scale=(1.0, 1.0),
                  origin=(0.0, 0.0), nodata=float("nan"))

    feats, v, nbr, eattr, _ = build_grid_inputs(
        np.nan_to_num(depth[:32, :32]), valid[:32, :32],
        unc[:32, :32], with_uncertainty=in_channels == 8)
    variables = JaxGNN(**MODEL).init(jax.random.PRNGKey(0), feats, v, nbr,
                                     eattr)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    for name, leaf in stats.items():
        leaf["mean"] = rg.normal(0, 0.2, leaf["mean"].shape).astype(
            np.float32)
        leaf["var"] = rg.uniform(0.5, 2.0, leaf["var"].shape).astype(
            np.float32)
    # an init's heads give one class and a narrow band of confidence;
    # sharper output layers spread both, so classes, the confidence
    # threshold and the corrections all discriminate
    params["ClassificationHead_0"]["TorchLinear_1"]["kernel"] *= 25.0
    params["ConfidenceHead_0"]["TorchLinear_1"]["kernel"] *= 4.0

    jcfg = JaxConfig(model=JaxModel(**MODEL), tile=JaxTile(**TILE),
                     inference=JaxInf(
                         auto_correct_threshold=THRESHOLD,
                         confidence_scale=CALIBRATION["confidence_scale"],
                         confidence_bias=CALIBRATION["confidence_bias"]))
    jpipe = JaxPipeline(jcfg, tile_batch=4)
    jpipe.use_variables(params, stats, from_coo=False)
    jout = d / "jax_out.tif"
    jstats = jpipe.process(src, jout)

    ckpt = save_checkpoint(d / "ckpt", state_dict_from_flax(params, stats),
                           _port_cfg(), calibration=CALIBRATION)
    pipe = BathymetricPipeline(_port_cfg(), tile_batch=4, device="cpu")
    pipe.load_model(ckpt)
    tout = d / "torch_out.tif"
    tstats = pipe.process(src, tout)
    return dict(src=src, src_bands=read_geotiff(src)[0], valid=valid,
                ckpt=ckpt, n_tiles=n_tiles, in_channels=in_channels,
                pipe=pipe,
                jax=(read_geotiff(jout)[0], jstats),
                port=(read_geotiff(tout)[0], tstats))


# Output bands: depth (cleaned), uncertainty, classification, confidence,
# correction, valid_mask.
def test_pipeline_matches_jax(setup):
    """Model outputs agree to ~1e-5 (test_torch_model); the f16 pack then
    rounds confidence (step 4.9e-4 near 0.5) and correction, and the
    calibration (scale 2) can double a confidence step. Bounds: classes
    agree on >= 99.9% of valid cells, confidence within 2e-3, correction
    within 2e-3 of max(|corr|, 1); cleaned depth and scaled uncertainty
    equal wherever both pipelines made the same correct/keep decision,
    which must be >= 99.9% of valid cells."""
    (jb, js), (tb, ts) = setup["jax"], setup["port"]
    valid = setup["valid"]
    assert tb.shape == jb.shape == (6,) + valid.shape
    assert setup["pipe"].in_channels == setup["in_channels"]
    assert ts["tiles_processed"] == js["tiles_processed"] == setup["n_tiles"]
    agree = np.mean(tb[2][valid] == jb[2][valid])
    assert agree >= 0.999, agree
    assert np.abs(tb[3] - jb[3]).max() < 2e-3
    corr_err = np.abs(tb[4] - jb[4]) / np.maximum(np.abs(jb[4]), 1.0)
    assert corr_err.max() < 2e-3, corr_err.max()
    src = setup["src_bands"]
    same = (tb[0] != src[0]) == (jb[0] != src[0])  # same cells corrected
    assert np.mean(same[valid]) >= 0.999
    both = same & valid
    np.testing.assert_allclose(tb[0][both], jb[0][both], rtol=0, atol=2e-3)
    np.testing.assert_allclose(tb[1][both], jb[1][both], rtol=2e-3)
    assert ts["cells_corrected"] > 0 and js["cells_corrected"] > 0
    assert abs(ts["cells_corrected"] - js["cells_corrected"]) <= max(
        2, 1e-3 * valid.sum())


def test_uncertainty_scaled_on_corrected_cells(setup):
    """uncertainty *= (2 - confidence) exactly where a correction was
    applied; untouched elsewhere."""
    bands, _ = setup["port"]
    src = setup["src_bands"]
    corrected = (bands[0] != src[0]) & setup["valid"]
    assert corrected.any()
    np.testing.assert_allclose(bands[1][corrected],
                               src[1][corrected] * (2.0 - bands[3][corrected]),
                               rtol=1e-6)
    np.testing.assert_array_equal(bands[1][~corrected], src[1][~corrected])


def test_port_cli_from_checkpoint(setup, tmp_path):
    """The port CLI on a port checkpoint dir (config.yaml +
    calibration.json) with --device cpu. Its default tile_batch of 8
    sends every tile through single-tile dispatch; outputs match the
    pipeline run above within the f16 pack's rounding."""
    out = tmp_path / "cli_out.tif"
    stats_json = tmp_path / "stats.json"
    stats = port_cli.main(["--input", str(setup["src"]), "--output",
                           str(out), "--model", str(setup["ckpt"]),
                           "--device", "cpu", "--stats-json",
                           str(stats_json)])
    assert json.loads(stats_json.read_text()) == stats
    assert stats["tiles_processed"] == setup["n_tiles"]
    bands, _ = read_geotiff(out)
    ref, _ = setup["port"]
    valid = setup["valid"]
    assert np.mean(bands[2][valid] == ref[2][valid]) >= 0.999
    assert np.abs(bands[3] - ref[3]).max() < 2e-3
    assert set(np.unique(bands[2][valid])) <= {0.0, 1.0, 2.0}


def test_default_device_is_the_card():
    """No device means CUDA: it raises without a card (nothing falls back
    to the CPU unasked) and resolves to the card where there is one."""
    if torch.cuda.is_available():
        assert BathymetricPipeline().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            BathymetricPipeline()


def test_bag_raises_clearly(tmp_path):
    """BAG input is ported (tests/test_torch_bag.py); what is not a BAG
    raises: a missing file, and an HDF5 file without ``BAG_root``."""
    import h5py

    pipe = BathymetricPipeline(_port_cfg(), device="cpu")
    with pytest.raises(OSError):
        pipe.loader.load(tmp_path / "x.bag")
    with h5py.File(tmp_path / "y.bag", "w") as f:
        f.create_dataset("z", data=np.zeros(3))
    with pytest.raises(ValueError, match="not a BAG"):
        pipe.loader.load(tmp_path / "y.bag")


def test_port_imports_nothing_of_jax():
    """Import every module of the port in a fresh interpreter (the test
    process itself has jax loaded by conftest) and check that no jax*
    module and no module of the JAX package came with it, nor h5py (the
    card's machine has none; BAG I/O imports it when a BAG is opened); the
    training, k-NN serving and k-NN training modules are among those
    imported."""
    code = r"""
import importlib, pkgutil, sys
import bathymetric_gnn_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib", "flax", "optax", "orbax"))
             or m == "bathymetric_gnn_tpu" or m.startswith("bathymetric_gnn_tpu."))
print(len(names), bad)
assert not bad, bad
assert "h5py" not in sys.modules
assert len(names) >= 25, names
for m in ("training.grid_trainer", "training.losses", "training.optim",
          "training.trainer", "training.datasets", "models.grid_batched",
          "data.synthetic_noise", "utils.prefetch", "cli.train", "native",
          "io.bag", "io.loaders", "ops.graph", "ops.ell",
          "ops.cuda.ell_gat_fused", "models.conv_ell", "models.gnn_ell",
          "inference.native_vr", "cli.inference_native",
          "ops.cuda.segment_reduce", "utils.prof"):
    assert pkg.__name__ + "." + m in names, m
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
