"""PyTorch port vs JAX: streaming survey inference
(``inference/streaming.py``, ``cli.inference --streaming``) on the CPU.

The same weights (a JAX init of the grid model with random BatchNorm
statistics and sharpened heads, bridged with ``utils/weights``) serve
JAX's streaming test survey (200 x 150 ramp with a 20 x 60 hole; tile 64,
overlap 16: 12 full tiles in 4 tile rows) through both packages' streaming
pipelines and in-memory pipelines. The rolling-band merger and the VR
BAG window reader are held against JAX's bit for bit.

Bounds against JAX (as ``test_torch_pipeline.py``): classes on >= 99.9 %
of valid cells, confidence within 2e-3, correction within 2e-3 of
max(|corr|, 1). Port streaming against port in-memory: JAX's streaming
test's tolerances (classes equal, the rest atol 1e-4 / rtol 1e-3).

The JAX streaming pipeline never applies the confidence calibration
(``bathymetric_gnn_tpu/inference/streaming.py:310-344``; its ``process``
does, ``inference/pipeline.py:339-341``); the port's applies it as its
``process`` does, and ``test_jax_streaming_skips_calibration`` pins the
difference.
"""

import json
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.config.config import (Config as JaxConfig,
                                               InferenceConfig as JaxInf,
                                               ModelConfig as JaxModel,
                                               TileConfig as JaxTile)
from bathymetric_gnn_tpu.data.graph_build import build_grid_inputs
from bathymetric_gnn_tpu.data.tiling import TileManager as JaxTileManager
from bathymetric_gnn_tpu.inference.pipeline import (
    BathymetricPipeline as JaxPipeline)
from bathymetric_gnn_tpu.inference.streaming import (
    RowBandMerger as JaxMerger, StreamingPipeline as JaxStreaming,
    VRBagWindowReader as JaxVRReader)
from bathymetric_gnn_tpu.io.geotiff import read_geotiff, write_geotiff
from bathymetric_gnn_tpu.models.grid_gat import GridBathymetricGNN as JaxGNN
from bathymetric_gnn_tpu_torch.cli import inference as port_cli
from bathymetric_gnn_tpu_torch.config.config import (Config, InferenceConfig,
                                                     ModelConfig, TileConfig)
from bathymetric_gnn_tpu_torch.data.tiling import TileManager
from bathymetric_gnn_tpu_torch.inference.pipeline import BathymetricPipeline
from bathymetric_gnn_tpu_torch.inference.streaming import (
    OUT_BANDS, RowBandMerger, StreamingPipeline, VRBagWindowReader)
from bathymetric_gnn_tpu_torch.io.geotiff import GeoTiffWindowReader
from bathymetric_gnn_tpu_torch.io.loaders import BathymetricLoader
from bathymetric_gnn_tpu_torch.utils.weights import (save_checkpoint,
                                                     state_dict_from_flax)

from conftest import make_ramp_surface

torch.set_num_threads(2)

MODEL = dict(hidden_channels=16, num_layers=2, heads=2)
TILE = dict(tile_size=64, overlap=16, min_valid_ratio=0.05)
THRESHOLD = 0.3
IDENTITY = (1.0, 0.0)
CALIBRATION = (2.0, 0.5)
STATS_KEYS = {"tiles_processed", "valid_cells", "noise_pct",
              "mean_confidence", "cells_corrected", "elapsed_s"}


def _port_cfg(cal=IDENTITY):
    return Config(model=ModelConfig(**MODEL), tile=TileConfig(**TILE),
                  inference=InferenceConfig(auto_correct_threshold=THRESHOLD,
                                            confidence_scale=cal[0],
                                            confidence_bias=cal[1]))


def _jax_cfg(cal=IDENTITY):
    return JaxConfig(model=JaxModel(**MODEL), tile=JaxTile(**TILE),
                     inference=JaxInf(auto_correct_threshold=THRESHOLD,
                                      confidence_scale=cal[0],
                                      confidence_bias=cal[1]))


@pytest.fixture(scope="module")
def weights():
    """JAX grid-model variables with random BatchNorm statistics and
    sharpened heads (classes, the threshold and the corrections all
    discriminate), and the port's state_dict of them."""
    rg = np.random.default_rng(11)
    depth = make_ramp_surface(32, 32)
    feats, v, nbr, eattr, _ = build_grid_inputs(depth,
                                                np.ones((32, 32), bool))
    variables = JaxGNN(**MODEL).init(jax.random.PRNGKey(0), feats, v, nbr,
                                     eattr)
    params = jax.tree_util.tree_map(np.array, variables["params"])
    stats = jax.tree_util.tree_map(np.array, variables["batch_stats"])
    for leaf in stats.values():
        leaf["mean"] = rg.normal(0, 0.2, leaf["mean"].shape).astype(
            np.float32)
        leaf["var"] = rg.uniform(0.5, 2.0, leaf["var"].shape).astype(
            np.float32)
    params["ClassificationHead_0"]["TorchLinear_1"]["kernel"] *= 25.0
    params["ConfidenceHead_0"]["TorchLinear_1"]["kernel"] *= 4.0
    # the smooth ramp gives nearly constant class logits (means -1.88,
    # -1.38, -3.90, spread ~0.04): these shifts bring the three means
    # within 0.05, so every class wins on part of the survey
    params["ClassificationHead_0"]["TorchLinear_1"]["bias"] += np.array(
        [0.0, -0.5, 2.0], np.float32)
    return params, stats, state_dict_from_flax(params, stats)


def _port(weights, cal=IDENTITY, cls=StreamingPipeline):
    pipe = cls(_port_cfg(cal), device="cpu")
    pipe.use_state_dict(weights[2])
    return pipe


def _jax(weights, cal=IDENTITY, cls=JaxStreaming):
    pipe = cls(_jax_cfg(cal))
    pipe.use_variables(weights[0], weights[1], from_coo=False)
    return pipe


@pytest.fixture(scope="module")
def survey(tmp_path_factory):
    """JAX's streaming test survey (tests/test_streaming.py:36-42)."""
    d = tmp_path_factory.mktemp("stream")
    depth = make_ramp_surface(200, 150, seed=3)
    valid = np.ones(depth.shape, bool)
    valid[40:60, 30:90] = False
    depth[~valid] = np.nan
    src = d / "in.tif"
    write_geotiff(src, depth[None], pixel_scale=(1.0, 1.0),
                  origin=(0.0, 200.0), nodata=float("nan"))
    return dict(dir=d, src=src, depth=depth, valid=valid)


@pytest.fixture(scope="module")
def runs(weights, survey):
    """Each pipeline once on the survey: bands and stats by name."""
    d, src = survey["dir"], survey["src"]
    out = {}
    for name, make, cal in (
            ("port_stream", _port, IDENTITY),
            ("port_stream_cal", _port, CALIBRATION),
            ("jax_stream", _jax, IDENTITY),
            ("jax_stream_cal", _jax, CALIBRATION)):
        stats = make(weights, cal).process_streaming(src, d / f"{name}.tif")
        out[name] = (read_geotiff(d / f"{name}.tif")[0], stats)
    for name, make, cls in (("port_mem_cal", _port, BathymetricPipeline),
                            ("jax_mem_cal", _jax, JaxPipeline)):
        stats = make(weights, CALIBRATION, cls).process(src,
                                                        d / f"{name}.tif")
        out[name] = (read_geotiff(d / f"{name}.tif")[0], stats)
    return out


def _assert_near_jax(port, ref, valid):
    """test_torch_pipeline.py's bounds; bands cleaned, class, confidence,
    correction, valid (the survey has no uncertainty band)."""
    assert port.shape == ref.shape
    np.testing.assert_array_equal(port[4], ref[4])
    agree = np.mean(port[1][valid] == ref[1][valid])
    assert agree >= 0.999, agree
    assert np.abs(port[2][valid] - ref[2][valid]).max() < 2e-3
    corr_err = (np.abs(port[3][valid] - ref[3][valid])
                / np.maximum(np.abs(ref[3][valid]), 1.0))
    assert corr_err.max() < 2e-3, corr_err.max()
    same = np.isclose(port[0], ref[0], rtol=0, atol=2e-3)[valid]
    assert np.mean(same) >= 0.999


def test_row_band_merger_matches_jax():
    """The same random tiles through both mergers, in the streaming
    pipeline's advance / add_tile / finalize_rows sequence over a tall
    ragged grid: every finalized row and the band state, bit for bit."""
    rg = np.random.default_rng(5)
    h, w = 300, 150
    tm, jtm = TileManager(64, 16, 0.05), JaxTileManager(64, 16, 0.05)
    port, ref = RowBandMerger(tm, w, 128), JaxMerger(jtm, w, 128)
    _, _, specs = tm.compute_tile_grid((h, w))
    flushed = 0
    rows = sorted({s.tile_row for s in specs})
    for tr in rows:
        row_specs = [s for s in specs if s.tile_row == tr]
        r_lo = min(s.row_start for s in row_specs)
        r_hi = max(s.row_end for s in row_specs)
        for m in (port, ref):
            m.advance(min(flushed, r_lo))
            if r_hi - m.base_row > 128:
                m.advance(r_hi - 128)
        for s in row_specs:
            conf = rg.random(s.shape).astype(np.float32)
            conf[rg.random(s.shape) < 0.05] = np.nan
            res = {"classification": rg.integers(0, 3, s.shape)
                   .astype(np.float32),
                   "confidence": np.round(conf, 2),   # ties between tiles
                   "correction": rg.normal(0, 1, s.shape)
                   .astype(np.float32)}
            tv = rg.random(s.shape) > 0.1
            port.add_tile(s, res, tile_valid=tv)
            ref.add_tile(s, res, tile_valid=tv)
        upto = min((tr + 1) * tm.stride, h) if tr + 1 in rows else h
        a, b = port.finalize_rows(flushed, upto), ref.finalize_rows(
            flushed, upto)
        for c in b:
            np.testing.assert_array_equal(a[c], b[c], err_msg=c)
        flushed = upto
    for c in ("confidence", "correction"):
        np.testing.assert_array_equal(port.sum[c], ref.sum[c])
        np.testing.assert_array_equal(port.weight[c], ref.weight[c])
    np.testing.assert_array_equal(port.cls, ref.cls)
    np.testing.assert_array_equal(port.best_conf, ref.best_conf)
    assert port.base_row == ref.base_row > 0


def test_streaming_matches_jax_streaming(runs, survey):
    """Identity calibration: port streaming against JAX streaming."""
    (pb, ps), (jb, js) = runs["port_stream"], runs["jax_stream"]
    assert pb.shape == (5,) + survey["depth"].shape
    assert ps["tiles_processed"] == js["tiles_processed"] == 12
    assert ps["valid_cells"] == js["valid_cells"] == survey["valid"].sum()
    _assert_near_jax(pb, jb, survey["valid"])
    assert ps["cells_corrected"] > 0
    assert abs(ps["cells_corrected"] - js["cells_corrected"]) <= 2


def test_streaming_matches_in_memory_with_calibration(runs, survey):
    """Calibration (2.0, 0.5): port streaming equals the port's in-memory
    pipeline at JAX's streaming test's tolerances, and stays within the
    JAX bounds of JAX's in-memory pipeline."""
    (sb, ss), (mb, ms) = runs["port_stream_cal"], runs["port_mem_cal"]
    assert mb.shape == sb.shape      # mem: depth, class, conf, corr, valid
    for i, name in enumerate(OUT_BANDS):
        a, b = mb[i], sb[i]
        if name in ("classification", "valid_mask"):
            assert (np.isfinite(a) == np.isfinite(b)).all(), name
            both = np.isfinite(a)
            np.testing.assert_array_equal(a[both], b[both], err_msg=name)
        else:
            np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                       rtol=1e-3, atol=1e-4, err_msg=name)
    assert ss["cells_corrected"] == ms["cells_corrected"] > 0
    assert ss["tiles_processed"] == ms["tiles_processed"]
    assert ss["mean_confidence"] == pytest.approx(ms["mean_confidence"],
                                                  abs=1e-4)
    _assert_near_jax(sb, runs["jax_mem_cal"][0], survey["valid"])


def test_jax_streaming_skips_calibration(runs, survey):
    """The reference fault: JAX streaming configured with calibration
    (2.0, 0.5) gives the identity-calibrated confidence (the port's
    identity run), not the calibrated one (the port's calibrated run)."""
    valid = survey["valid"]
    jax_cal = runs["jax_stream_cal"][0][2][valid]
    ident = runs["port_stream"][0][2][valid]
    calibrated = runs["port_stream_cal"][0][2][valid]
    assert np.abs(jax_cal - ident).max() < 2e-3
    assert np.abs(jax_cal - calibrated).max() > 0.05
    assert abs(jax_cal.mean() - calibrated.mean()) > 0.05


def _merge_events(pipe, merger_cls, src, out):
    """(kind, row range) of every add_tile and finalize_rows call of one
    streaming run, in order."""
    events = []
    add, fin = merger_cls.add_tile, merger_cls.finalize_rows

    def spy_add(self, spec, *a, **k):
        events.append(("add", spec.row_start, spec.row_end))
        return add(self, spec, *a, **k)

    def spy_fin(self, r0, r1):
        events.append(("final", r0, r1))
        return fin(self, r0, r1)

    with mock.patch.object(merger_cls, "add_tile", spy_add), \
            mock.patch.object(merger_cls, "finalize_rows", spy_fin):
        pipe.process_streaming(src, out)
    return events


def _finalized_early(events):
    """Rows finalized before a tile over them was merged."""
    early = set()
    for i, (kind, r0, r1) in enumerate(events):
        if kind == "final":
            for kind2, t0, t1 in events[i + 1:]:
                if kind2 == "add":
                    early |= set(range(max(r0, t0), min(r1, t1)))
    return sorted(early)


def test_rows_final_only_after_their_last_tile(weights, survey, tmp_path):
    """The last tile row is pulled back to end at the survey's edge (rows
    136..199 here, not 144..): the port finalizes rows only up to the next
    tile row's first row. JAX's streaming pipeline finalizes up to
    (tr + 1) * stride (``inference/streaming.py:408-410``), so rows
    136..143 are written before the last row's tiles are merged, and its
    output there differs from its in-memory pipeline's."""
    port = _merge_events(_port(weights), RowBandMerger, survey["src"],
                         tmp_path / "p.tif")
    ref = _merge_events(_jax(weights), JaxMerger, survey["src"],
                        tmp_path / "j.tif")
    assert sum(e[0] == "add" for e in port) == 12
    assert _finalized_early(port) == []
    assert _finalized_early(ref) == list(range(136, 144))


def test_tall_survey_reads_in_bands(weights, tmp_path):
    """512 x 96 (11 tile rows of 2): every cell served and finite, and no read
    spans more than the merger's band of 2 x tile_size rows."""
    depth = make_ramp_surface(512, 96, seed=1)
    src = tmp_path / "tall.tif"
    write_geotiff(src, depth[None], pixel_scale=(1.0, 1.0),
                  origin=(0.0, 512.0))
    spans = []
    read_rows = GeoTiffWindowReader.read_rows

    def spy(self, band, r0, r1):
        spans.append(r1 - r0)
        return read_rows(self, band, r0, r1)

    with mock.patch.object(GeoTiffWindowReader, "read_rows", spy):
        stats = _port(weights).process_streaming(src, tmp_path / "out.tif")
    assert stats["valid_cells"] == 512 * 96
    assert stats["tiles_processed"] == 22
    bands, _ = read_geotiff(tmp_path / "out.tif")
    assert bands.shape == (5, 512, 96)
    assert np.isfinite(bands).all()
    assert spans and max(spans) <= 2 * TILE["tile_size"], max(spans)


def _vr_bag(path):
    """JAX's VR BAG (tests/test_streaming.py:117-131): 4 x 3 base cells of
    32 m with 4, 8 or 16 refinement cells a side and a NODATA hole."""
    from bathymetric_gnn_tpu_torch.io.bag import write_vr_bag

    rg = np.random.default_rng(2)
    base, base_res = (4, 3), 32.0
    refinements = []
    for r in range(base[0]):
        for c in range(base[1]):
            dx = [4, 8, 16][(r + c) % 3]
            d = (20 + rg.normal(0, 1, (dx, dx))).astype(np.float32)
            if (r, c) == (1, 1):
                d[:2, :2] = 1.0e6
            refinements.append((r, c, d, np.abs(d) * 0.02, base_res / dx))
    write_vr_bag(path, base, base_res, refinements, origin=(1000.0, 2000.0))


def test_vr_window_reader_matches_jax_and_loader(tmp_path):
    """Windows of 7 rows, depth then uncertainty (the cached band): equal
    to JAX's reader and to the port's resampled canvas, bit for bit."""
    src = tmp_path / "v.bag"
    _vr_bag(src)
    full = BathymetricLoader(vr_bag_mode="resampled").load(src)
    port, ref = VRBagWindowReader(src), JaxVRReader(src)
    try:
        assert (port.height, port.width) == full.depth.shape == (
            ref.height, ref.width)
        assert port.info.geotransform == ref.info.geotransform
        got = {0: [], 1: []}
        for r0 in range(0, port.height, 7):
            r1 = min(r0 + 7, port.height)
            for band in (0, 1):
                a = port.read_rows(band, r0, r1)
                np.testing.assert_array_equal(a, ref.read_rows(band, r0, r1))
                got[band].append(a)
        np.testing.assert_array_equal(np.concatenate(got[0]), full.depth)
        np.testing.assert_array_equal(np.concatenate(got[1]),
                                      full.uncertainty)
    finally:
        port.close()
        ref.close()


@pytest.fixture(scope="module")
def checkpoint(weights, tmp_path_factory):
    """A port checkpoint of the weights: config.yaml (tile 64) and the
    identity calibration."""
    return save_checkpoint(tmp_path_factory.mktemp("ckpt") / "ckpt",
                           weights[2], _port_cfg())


def _cli(args):
    return port_cli.main(args + ["--streaming", "--device", "cpu",
                                 "--confidence-threshold", str(THRESHOLD)])


def test_bag_streaming_matches_jax(weights, checkpoint, tmp_path):
    """``cli.inference --streaming`` on an SR BAG (150 x 120, 2 m, 9 full
    tiles) and on JAX's VR BAG (64 x 48 finest canvas: one ragged tile),
    against JAX's StreamingPipeline on the same file; georeferencing as
    JAX's test checks it."""
    from bathymetric_gnn_tpu_torch.io.bag import write_sr_bag

    depth = make_ramp_surface(150, 120, seed=5)
    sr = tmp_path / "s.bag"
    write_sr_bag(sr, np.flipud(depth), np.abs(depth) * 0.01,
                 resolution=2.0, origin=(100.0, 500.0))
    vr = tmp_path / "v.bag"
    _vr_bag(vr)
    for src, n_tiles in ((sr, 9), (vr, 1)):
        out, ref = tmp_path / f"{src.stem}_port.tif", tmp_path / (
            f"{src.stem}_jax.tif")
        stats = _cli(["--input", str(src), "--output", str(out),
                      "--model", str(checkpoint)])
        jstats = _jax(weights).process_streaming(src, ref)
        bands, info = read_geotiff(out)
        jbands, jinfo = read_geotiff(ref)
        assert stats["tiles_processed"] == jstats["tiles_processed"] == n_tiles
        assert stats["valid_cells"] == jstats["valid_cells"]
        assert info.geotransform == jinfo.geotransform
        _assert_near_jax(bands, jbands, bands[4] == 1.0)
    bands, info = read_geotiff(tmp_path / "s_port.tif")
    assert bands.shape == (5, 150, 120)
    assert info.geotransform[0] == 100.0
    assert info.geotransform[3] == 500.0 + 150 * 2.0
    assert np.isclose(bands[0], depth, atol=1e-4).mean() > 0.5  # north-up
    bands, info = read_geotiff(tmp_path / "v_port.tif")
    full = BathymetricLoader(vr_bag_mode="resampled").load(vr)
    assert bands.shape == (5,) + full.depth.shape
    np.testing.assert_array_equal(bands[4] == 1.0, full.valid_mask)
    assert abs(info.geotransform[0] - 1000.0) < 1e-6


def test_cli_streaming_from_checkpoint(checkpoint, runs, survey, tmp_path):
    """``cli.inference --streaming --device cpu`` from a port checkpoint:
    five bands, JAX's stats keys, and the StreamingPipeline run's
    output."""
    out = tmp_path / "cli.tif"
    stats_json = tmp_path / "stats.json"
    stats = _cli(["--input", str(survey["src"]), "--output", str(out),
                  "--model", str(checkpoint), "--stats-json",
                  str(stats_json)])
    assert set(stats) == STATS_KEYS
    assert json.loads(stats_json.read_text()) == stats
    bands, _ = read_geotiff(out)
    ref, rstats = runs["port_stream"]
    assert bands.shape == (5,) + survey["depth"].shape
    np.testing.assert_array_equal(bands, ref)
    assert {k: v for k, v in stats.items() if k != "elapsed_s"} == {
        k: v for k, v in rstats.items() if k != "elapsed_s"}


def test_default_device_is_the_card(weights):
    """No device means CUDA: it raises without a card and resolves to the
    card where there is one; process_streaming refuses before a model."""
    if torch.cuda.is_available():
        assert StreamingPipeline().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            StreamingPipeline()
    with pytest.raises(RuntimeError, match="load_model"):
        StreamingPipeline(device="cpu").process_streaming("x.tif", "y.tif")


# Batch invariance on the card. Streaming serves a tile row's tiles
# together, the in-memory pipeline batches of 8 across rows and a tail
# alone, so a tile must give the same bits whatever batch it is served in.
# On the card the per-tile sums of the featurization, the edge terms of
# kernel A's precompute and every TorchLinear product are therefore formed
# so that their order depends on the tile alone; these are their forms,
# held here on the CPU.

def test_pairwise_tile_sum_is_batch_invariant():
    from bathymetric_gnn_tpu_torch.ops.features import pairwise_tile_sum

    rg = np.random.default_rng(3)
    x = torch.from_numpy((30 + rg.normal(0, 2, (6, 37, 53)))
                         .astype(np.float32))
    batch = pairwise_tile_sum(x)
    assert batch.shape == (6, 1, 1)
    for i in range(6):
        assert torch.equal(pairwise_tile_sum(x[i:i + 1])[0], batch[i])
        assert torch.equal(pairwise_tile_sum(x[[i, 0, 5]])[0], batch[i])
    exact = x.double().sum(dim=(1, 2), keepdim=True)
    np.testing.assert_allclose(batch.double(), exact, rtol=1e-6)


def test_fixed_rows_matmul_matches_one_product():
    """Any row count (a ragged last chunk, fewer rows than a chunk) and
    the gradients; a tile's rows give the same bits alone and batched."""
    from bathymetric_gnn_tpu_torch.models.layers import fixed_rows_matmul

    rg = np.random.default_rng(4)
    k = torch.from_numpy(rg.normal(0, 1, (7, 5)).astype(np.float32))
    for shape in ((3, 10, 10, 7), (2, 7), (1, 7)):
        x = torch.from_numpy(rg.normal(0, 1, shape).astype(np.float32))
        x.requires_grad_(True)
        y = fixed_rows_matmul(x, k, rows=64)
        assert y.shape == shape[:-1] + (5,)
        np.testing.assert_allclose(y.detach(), (x @ k).detach(), rtol=1e-6,
                                   atol=1e-6)
        (g,) = torch.autograd.grad(y.square().sum(), x)
        np.testing.assert_allclose(g, 2 * (x @ k).detach() @ k.T, rtol=1e-5,
                                   atol=1e-5)
    x = torch.from_numpy(rg.normal(0, 1, (3, 8, 8, 7)).astype(np.float32))
    batch = fixed_rows_matmul(x, k, rows=64)
    assert torch.equal(fixed_rows_matmul(x[1:2], k, rows=64)[0], batch[1])


def test_edge_terms_are_per_cell():
    """Kernel A's edge precompute: the edge logit terms and the self
    loop's mean incoming attribute equal the matrix forms, and a tile's
    terms are the same alone and batched."""
    from bathymetric_gnn_tpu_torch.ops.cuda.grid_gat_fused import (
        edge_precompute)

    rg = np.random.default_rng(5)
    b, k, h, w, heads = 3, 8, 6, 7, 4
    ea = torch.from_numpy(rg.normal(0, 1, (b, k, h, w, 3)).astype(
        np.float32))
    nbr = torch.from_numpy(rg.random((b, k, h, w)) > 0.2)
    me = torch.from_numpy(rg.normal(0, 1, (3, heads)).astype(np.float32))
    wl = torch.from_numpy(rg.normal(0, 1, (5, 8)).astype(np.float32))
    a = torch.from_numpy(rg.normal(0, 1, (8, heads)).astype(np.float32))
    _, el, el_self = edge_precompute(wl, a, a, me, ea, nbr, True)
    want = torch.einsum("bkhwf,fa->bkahw", ea, me)
    live = nbr[:, :, None].expand_as(want)
    np.testing.assert_allclose(el[live], want[live], rtol=1e-5, atol=1e-6)
    assert (el[~live] < -1e29).all()
    cnt = nbr.float().sum(1).clamp_min(1.0)[..., None]
    mean_in = torch.where(nbr[..., None], ea, 0.0).sum(1) / cnt
    np.testing.assert_allclose(
        el_self, torch.einsum("bhwf,fa->bahw", mean_in, me), rtol=1e-5,
        atol=1e-6)
    _, el1, self1 = edge_precompute(wl, a, a, me, ea[2:], nbr[2:], True)
    assert torch.equal(el1[0], el[2]) and torch.equal(self1[0], el_self[2])
