"""PyTorch port vs JAX: the report and preview CLIs and the host utils.

- ``cli/diagnose_tiles`` (a survey with NaN holes and a nodata value, and
  its printed JSON), ``cli/analyze_noise_patterns`` (a ground-truth
  raster) and ``cli/explore_bag`` (an SR and a VR BAG): the same reports
  as JAX's;
- ``cli/render_preview``: the hillshade equal to JAX's, and the same
  pixels in the PNG of a survey and of an inference-style output with a
  residual panel;
- ``data/multiscale``: the nanmean pyramid and the graphs built from it
  (grid-connectivity graphs through the port's ``GraphBuilder``) against
  JAX's, within the grid-graph parity tolerances of
  ``test_torch_grid_graph.py`` (1e-5; the local std 1e-4);
- ``utils/prof``: ``Stopwatch`` against JAX's; ``device_trace`` writes a
  Chrome trace of a CPU block.

Host only: no model runs on a card.
"""

import json

import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.cli import analyze_noise_patterns as jan
from bathymetric_gnn_tpu.cli import diagnose_tiles as jdiag
from bathymetric_gnn_tpu.cli import explore_bag as jexp
from bathymetric_gnn_tpu.cli import render_preview as jrp
from bathymetric_gnn_tpu.data import multiscale as jms
from bathymetric_gnn_tpu.utils.prof import Stopwatch as JaxStopwatch
from bathymetric_gnn_tpu_torch.cli import analyze_noise_patterns as tan
from bathymetric_gnn_tpu_torch.cli import diagnose_tiles as tdiag
from bathymetric_gnn_tpu_torch.cli import explore_bag as texp
from bathymetric_gnn_tpu_torch.cli import render_preview as trp
from bathymetric_gnn_tpu_torch.data import multiscale as tms
from bathymetric_gnn_tpu_torch.data.ground_truth import compute_ground_truth
from bathymetric_gnn_tpu_torch.io.bag import (BAG_NODATA, write_sr_bag,
                                              write_vr_bag)
from bathymetric_gnn_tpu_torch.io.geotiff import write_geotiff
from bathymetric_gnn_tpu_torch.utils import prof

from conftest import make_ramp_surface

TOL = dict(rtol=1e-5, atol=1e-5)
STD_TOL = dict(rtol=0, atol=1e-4)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("tools")
    rg = np.random.default_rng(21)
    depth = make_ramp_surface(90, 70, seed=22)
    noisy = depth + 0.03
    hit = rg.random(depth.shape) < 0.08
    noisy[hit] += rg.uniform(-3, 3, hit.sum()).astype(np.float32)
    noisy[20:30, 40:60] = np.nan
    noisy[60:65, :] = -9999.0
    depth[:5, :5] = np.nan
    kw = dict(pixel_scale=(2.0, 2.0), origin=(300.0, 800.0))
    write_geotiff(d / "clean.tif", depth[None], nodata=-9999.0, **kw)
    write_geotiff(d / "noisy.tif", noisy[None], nodata=-9999.0, **kw)
    gt = compute_ground_truth(d / "clean.tif", d / "noisy.tif",
                              d / "gt")["output"]
    cls = np.where(hit, 2.0, 0.0).astype(np.float32)
    out = np.stack([np.where(hit, depth, noisy), cls,
                    rg.uniform(0, 1, depth.shape).astype(np.float32),
                    np.where(hit, noisy - depth, 0.0)]).astype(np.float32)
    write_geotiff(d / "out.tif", out, nodata=-9999.0, **kw)
    bd = (20 + rg.normal(0, 1, (30, 40))).astype(np.float32)
    bd[0, :5] = BAG_NODATA
    write_sr_bag(d / "sr.bag", bd, rg.uniform(0.1, 0.5, bd.shape),
                 resolution=2.0, origin=(1000.0, 5000.0))
    refs = []
    for i, (dy, dx) in enumerate([(3, 3), (5, 4), (8, 8), (16, 16)]):
        r = (20 + rg.normal(0, 1, (dy, dx))).astype(np.float32)
        r[0, 0] = BAG_NODATA
        refs.append((i // 2, i % 2, r,
                     rg.uniform(0.1, 0.5, r.shape).astype(np.float32),
                     16.0 / dx))
    write_vr_bag(d / "vr.bag", (2, 2), 16.0, refs, origin=(100.0, 200.0))
    return d, gt


def test_diagnose_tiles_matches_jax(files, capsys):
    d, _ = files
    path = str(d / "noisy.tif")
    want = jdiag.diagnose(path, tile_size=32, overlap=8)
    assert tdiag.diagnose(path, tile_size=32, overlap=8) == want
    assert want["nodata"] == 5 * 70 and want["tiles"]["total"] > 4
    argv = [path, "--tile-size", "40", "--overlap", "8"]
    jdiag.main(argv)
    jout = capsys.readouterr().out
    got = tdiag.main(argv)
    assert capsys.readouterr().out == jout
    assert got == json.loads(jout)


def test_analyze_noise_patterns_matches_jax(files, tmp_path):
    _, gt = files
    want = jan.analyze_ground_truth(gt)
    got = tan.analyze_ground_truth(gt)
    assert got == want
    assert want["noise_cells"] > 0 and "clusters" in want
    jan.main([str(gt), "--output-json", str(tmp_path / "j.json")])
    tan.main([str(gt), "--output-json", str(tmp_path / "t.json")])
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


@pytest.mark.parametrize("bag", ["sr.bag", "vr.bag"])
def test_explore_bag_matches_jax(files, bag, capsys):
    d, _ = files
    want = jexp.analyze_bag(d / bag)
    got = texp.analyze_bag(d / bag)
    assert got == want
    assert want["type"] == bag[:2].upper()
    jexp.main([str(d / bag)])
    jout = capsys.readouterr().out
    texp.main([str(d / bag)])
    assert capsys.readouterr().out == jout


def test_render_preview_matches_jax(files, tmp_path, capsys):
    from matplotlib.image import imread

    d, _ = files
    depth = make_ramp_surface(50, 60, seed=23)
    depth[10:20, 10:20] = np.nan
    np.testing.assert_array_equal(trp.hillshade(depth), jrp.hillshade(depth))
    np.testing.assert_array_equal(trp.hillshade(depth, 200.0, 30.0),
                                  jrp.hillshade(depth, 200.0, 30.0))
    for name, extra in (("noisy", []),
                        ("out", ["--original", str(d / "noisy.tif")])):
        src = str(d / f"{name}.tif")
        png = {}
        for tag, cli in (("jax", jrp), ("port", trp)):
            png[tag] = tmp_path / f"{name}_{tag}.png"
            cli.main([src, "--output", str(png[tag]), "--dpi", "40"] + extra)
        assert capsys.readouterr().out.split() == [str(png["jax"]),
                                                   str(png["port"])]
        a, b = imread(png["port"]), imread(png["jax"])
        assert a.shape == b.shape and a.shape[0] > 50
        np.testing.assert_array_equal(a, b)


def _check_graph(t, j):
    for f in ("edge_src", "edge_dst", "edge_mask", "node_mask", "pos"):
        np.testing.assert_array_equal(getattr(t.graph, f),
                                      np.asarray(getattr(j.graph, f)))
    np.testing.assert_allclose(t.graph.x, np.asarray(j.graph.x), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(t.graph.edge_attr,
                               np.asarray(j.graph.edge_attr), **TOL)
    np.testing.assert_allclose(t.graph.local_std,
                               np.asarray(j.graph.local_std), **STD_TOL)


def test_multiscale_matches_jax():
    depth = make_ramp_surface(37, 41, seed=24)
    rg = np.random.default_rng(25)
    depth[rg.random(depth.shape) < 0.2] = np.nan
    valid = np.isfinite(depth)
    for f in (1, 2, 4):
        td, tv = tms.downsample_depth(depth, valid, f)
        jd, jv = jms.downsample_depth(depth, valid, f)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tv, jv)
    unc = rg.uniform(0.1, 0.4, depth.shape).astype(np.float32)
    t = tms.MultiScaleGraphBuilder().build_multiscale_graph(
        depth, valid, unc, (1.5, 2.0))
    j = jms.MultiScaleGraphBuilder().build_multiscale_graph(
        depth, valid, unc, (1.5, 2.0))
    assert sorted(t) == sorted(j) == [1, 2, 4]
    for s in (1, 2, 4):
        assert t[s].num_nodes == j[s].num_nodes > 0
        assert t[s].grid_shape == j[s].grid_shape
        _check_graph(t[s], j[s])


def test_stopwatch_and_device_trace(tmp_path):
    sws = [prof.Stopwatch(), JaxStopwatch()]
    for sw in sws:
        for name in ("a", "b", "a"):
            with sw.time(name):
                pass
    s, js = (sw.summary() for sw in sws)
    assert s.keys() == js.keys() == {"a", "b"}
    assert [s[k]["count"] for k in "ab"] == [js[k]["count"] for k in "ab"] \
        == [2, 1]
    with prof.device_trace(None):
        pass
    assert not any(tmp_path.iterdir())
    with prof.device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "trace" / prof.TRACE_FILE).read_text())[
        "traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
