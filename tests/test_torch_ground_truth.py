"""PyTorch port vs JAX: ground-truth preparation and the S-57 tools.

- ``data/ground_truth.compute_ground_truth`` through both packages' CLIs
  on a clean/noisy pair (the noisy copy with spikes, a +0.05 m offset, NaN
  holes and its origin shifted by a few cells, so the intersection does
  work), without an overlay, with an ENC cell and with a features
  GeoJSON: the same 5-band raster (NaN where NaN) and the same stats;
  the overlay's class-1 discs where the features are;
- ``io/s57_8211``: the port's ``S57Writer`` writes the bytes JAX's writes,
  and each package's ``read_s57_cell`` decodes the other's cell to the
  same records (the 8211 walk too, leader reuse included);
- ``cli/extract_s57_features``: the summary, GeoJSON and label raster of
  an ENC cell (with a ``--bounds`` filter) and of a GeoJSON input, equal
  to JAX's.

All on the host with NumPy: no model runs.
"""

import dataclasses
import json

import numpy as np
import pytest

from bathymetric_gnn_tpu.cli import extract_s57_features as jx_cli
from bathymetric_gnn_tpu.cli import prepare_ground_truth as jgt_cli
from bathymetric_gnn_tpu.io import s57_8211 as j8211
from bathymetric_gnn_tpu_torch.cli import extract_s57_features as tx_cli
from bathymetric_gnn_tpu_torch.cli import prepare_ground_truth as tgt_cli
from bathymetric_gnn_tpu_torch.data import s57 as ts57
from bathymetric_gnn_tpu_torch.io import s57_8211 as t8211
from bathymetric_gnn_tpu_torch.io.geotiff import read_geotiff, write_geotiff

from conftest import make_ramp_surface

SHIFT = (3, 5)          # the noisy survey's origin, in cells down / right
ORIGIN = (1000.0, 2100.0)
COMF = 1e5              # coordinates of a few thousand metres fit int32


def _write_cell(mod, path):
    """A cell with a wreck, a rock, an obstruction on an edge between two
    connected nodes (no SG2D of its own), and two soundings, on the pair's
    projected metres."""
    w = mod.S57Writer(comf=COMF)
    wreck = w.add_node(1030.0, 2070.0, depth=14.5)
    rock = w.add_node(1055.0, 2045.0)
    a = w.add_connected_node(1010.0, 2040.0)
    b = w.add_connected_node(1020.0, 2030.0)
    edge = w.add_edge([], begin_node=a, end_node=b)
    snd = w.add_node(0, 0, soundings=[(1040.5, 2050.5, 9.3),
                                      (1041.0, 2049.0, 9.7)])
    w.add_feature("WRECKS", [wreck], attributes={
        "CATWRK": 2, "OBJNAM": "SS Test", "VALSOU": 15.2})
    w.add_feature("UWTROC", [rock], attributes={"WATLEV": 3})
    w.add_feature("OBSTRN", [edge], prim=2)
    w.add_feature("SOUNDG", [snd])
    w.save(path)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    d = tmp_path_factory.mktemp("pair")
    rg = np.random.default_rng(11)
    n, (dr, dc) = 80, SHIFT
    surface = make_ramp_surface(n + dr, n + dc, seed=12)
    clean = surface[:n, :n].copy()
    clean[50:60, 5:25] = np.nan
    noisy = surface[dr:, dc:] + 0.05
    hit = rg.random(noisy.shape) < 0.06
    noisy[hit] += rg.uniform(-2, 2, hit.sum()).astype(np.float32)
    noisy[rg.random(noisy.shape) < 0.01] = np.nan
    unc = rg.uniform(0.1, 0.4, noisy.shape).astype(np.float32)
    x0, y0 = ORIGIN
    write_geotiff(d / "clean.tif", clean[None], pixel_scale=(1.0, 1.0),
                  origin=(x0, y0), nodata=float("nan"))
    write_geotiff(d / "noisy.tif", np.stack([noisy, unc]),
                  pixel_scale=(1.0, 1.0), origin=(x0 + dc, y0 - dr),
                  nodata=float("nan"))
    _write_cell(t8211, d / "cell.000")
    ts57.features_to_geojson(ts57.extract_features_from_s57(d / "cell.000"),
                             d / "features.geojson")
    return d


@pytest.mark.parametrize("overlay", [None, "cell.000", "features.geojson"])
def test_prepare_ground_truth_matches_jax(pair, tmp_path, overlay, capsys):
    base = ["--clean", str(pair / "clean.tif"), "--noisy",
            str(pair / "noisy.tif")]
    if overlay:
        base += ["--s57", str(pair / overlay)]
    jgt_cli.main(base + ["--output-dir", str(tmp_path / "jax")])
    stats = tgt_cli.main(base + ["--output-dir", str(tmp_path / "port")])
    capsys.readouterr()
    jstats = json.loads((tmp_path / "jax" / "noisy_gt_stats.json").read_text())
    tstats = json.loads((tmp_path / "port" / "noisy_gt_stats.json"
                         ).read_text())
    assert stats == tstats
    for s in (jstats, tstats):
        s.pop("output")
    assert tstats == jstats
    assert abs(tstats["systematic_offset_m"] - 0.05) < 0.01
    tb, tinfo = read_geotiff(tmp_path / "port" / "noisy_ground_truth.tif")
    jb, jinfo = read_geotiff(tmp_path / "jax" / "noisy_ground_truth.tif")
    np.testing.assert_array_equal(tb, jb)
    assert tinfo.geotransform == jinfo.geotransform
    n = 80
    assert tb.shape == (5, n - SHIFT[0], n - SHIFT[1])
    assert tinfo.geotransform[0] == ORIGIN[0] + SHIFT[1]
    labels = tb[0]
    if overlay is None:
        assert tstats["feature_cells"] == 0
        assert set(np.unique(labels)) <= {-1.0, 0.0, 2.0}
    else:
        # the wreck's disc (50 m) around its cell, within the survey
        gt = tinfo.geotransform
        col = int(round((1030.0 - gt[0]) / gt[1]))
        row = int(round((2070.0 - gt[3]) / gt[5]))
        assert labels[row, col] == 1
        assert tstats["feature_cells"] == int((labels == 1).sum()) > 100


def _records(cell):
    return dataclasses.asdict(cell)


def test_s57_writer_and_reader_match_jax(tmp_path):
    _write_cell(t8211, tmp_path / "port.000")
    _write_cell(j8211, tmp_path / "jax.000")
    data = (tmp_path / "port.000").read_bytes()
    assert data == (tmp_path / "jax.000").read_bytes()
    for path in (tmp_path / "port.000", tmp_path / "jax.000"):
        assert _records(t8211.read_s57_cell(path)) == \
            _records(j8211.read_s57_cell(path))
    walk = [(r.leader_id, r.fields) for r in t8211.iter_8211_records(data)]
    assert walk == [(r.leader_id, r.fields)
                    for r in j8211.iter_8211_records(data)]
    cell = t8211.read_s57_cell(tmp_path / "port.000")
    assert cell.comf == COMF and len(cell.features) == 4
    wreck = cell.features[0]
    assert wreck.object_class == "WRECKS"
    assert wreck.attributes == {"CATWRK": 2, "OBJNAM": "SS Test",
                                "VALSOU": 15.2}
    # the straight edge's geometry comes from its end nodes only
    ob = cell.features[2]
    assert t8211.feature_points(cell, ob) == j8211.feature_points(
        j8211.read_s57_cell(tmp_path / "port.000"),
        j8211.read_s57_cell(tmp_path / "port.000").features[2])
    # an 'R' leader: later records reuse its directory
    rec = j8211._record_bytes("R", [("VRID", b"\x6e" + b"\x00" * 7)])
    area = rec[int(rec[12:17]):]
    stream = rec + area + area
    assert [(r.leader_id, r.fields) for r in
            t8211.iter_8211_records(stream)] == \
        [(r.leader_id, r.fields) for r in j8211.iter_8211_records(stream)]


@pytest.mark.parametrize("source", ["enc", "geojson"])
def test_extract_s57_features_matches_jax(pair, tmp_path, source, capsys):
    if source == "enc":
        argv = ["--enc", str(pair / "cell.000"), "--bounds", "1000",
                "2000", "1050", "2100"]
    else:
        argv = ["--geojson", str(pair / "features.geojson")]
    argv += ["--survey", str(pair / "noisy.tif"), "--wreck-radius", "12"]
    out = {}
    for name, cli in (("jax", jx_cli), ("port", tx_cli)):
        capsys.readouterr()
        cli.main(argv + ["--output-geojson", str(tmp_path / f"{name}.json"),
                         "--output-labels", str(tmp_path / f"{name}.tif")])
        out[name] = (capsys.readouterr().out,
                     (tmp_path / f"{name}.json").read_text(),
                     read_geotiff(tmp_path / f"{name}.tif")[0])
    (js, jj, jl), (ts, tj, tl) = out["jax"], out["port"]
    assert ts == js and tj == jj
    np.testing.assert_array_equal(tl, jl)
    summary = json.loads(ts)
    if source == "enc":
        # the rock at x 1055 lies outside the bounds
        assert "UWTROC" not in summary["by_class"]
        assert summary["by_class"]["WRECKS"] == 1
    assert (tl == 1).sum() > 0
