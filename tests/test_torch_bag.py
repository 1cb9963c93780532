"""PyTorch port vs JAX: BAG input and output of the tiled path.

The port's ``io/loaders`` reads BAGs through its copy of ``io/bag.py``; the
same SR and VR BAGs (written by the JAX package's writers from numpy
seeds) load into the same arrays and metadata through both packages' loaders
in every VR mode, and a BAG written by the port's writer (copy-and-modify
of a source BAG, or a new SR BAG) reads back equal to the JAX writer's.
"""

import numpy as np
import pytest

from bathymetric_gnn_tpu.config.constants import BAG_NODATA
from bathymetric_gnn_tpu.io.bag import write_sr_bag, write_vr_bag
from bathymetric_gnn_tpu.io.loaders import (BathymetricLoader as JaxLoader,
                                            BathymetricWriter as JaxWriter)
from bathymetric_gnn_tpu_torch.io.loaders import (BathymetricLoader,
                                                  BathymetricWriter)


@pytest.fixture(scope="module")
def bags(tmp_path_factory):
    d = tmp_path_factory.mktemp("bags")
    rg = np.random.default_rng(0)
    depth = (20 + rg.normal(0, 1, (30, 40))).astype(np.float32)
    depth[0, :5] = BAG_NODATA
    unc = rg.uniform(0.1, 0.5, depth.shape).astype(np.float32)
    write_sr_bag(d / "sr.bag", depth, unc, resolution=2.0,
                 origin=(1000.0, 5000.0))
    refs = []
    for i, (dy, dx) in enumerate([(3, 3), (5, 4), (8, 8), (16, 16)]):
        r = (20 + rg.normal(0, 1, (dy, dx))).astype(np.float32)
        r[0, 0] = BAG_NODATA
        refs.append((i // 2, i % 2, r,
                     rg.uniform(0.1, 0.5, r.shape).astype(np.float32),
                     16.0 / dx))
    write_vr_bag(d / "vr.bag", (2, 2), 16.0, refs, origin=(100.0, 200.0))
    return d


def _same_grid(a, b):
    np.testing.assert_array_equal(a.depth, b.depth)
    if b.uncertainty is None:
        assert a.uncertainty is None
    else:
        np.testing.assert_array_equal(a.uncertainty, b.uncertainty)
    assert a.geotransform == b.geotransform and a.crs == b.crs
    assert tuple(a.resolution) == tuple(b.resolution)
    assert a.nodata == b.nodata
    np.testing.assert_array_equal(a.valid_mask, b.valid_mask)


@pytest.mark.parametrize("name,mode,target", [
    ("sr.bag", "refinements", None),
    ("vr.bag", "refinements", None),
    ("vr.bag", "resampled", None),
    ("vr.bag", "resampled", 3.0),
    ("vr.bag", "base", None),
])
def test_loader_matches_jax(bags, name, mode, target):
    got = BathymetricLoader(mode).load(bags / name, target)
    want = JaxLoader(mode).load(bags / name, target)
    _same_grid(got, want)
    assert np.any(got.valid_mask)


@pytest.mark.parametrize("name", ["sr.bag", "vr.bag"])
def test_refinement_grids_match_jax(bags, name):
    got = list(BathymetricLoader().load_refinement_grids(bags / name))
    want = list(JaxLoader().load_refinement_grids(bags / name))
    assert len(got) == len(want) >= 1
    for a, b in zip(got, want):
        _same_grid(a, b)


@pytest.mark.parametrize("source", [True, False])
def test_writer_matches_jax(bags, tmp_path, source):
    """Copy-and-modify of the SR BAG (with the sidecar of extra bands), or
    a new SR BAG when no source is given."""
    grid = BathymetricLoader().load(bags / "sr.bag")
    grid.depth = np.where(grid.valid_mask, grid.depth + 0.5, grid.depth)
    extra = {"confidence": np.full(grid.depth.shape, 0.5, np.float32)}
    src = str(bags / "sr.bag") if source else None
    BathymetricWriter().save(grid, tmp_path / "port.bag", extra, src)
    JaxWriter().save(grid, tmp_path / "jax.bag", extra, src)
    _same_grid(BathymetricLoader().load(tmp_path / "port.bag"),
               JaxLoader().load(tmp_path / "jax.bag"))
    assert (tmp_path / "port_gnn_outputs.tif").exists()
