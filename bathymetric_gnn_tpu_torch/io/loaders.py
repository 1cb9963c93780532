"""Raster ingest/egress facade.

Copy of ``bathymetric_gnn_tpu/io/loaders.py`` for the PyTorch port:
GeoTIFF (io/geotiff.py) and ESRI ASCII in, GeoTIFF and ASCII out, and
``read_raster_bands`` for the ground-truth datasets. BAG
input and output raise ``NotImplementedError`` until the BAG codec is
ported (it needs h5py). ``vr_bag_mode`` is still validated so that the
CLI's flag keeps its meaning.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from .geotiff import read_geotiff, write_geotiff

logger = logging.getLogger(__name__)

# The BAG codec (bathymetric_gnn_tpu/io/bag.py) needs h5py, which the port
# does not depend on; porting it is the next item of ROADMAP.md's queue 1.
_BAG_NOT_PORTED = ("BAG files are not supported by the PyTorch port yet "
                   "(ROADMAP.md, queue 1: 'BAG codec'); convert {path} to "
                   "GeoTIFF or use the JAX package's CLI")


@dataclass
class BathymetricGrid:
    """Depth grid + metadata (reference: data/loaders.py:41-90)."""

    depth: np.ndarray
    uncertainty: Optional[np.ndarray] = None
    geotransform: Optional[Tuple[float, ...]] = None
    crs: Optional[str] = None
    resolution: Tuple[float, float] = (1.0, 1.0)
    nodata: Optional[float] = None
    source_path: Optional[str] = None

    @property
    def valid_mask(self) -> np.ndarray:
        """Finite and not nodata (canonical validity —
        reference: data/loaders.py:59-71)."""
        m = np.isfinite(self.depth)
        if self.nodata is not None:
            m &= self.depth != self.nodata
        m &= np.abs(self.depth) < 1.0e5
        return m

    @property
    def valid_ratio(self) -> float:
        return float(self.valid_mask.mean())

    @property
    def bounds(self) -> Optional[Tuple[float, float, float, float]]:
        if self.geotransform is None:
            return None
        gt = self.geotransform
        h, w = self.depth.shape
        return (gt[0], gt[3] + h * gt[5], gt[0] + w * gt[1], gt[3])

    def get_statistics(self) -> Dict[str, float]:
        v = self.depth[self.valid_mask]
        if v.size == 0:
            return {"count": 0}
        return {
            "count": int(v.size), "min": float(v.min()),
            "max": float(v.max()), "mean": float(v.mean()),
            "std": float(v.std()), "valid_ratio": self.valid_ratio,
        }


class BathymetricLoader:
    """Multi-format loader (reference: data/loaders.py:93-475)."""

    def __init__(self, vr_bag_mode: str = "refinements"):
        if vr_bag_mode not in ("refinements", "resampled", "base"):
            raise ValueError(f"bad vr_bag_mode {vr_bag_mode}")
        self.vr_bag_mode = vr_bag_mode

    def load(self, path,
             vr_target_resolution: Optional[float] = None) -> BathymetricGrid:
        path = Path(path)
        suffix = path.suffix.lower()
        if suffix == ".bag":
            return self._load_bag(path, vr_target_resolution)
        if suffix in (".tif", ".tiff"):
            return self._load_geotiff(path)
        if suffix in (".asc", ".txt"):
            return self._load_ascii(path)
        raise ValueError(f"unsupported format: {path}")

    # -- BAG ---------------------------------------------------------------

    def _load_bag(self, path,
                  vr_target_resolution: Optional[float] = None
                  ) -> BathymetricGrid:
        raise NotImplementedError(_BAG_NOT_PORTED.format(path=path))

    # -- GeoTIFF / ASC -----------------------------------------------------

    def _load_geotiff(self, path) -> BathymetricGrid:
        bands, info = read_geotiff(path)
        depth = bands[0].astype(np.float32)
        unc = bands[1].astype(np.float32) if info.bands > 1 else None
        gt = info.geotransform
        res = (abs(gt[1]), abs(gt[5])) if gt else (1.0, 1.0)
        return BathymetricGrid(
            depth=depth, uncertainty=unc, geotransform=gt, crs=info.crs_wkt,
            resolution=res, nodata=info.nodata, source_path=str(path),
        )

    def _load_ascii(self, path) -> BathymetricGrid:
        """ESRI ASCII grid (reference: data/loaders.py:428-463)."""
        header: Dict[str, float] = {}
        with open(path) as f:
            pos = 0
            for _ in range(6):
                line = f.readline().split()
                if len(line) != 2 or not _is_float(line[1]):
                    break
                header[line[0].lower()] = float(line[1])
                pos = f.tell()
            f.seek(pos)
            data = np.loadtxt(f, dtype=np.float32)
        ncols = int(header.get("ncols", data.shape[-1]))
        nrows = int(header.get("nrows", data.size // ncols))
        data = data.reshape(nrows, ncols)
        cell = header.get("cellsize", 1.0)
        nodata = header.get("nodata_value")
        xll = header.get("xllcorner", 0.0)
        yll = header.get("yllcorner", 0.0)
        gt = (xll, cell, 0.0, yll + nrows * cell, 0.0, -cell)
        return BathymetricGrid(
            depth=data, geotransform=gt, resolution=(cell, cell),
            nodata=nodata, source_path=str(path),
        )


def _is_float(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False


class BathymetricWriter:
    """Multi-format writer (reference: data/loaders.py:478-823).

    ``compress_level``: zlib level for GeoTIFF output (1 = fastest; the
    inference pipeline uses 1 — writes are on the wall-clock path)."""

    def __init__(self, compress_level: int = 6):
        self.compress_level = compress_level

    def save(
        self,
        grid: BathymetricGrid,
        path,
        extra_bands: Optional[Dict[str, np.ndarray]] = None,
        source_bag: Optional[str] = None,
    ):
        path = Path(path)
        suffix = path.suffix.lower()
        if suffix in (".tif", ".tiff"):
            self._save_geotiff(grid, path, extra_bands)
        elif suffix == ".bag":
            self._save_bag(grid, path, extra_bands, source_bag)
        elif suffix == ".asc":
            self._save_ascii(grid, path)
        else:
            raise ValueError(f"unsupported output format: {path}")

    def _save_geotiff(self, grid, path, extra_bands):
        bands = [grid.depth.astype(np.float32)]
        names = ["depth"]
        if grid.uncertainty is not None:
            bands.append(grid.uncertainty.astype(np.float32))
            names.append("uncertainty")
        for k, v in (extra_bands or {}).items():
            bands.append(np.asarray(v, np.float32))
            names.append(k)
        gt = grid.geotransform
        write_geotiff(
            path, np.stack(bands),
            pixel_scale=(abs(gt[1]), abs(gt[5])) if gt else None,
            origin=(gt[0], gt[3]) if gt else None,
            nodata=grid.nodata if grid.nodata is not None else np.nan,
            crs_wkt=grid.crs, band_descriptions=names,
            compress_level=self.compress_level,
        )

    def _save_bag(self, grid, path, extra_bands, source_bag):
        raise NotImplementedError(_BAG_NOT_PORTED.format(path=path))

    def _save_ascii(self, grid, path):
        h, w = grid.depth.shape
        gt = grid.geotransform or (0, 1, 0, h, 0, -1)
        nodata = grid.nodata if grid.nodata is not None else -9999.0
        depth = np.where(grid.valid_mask, grid.depth, nodata)
        with open(path, "w") as f:
            f.write(f"ncols {w}\nnrows {h}\n")
            f.write(f"xllcorner {gt[0]}\nyllcorner {gt[3] + h * gt[5]}\n")
            f.write(f"cellsize {abs(gt[1])}\nnodata_value {nodata}\n")
            np.savetxt(f, depth, fmt="%.4f")


def read_raster_bands(path, bands: Optional[List[int]] = None
                      ) -> Tuple[List[np.ndarray], Dict]:
    """Read selected 1-indexed bands of a raster (GT dataset hook)."""
    path = Path(path)
    if path.suffix.lower() in (".tif", ".tiff"):
        all_bands, info = read_geotiff(path)
        gt = info.geotransform
        meta = {
            "resolution": (abs(gt[1]), abs(gt[5])) if gt else (1.0, 1.0),
            "nodata": info.nodata, "geotransform": gt, "crs": info.crs_wkt,
        }
        if bands is None:
            return [all_bands[i] for i in range(all_bands.shape[0])], meta
        return [all_bands[i - 1] for i in bands], meta
    raise ValueError(f"unsupported raster: {path}")
