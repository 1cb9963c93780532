"""Raster ingest/egress facade.

Copy of ``bathymetric_gnn_tpu/io/loaders.py`` for the PyTorch port. Loader
and writer sit on the GDAL-free codecs: GeoTIFF (io/geotiff.py), ASC
(inline), BAG (io/bag.py, which imports h5py only when a BAG is opened).
VR BAG modes mirror the reference (reference: data/loaders.py:98-107):
'refinements' iterates native grids, 'resampled' rasterizes refinements to
the finest resolution, 'base' reads the coarse base grid.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config.constants import BAG_NODATA
from .bag import SRBagHandler, VRBagHandler, detect_bag_type, write_sr_bag
from .geotiff import read_geotiff, write_geotiff

logger = logging.getLogger(__name__)


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
        """Three distinct VR modes (reference: data/loaders.py:98-107,
        165-245):
        - 'refinements': mosaic native refinement grids at the finest
          refinement resolution (reference: data/loaders.py:246-313);
        - 'resampled': uniform grid at ``vr_target_resolution`` (defaults
          to finest), the GDAL MODE=RESAMPLED_GRID / RESX/RESY analogue
          (reference: data/loaders.py:314-384);
        - 'base': coarse base grid only.
        """
        kind = detect_bag_type(path)
        if kind == "SR":
            return self._load_sr_bag(path)
        if self.vr_bag_mode == "base":
            return self._load_vr_base(path)
        if self.vr_bag_mode == "resampled":
            return self._load_vr_resampled(path, vr_target_resolution)
        return self._load_vr_resampled(path, None)  # refinements: finest

    def load_refinement_grids(self, path, min_valid_ratio: float = 0.0):
        """Yield each native refinement as its own georeferenced
        BathymetricGrid (north-up rows) — the training-from-native-
        refinements surface of the reference's 'refinements' mode
        (reference: data/loaders.py:246-313). SR BAGs yield the whole
        grid once (reference: data/vr_bag.py:395-428)."""
        path = Path(path)
        kind = detect_bag_type(path)
        if kind == "SR":
            g = self._load_sr_bag(path)
            if g.valid_ratio >= min_valid_ratio:
                yield g
            return
        h = VRBagHandler(path)
        b = h.bounds
        base_cs = h.base_cell_size
        for grid in h.iterate_refinements(min_valid_ratio):
            rx, ry = grid.resolution
            gh, gw = grid.depth.shape
            cell_x = b[0] + grid.base_col * base_cs[0] + grid.sw_corner[0]
            cell_y = b[1] + grid.base_row * base_cs[1] + grid.sw_corner[1]
            gt = (cell_x, rx, 0.0, cell_y + gh * ry, 0.0, -ry)
            yield BathymetricGrid(
                depth=np.flipud(grid.depth).copy(),
                uncertainty=np.flipud(grid.uncertainty).copy(),
                geotransform=gt, crs=h.crs, resolution=(rx, ry),
                nodata=BAG_NODATA, source_path=str(path),
            )

    def _load_sr_bag(self, path) -> BathymetricGrid:
        h = SRBagHandler(path)
        depth = np.flipud(h._depth)  # BAG row 0 = south -> north-up
        unc = np.flipud(h._uncertainty)
        return BathymetricGrid(
            depth=depth, uncertainty=unc, geotransform=h.geotransform,
            crs=h.crs, resolution=(h.resolution, h.resolution),
            nodata=BAG_NODATA, source_path=str(path),
        )

    def _load_vr_base(self, path) -> BathymetricGrid:
        from .bag import _h5py

        h = VRBagHandler(path)
        with _h5py().File(str(path), "r") as f:
            depth = np.flipud(f["BAG_root"]["elevation"][:]).astype(np.float32)
        cs = h.base_cell_size
        return BathymetricGrid(
            depth=depth, geotransform=h.geotransform, crs=h.crs,
            resolution=cs, nodata=BAG_NODATA, source_path=str(path),
        )

    def _load_vr_resampled(
        self, path, target_resolution: Optional[float] = None
    ) -> BathymetricGrid:
        """Rasterize all refinements onto a uniform canvas — the GDAL-free
        equivalent of MODE=RESAMPLED_GRID with RESX/RESY
        (reference: data/loaders.py:314-384). ``target_resolution=None``
        uses the finest refinement resolution (the 'refinements' mosaic);
        a coarser/finer value nearest-samples each refinement cell onto
        the target canvas."""
        h = VRBagHandler(path)
        b = h.bounds
        fin = h.finest_resolution
        res = float(target_resolution) if target_resolution else fin
        if target_resolution:
            shape = (max(int(round((b[3] - b[1]) / res)), 1),
                     max(int(round((b[2] - b[0]) / res)), 1))
        else:
            shape = h.resampled_shape
        depth = np.full(shape, BAG_NODATA, np.float32)
        unc = np.full(shape, 0.0, np.float32)
        base_cs = h.base_cell_size
        for grid in h.iterate_refinements():
            cell_x = b[0] + grid.base_col * base_cs[0] + grid.sw_corner[0]
            cell_y = b[1] + grid.base_row * base_cs[1] + grid.sw_corner[1]
            _place_refinement(depth, unc, grid, cell_x, cell_y, b, res, shape)
        gt = (b[0], res, 0.0, b[3], 0.0, -res)
        return BathymetricGrid(
            depth=depth, uncertainty=unc, geotransform=gt, crs=h.crs,
            resolution=(res, res), nodata=BAG_NODATA, source_path=str(path),
        )

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


def _place_refinement(depth, unc, grid, cell_x, cell_y, bounds, res, shape,
                      row_offset: int = 0):
    """Nearest-center sample one refinement onto a north-up canvas at
    resolution ``res``. ``row_offset`` shifts canvas rows for windowed
    (row-band) rasterization: canvas row 0 corresponds to global row
    ``row_offset``. Vectorized (no per-cell Python loops — SURVEY Q5)."""
    gh, gw = grid.depth.shape
    rx, ry = grid.resolution
    b = bounds
    x_max = cell_x + gw * rx
    y_max = cell_y + gh * ry
    px0 = max(int(np.floor((cell_x - b[0]) / res + 1e-9)), 0)
    px1 = min(int(np.ceil((x_max - b[0]) / res - 1e-9)), shape[1])
    py0 = max(int(np.floor((b[3] - y_max) / res + 1e-9)) - row_offset, 0)
    py1 = min(int(np.ceil((b[3] - cell_y) / res - 1e-9)) - row_offset,
              shape[0])
    if px1 <= px0 or py1 <= py0:
        return
    xs = b[0] + (np.arange(px0, px1) + 0.5) * res
    ys = b[3] - (np.arange(py0, py1) + row_offset + 0.5) * res
    ci = np.clip(((xs - cell_x) / rx).astype(np.int64), 0, gw - 1)
    ri = np.clip(((ys - cell_y) / ry).astype(np.int64), 0, gh - 1)
    d = grid.depth[np.ix_(ri, ci)]
    m = (d != BAG_NODATA) & np.isfinite(d)
    blk = depth[py0:py1, px0:px1]
    blk[m] = d[m]
    if unc is not None and grid.uncertainty is not None:
        u = grid.uncertainty[np.ix_(ri, ci)]
        ub = unc[py0:py1, px0:px1]
        ub[m] = u[m]


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
        """Copy-and-modify when a source BAG is given
        (reference: data/loaders.py:579-733), else create a new SR BAG
        (capability the reference lacks)."""
        import shutil

        from .bag import _h5py

        if source_bag and Path(source_bag).exists():
            shutil.copy(str(source_bag), str(path))
            with _h5py().File(str(path), "r+") as f:
                root = f["BAG_root"]
                depth_s = np.flipud(grid.depth)  # back to south-up
                if root["elevation"].shape == depth_s.shape:
                    elev = np.where(np.isfinite(depth_s), depth_s, BAG_NODATA)
                    root["elevation"][:] = elev.astype(np.float32)
                    if grid.uncertainty is not None and "uncertainty" in root:
                        root["uncertainty"][:] = np.flipud(
                            grid.uncertainty).astype(np.float32)
                else:
                    logger.warning(
                        "BAG base shape %s != grid %s; base left unmodified",
                        root["elevation"].shape, depth_s.shape)
        else:
            depth_s = np.flipud(np.where(grid.valid_mask, grid.depth,
                                         BAG_NODATA))
            unc_s = (np.flipud(grid.uncertainty)
                     if grid.uncertainty is not None else None)
            b = grid.bounds or (0, 0, grid.depth.shape[1], grid.depth.shape[0])
            write_sr_bag(path, depth_s, unc_s, grid.resolution[0],
                         origin=(b[0], b[1]), crs=grid.crs or "UTM")
        if extra_bands:
            sidecar = path.with_name(path.stem + "_gnn_outputs.tif")
            self._save_sidecar(grid, sidecar, extra_bands)

    def _save_sidecar(self, grid, path, extra_bands):
        """Sidecar GeoTIFF with the GNN output bands
        (reference: data/loaders.py:761-800)."""
        gt = grid.geotransform
        write_geotiff(
            path, np.stack([np.asarray(v, np.float32)
                            for v in extra_bands.values()]),
            pixel_scale=(abs(gt[1]), abs(gt[5])) if gt else None,
            origin=(gt[0], gt[3]) if gt else None,
            nodata=-1.0, crs_wkt=grid.crs,
            band_descriptions=list(extra_bands.keys()),
            compress_level=self.compress_level,
        )

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
