"""Native BAG (ONS Bathymetric Attributed Grid) I/O via h5py.

Copy of ``bathymetric_gnn_tpu/io/bag.py`` for the PyTorch port, with one
change: ``h5py`` is imported when a BAG is opened (``_h5py``), not when the
module is imported, so the port imports on a machine without h5py and only
BAG input and output need it.

Re-design of the reference's VR/SR BAG layer (reference: data/vr_bag.py:
29-924) without GDAL: georeferencing is parsed from the BAG's ISO metadata
XML instead. Improvements over the reference:

- vectorized sidecar placement (the reference uses a quadruple-nested
  Python loop — SURVEY Q5)
- the functional driver applies corrections with the SUBTRACT convention
  everywhere (the reference's library path adds — SURVEY Q1)
- BAG files can be created from scratch (``write_sr_bag``/``write_vr_bag``),
  which the reference cannot (its _save_bag_new falls back to GeoTIFF,
  data/loaders.py:735).
"""

from __future__ import annotations

import logging
import re
import shutil
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Generator, List, Optional, Tuple

import numpy as np

from ..config.constants import BAG_INVALID_INDEX, BAG_NODATA

logger = logging.getLogger(__name__)


def _h5py():
    """h5py, imported on first use (see the module docstring)."""
    import h5py

    return h5py

VARRES_META_DTYPE = np.dtype([
    ("index", "<u4"), ("dimensions_x", "<u4"), ("dimensions_y", "<u4"),
    ("resolution_x", "<f4"), ("resolution_y", "<f4"),
    ("sw_corner_x", "<f4"), ("sw_corner_y", "<f4"),
])
VARRES_REF_DTYPE = np.dtype([("depth", "<f4"), ("depth_uncrt", "<f4")])


def detect_bag_type(path) -> str:
    """'VR' iff varres structures exist with any populated refinement
    (reference: data/vr_bag.py:29-63), else 'SR'."""
    with _h5py().File(str(path), "r") as f:
        if "BAG_root" not in f:
            raise ValueError(f"{path}: not a BAG file")
        root = f["BAG_root"]
        if "varres_metadata" in root and "varres_refinements" in root:
            dims = root["varres_metadata"]["dimensions_x"]
            if np.any(np.asarray(dims) > 0):
                return "VR"
    return "SR"


@dataclass
class RefinementGrid:
    """One refinement grid (reference: data/vr_bag.py:66-97)."""

    base_row: int
    base_col: int
    depth: np.ndarray
    uncertainty: np.ndarray
    resolution: Tuple[float, float]
    dimensions: Tuple[int, int]  # (rows, cols)
    sw_corner: Tuple[float, float]
    start_index: int

    @property
    def valid_mask(self) -> np.ndarray:
        return (self.depth != BAG_NODATA) & np.isfinite(self.depth)

    @property
    def num_valid(self) -> int:
        return int(self.valid_mask.sum())


def _parse_metadata_xml(xml: str) -> Dict[str, float]:
    """Best-effort georeferencing from BAG ISO metadata."""
    out: Dict[str, float] = {}
    m = re.search(
        r"<gmd:resolution>.*?<gco:Measure[^>]*>([0-9.eE+-]+)</gco:Measure>",
        xml, re.DOTALL,
    )
    if m:
        out["resolution"] = float(m.group(1))
    c = re.findall(r"<gml:coordinates>([^<]+)</gml:coordinates>", xml)
    if c:
        try:
            pairs = [tuple(map(float, p.split(","))) for p in c[0].split()]
            xs = [p[0] for p in pairs]
            ys = [p[1] for p in pairs]
            out["min_x"], out["max_x"] = min(xs), max(xs)
            out["min_y"], out["max_y"] = min(ys), max(ys)
        except (ValueError, IndexError):
            pass
    return out


def _metadata_template(resolution: float, min_x: float, min_y: float,
                       max_x: float, max_y: float, crs: str = "UTM") -> str:
    return f"""<?xml version="1.0" encoding="UTF-8"?>
<gmi:MI_Metadata xmlns:gmi="http://www.isotc211.org/2005/gmi"
 xmlns:gmd="http://www.isotc211.org/2005/gmd"
 xmlns:gco="http://www.isotc211.org/2005/gco"
 xmlns:gml="http://www.opengis.net/gml/3.2">
 <gmd:spatialResolution><gmd:MD_Resolution><gmd:resolution>
  <gco:Measure uom="m">{resolution}</gco:Measure>
 </gmd:resolution></gmd:MD_Resolution></gmd:spatialResolution>
 <gmd:referenceSystemInfo><gco:CharacterString>{crs}</gco:CharacterString>
 </gmd:referenceSystemInfo>
 <gml:boundedBy><gml:Envelope>
  <gml:coordinates>{min_x},{min_y} {max_x},{max_y}</gml:coordinates>
 </gml:Envelope></gml:boundedBy>
</gmi:MI_Metadata>"""


class _BagGeoMixin:
    """Shared georeferencing derived from metadata XML (GDAL-free)."""

    def _read_metadata(self, root) -> Dict[str, float]:
        if "metadata" not in root:
            return {}
        raw = root["metadata"][()]
        if isinstance(raw, np.ndarray):
            raw = raw.tobytes()
        if isinstance(raw, bytes):
            raw = raw.decode("utf-8", "replace")
        self.metadata_xml = raw
        return _parse_metadata_xml(raw)

    def _geo_from_meta(self, meta: Dict[str, float], shape, cell: float):
        if {"min_x", "max_y"} <= meta.keys():
            ox, oy = meta["min_x"], meta["max_y"]
        else:
            ox, oy = 0.0, shape[0] * cell
        # north-up geotransform (origin = top-left)
        self.geotransform = (ox, cell, 0.0, oy, 0.0, -cell)
        self.crs = "unknown"

    @property
    def bounds(self) -> Tuple[float, float, float, float]:
        gt = self.geotransform
        h, w = self.base_shape
        return (gt[0], gt[3] + h * gt[5], gt[0] + w * gt[1], gt[3])


class VRBagHandler(_BagGeoMixin):
    """Variable-resolution BAG reader
    (reference: data/vr_bag.py:100-312)."""

    NODATA = BAG_NODATA
    INVALID_INDEX = BAG_INVALID_INDEX

    def __init__(self, path):
        self.path = Path(path)
        with _h5py().File(str(self.path), "r") as f:
            if "BAG_root" not in f:
                raise ValueError(f"{path}: not a BAG")
            root = f["BAG_root"]
            if "varres_refinements" not in root or "varres_metadata" not in root:
                raise ValueError(f"{path}: not a VR BAG")
            self.base_shape = root["elevation"].shape
            self.varres_metadata = root["varres_metadata"][:]
            meta = self._read_metadata(root)
        if {"min_x", "max_x"} <= meta.keys() and self.base_shape[1] > 0:
            cell = (meta["max_x"] - meta["min_x"]) / self.base_shape[1]
        else:
            cell = self.base_cell_size_estimate
        self._geo_from_meta(meta, self.base_shape, cell)

    @property
    def base_cell_size_estimate(self) -> float:
        res_x = self.varres_metadata["resolution_x"]
        dims_x = self.varres_metadata["dimensions_x"]
        v = dims_x > 0
        if np.any(v):
            return float(np.max(res_x[v] * dims_x[v]))
        return 50.0

    @property
    def base_cell_size(self) -> Tuple[float, float]:
        return (abs(self.geotransform[1]), abs(self.geotransform[5]))

    @property
    def finest_resolution(self) -> float:
        res_x = self.varres_metadata["resolution_x"]
        v = res_x > 0
        return float(np.min(res_x[v])) if np.any(v) else 1.0

    @property
    def resampled_shape(self) -> Tuple[int, int]:
        b = self.bounds
        res = self.finest_resolution
        return (int(np.ceil((b[3] - b[1]) / res)),
                int(np.ceil((b[2] - b[0]) / res)))

    @property
    def num_refinement_cells(self) -> int:
        return int(np.sum(self.varres_metadata["dimensions_x"] > 0))

    @property
    def total_refinement_nodes(self) -> int:
        dx = self.varres_metadata["dimensions_x"].astype(np.int64)
        dy = self.varres_metadata["dimensions_y"].astype(np.int64)
        return int(np.sum(dx * dy))

    def get_refinement_info(self) -> Dict:
        dx = self.varres_metadata["dimensions_x"]
        dy = self.varres_metadata["dimensions_y"]
        rx = self.varres_metadata["resolution_x"]
        has = dx > 0
        return {
            "base_shape": self.base_shape,
            "num_refined_cells": int(has.sum()),
            "total_refinement_nodes": self.total_refinement_nodes,
            "unique_dimensions": sorted(set(zip(dx[has].ravel().tolist(),
                                                dy[has].ravel().tolist()))),
            "unique_resolutions": sorted(set(rx[has].ravel().tolist())),
        }

    def iterate_refinements(
        self, min_valid_ratio: float = 0.0
    ) -> Generator[RefinementGrid, None, None]:
        """Yield each refinement as a 2-D grid
        (reference: data/vr_bag.py:243-298)."""
        with _h5py().File(str(self.path), "r") as f:
            ref = f["BAG_root"]["varres_refinements"]
            ref_data = ref[0, :]
        rows, cols = np.nonzero(self.varres_metadata["dimensions_x"] > 0)
        for r, c in zip(rows, cols):
            m = self.varres_metadata[r, c]
            dx, dy = int(m["dimensions_x"]), int(m["dimensions_y"])
            start = int(m["index"])
            sl = ref_data[start:start + dx * dy]
            depth = sl["depth"].reshape(dy, dx)
            unc = sl["depth_uncrt"].reshape(dy, dx)
            grid = RefinementGrid(
                base_row=int(r), base_col=int(c),
                depth=depth.copy(), uncertainty=unc.copy(),
                resolution=(float(m["resolution_x"]), float(m["resolution_y"])),
                dimensions=(dy, dx),
                sw_corner=(float(m["sw_corner_x"]), float(m["sw_corner_y"])),
                start_index=start,
            )
            if grid.num_valid / grid.depth.size >= min_valid_ratio:
                yield grid

    def copy_and_open_for_writing(self, output_path) -> "VRBagWriter":
        shutil.copy(str(self.path), str(output_path))
        return VRBagWriter(output_path)


class SRBagHandler(_BagGeoMixin):
    """Single-resolution BAG with the VR-compatible interface
    (reference: data/vr_bag.py:315-428)."""

    def __init__(self, path):
        self.path = Path(path)
        with _h5py().File(str(self.path), "r") as f:
            root = f["BAG_root"]
            self._depth = root["elevation"][:].astype(np.float32)
            self._uncertainty = (root["uncertainty"][:].astype(np.float32)
                                 if "uncertainty" in root
                                 else np.zeros_like(self._depth))
            self.base_shape = self._depth.shape
            meta = self._read_metadata(root)
        self._resolution = float(meta.get("resolution", 1.0))
        self._geo_from_meta(meta, self.base_shape, self._resolution)

    @property
    def resolution(self) -> float:
        return self._resolution

    @property
    def finest_resolution(self) -> float:
        return self._resolution

    @property
    def resampled_shape(self) -> Tuple[int, int]:
        return self.base_shape

    def get_refinement_info(self) -> Dict:
        valid = (self._depth != BAG_NODATA) & np.isfinite(self._depth)
        return {
            "base_shape": self.base_shape,
            "num_refined_cells": 1,
            "total_refinement_nodes": int(valid.sum()),
            "unique_resolutions": [self._resolution],
        }

    def iterate_refinements(self, min_valid_ratio: float = 0.0):
        valid = (self._depth != BAG_NODATA) & np.isfinite(self._depth)
        if valid.mean() >= min_valid_ratio:
            yield RefinementGrid(
                base_row=0, base_col=0,
                depth=self._depth.copy(), uncertainty=self._uncertainty.copy(),
                resolution=(self._resolution, self._resolution),
                dimensions=self.base_shape, sw_corner=(0.0, 0.0),
                start_index=0,
            )

    def copy_and_open_for_writing(self, output_path) -> "SRBagWriter":
        shutil.copy(str(self.path), str(output_path))
        return SRBagWriter(output_path)


class SRBagWriter:
    """In-place SR BAG modifier (reference: data/vr_bag.py:431-476)."""

    def __init__(self, path):
        self.path = Path(path)
        self.file = _h5py().File(str(self.path), "r+")
        self.root = self.file["BAG_root"]
        self.cells_corrected = 0

    def update_refinement_batch(self, grid: RefinementGrid,
                                corrected_depth: np.ndarray,
                                corrected_uncertainty: np.ndarray):
        self.root["elevation"][:] = corrected_depth
        if "uncertainty" in self.root:
            self.root["uncertainty"][:] = corrected_uncertainty
        self.cells_corrected += int(
            np.sum(corrected_depth != grid.depth)
        )

    def close(self):
        if self.file is not None:
            self.file.close()
            self.file = None
            logger.info("SR BAG closed: %d cells corrected: %s",
                        self.cells_corrected, self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class VRBagWriter:
    """In-place VR BAG refinement modifier
    (reference: data/vr_bag.py:478-606; batch slice read-modify-write)."""

    NODATA = BAG_NODATA

    def __init__(self, path):
        self.path = Path(path)
        self.file = _h5py().File(str(self.path), "r+")
        self.root = self.file["BAG_root"]
        self.refinements = self.root["varres_refinements"]
        self.grids_updated = 0
        self.cells_corrected = 0

    def update_refinement_batch(self, grid: RefinementGrid,
                                corrected_depth: np.ndarray,
                                corrected_uncertainty: np.ndarray):
        dy, dx = grid.dimensions
        n = dy * dx
        sl = self.refinements[0, grid.start_index:grid.start_index + n]
        before = sl["depth"].copy()
        sl["depth"] = corrected_depth.reshape(-1).astype(np.float32)
        sl["depth_uncrt"] = corrected_uncertainty.reshape(-1).astype(np.float32)
        self.refinements[0, grid.start_index:grid.start_index + n] = sl
        self.grids_updated += 1
        self.cells_corrected += int(np.sum(sl["depth"] != before))

    def close(self):
        if self.file is not None:
            self.file.close()
            self.file = None
            logger.info("VR BAG closed: %d grids, %d cells corrected: %s",
                        self.grids_updated, self.cells_corrected, self.path)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class SidecarBuilder:
    """Accumulates GNN outputs at the finest resolution during native VR
    inference (reference: data/vr_bag.py:609-834), with vectorized
    placement instead of the reference's 4-deep Python loop (SURVEY Q5)."""

    CHANNELS = ("classification", "confidence", "correction", "valid_mask")

    def __init__(self, handler):
        self.handler = handler
        self.resolution = handler.finest_resolution
        self.shape = handler.resampled_shape
        b = handler.bounds
        self.origin = (b[0], b[3])  # top-left (min_x, max_y)
        self.grids = {
            "classification": np.full(self.shape, -1.0, np.float32),
            "confidence": np.zeros(self.shape, np.float32),
            "correction": np.zeros(self.shape, np.float32),
            "valid_mask": np.zeros(self.shape, np.float32),
        }

    def add_refinement_results(
        self,
        grid: RefinementGrid,
        classification: np.ndarray,
        confidence: np.ndarray,
        correction: np.ndarray,
    ):
        """Place one refinement's outputs into the finest-resolution canvas.

        Geo placement: refinement cell (i, j) covers a square of
        scale = grid.resolution / finest starting at the refinement's
        sw_corner (BAG row 0 = south, canvas row 0 = north -> y flip).
        """
        base_cs = self.handler.base_cell_size
        b = self.handler.bounds
        # refinement sw corner is relative to its base cell's sw corner
        cell_x = b[0] + grid.base_col * base_cs[0] + grid.sw_corner[0]
        cell_y = b[1] + grid.base_row * base_cs[1] + grid.sw_corner[1]
        dy, dx = grid.dimensions
        scale_x = max(1, int(round(grid.resolution[0] / self.resolution)))
        scale_y = max(1, int(round(grid.resolution[1] / self.resolution)))

        # upscale with kron (nearest-neighbor fill of each refinement cell)
        def up(a):
            return np.kron(a, np.ones((scale_y, scale_x), np.float32))

        valid = grid.valid_mask.astype(np.float32)
        cls_u = up(np.where(grid.valid_mask, classification, -1.0).astype(np.float32))
        conf_u = up(np.where(grid.valid_mask, confidence, 0.0).astype(np.float32))
        corr_u = up(np.where(grid.valid_mask, correction, 0.0).astype(np.float32))
        val_u = up(valid)

        hh, ww = cls_u.shape
        # canvas indices: x from left, y flipped (row 0 = north)
        px = int(round((cell_x - self.origin[0]) / self.resolution))
        py_bottom = int(round((self.origin[1] - cell_y) / self.resolution))
        py = py_bottom - hh
        # refinement grids are south-up: flip rows into the north-up canvas
        cls_u, conf_u, corr_u, val_u = (np.flipud(a) for a in
                                        (cls_u, conf_u, corr_u, val_u))

        y0, y1 = max(py, 0), min(py + hh, self.shape[0])
        x0, x1 = max(px, 0), min(px + ww, self.shape[1])
        if y1 <= y0 or x1 <= x0:
            return
        sy, sx = y0 - py, x0 - px
        region = np.s_[y0:y1, x0:x1]
        src = np.s_[sy:sy + (y1 - y0), sx:sx + (x1 - x0)]
        place = val_u[src] > 0
        for name, arr in (("classification", cls_u), ("confidence", conf_u),
                          ("correction", corr_u), ("valid_mask", val_u)):
            tgt = self.grids[name][region]
            tgt[place] = arr[src][place]

    def save(self, path, crs_wkt: Optional[str] = None):
        """4-band GeoTIFF sidecar (reference: data/vr_bag.py:780-834)."""
        from .geotiff import write_geotiff

        bands = np.stack([self.grids[c] for c in self.CHANNELS])
        write_geotiff(
            path, bands,
            pixel_scale=(self.resolution, self.resolution),
            origin=self.origin,
            nodata=-1.0,
            crs_wkt=crs_wkt or getattr(self.handler, "crs", None),
            band_descriptions=list(self.CHANNELS),
        )
        logger.info("sidecar saved: %s (%s @ %.2fm)", path, self.shape,
                    self.resolution)


def process_bag_native(
    input_path,
    output_path,
    process_func: Callable[[np.ndarray, np.ndarray, Tuple[float, float]],
                           Dict[str, np.ndarray]],
    min_valid_ratio: float = 0.05,
    confidence_threshold: float = 0.85,
    uncertainty_scale: bool = True,
    sidecar_path=None,
) -> Dict[str, int]:
    """Functional native BAG processing driver
    (reference: data/vr_bag.py:837-924) using the SUBTRACT correction
    convention everywhere (conscious fix of SURVEY Q1: clean = noisy -
    correction, matching the training target correction = noisy - clean).
    """
    from ..config.constants import CLASS_NOISE

    kind = detect_bag_type(input_path)
    handler = VRBagHandler(input_path) if kind == "VR" else SRBagHandler(input_path)
    writer = handler.copy_and_open_for_writing(output_path)
    sidecar = SidecarBuilder(handler) if sidecar_path else None

    stats = {"grids": 0, "cells_corrected": 0, "total_nodes": 0}
    try:
        for grid in handler.iterate_refinements(min_valid_ratio):
            out = process_func(grid.depth, grid.uncertainty, grid.resolution)
            valid = grid.valid_mask
            apply_mask = (
                valid
                & (out["classification"] == CLASS_NOISE)
                & (out["confidence"] >= confidence_threshold)
            )
            corrected = grid.depth.copy()
            corrected[apply_mask] -= out["correction"][apply_mask]
            unc = grid.uncertainty.copy()
            if uncertainty_scale:
                unc[apply_mask] *= (2.0 - out["confidence"][apply_mask])
            writer.update_refinement_batch(grid, corrected, unc)
            if sidecar is not None:
                sidecar.add_refinement_results(
                    grid, out["classification"].astype(np.float32),
                    out["confidence"], out["correction"],
                )
            stats["grids"] += 1
            stats["cells_corrected"] += int(apply_mask.sum())
            stats["total_nodes"] += int(valid.sum())
    finally:
        writer.close()
    if sidecar is not None:
        sidecar.save(sidecar_path)
    return stats


# -- BAG creation (capability the reference lacks) -------------------------

def write_sr_bag(path, depth: np.ndarray, uncertainty: Optional[np.ndarray],
                 resolution: float, origin: Tuple[float, float] = (0.0, 0.0),
                 crs: str = "UTM"):
    """Create a single-resolution BAG. depth uses BAG_NODATA for gaps;
    row 0 = south (BAG convention). origin = (min_x, min_y)."""
    h, w = depth.shape
    if uncertainty is None:
        uncertainty = np.zeros_like(depth)
    with _h5py().File(str(path), "w") as f:
        root = f.create_group("BAG_root")
        root.create_dataset("elevation", data=depth.astype(np.float32))
        root.create_dataset("uncertainty", data=uncertainty.astype(np.float32))
        xml = _metadata_template(resolution, origin[0], origin[1],
                                 origin[0] + w * resolution,
                                 origin[1] + h * resolution, crs)
        root.create_dataset("metadata",
                            data=np.frombuffer(xml.encode(), dtype=np.uint8))


def write_vr_bag(
    path,
    base_shape: Tuple[int, int],
    base_resolution: float,
    refinements: List[Tuple[int, int, np.ndarray, Optional[np.ndarray],
                            float]],
    origin: Tuple[float, float] = (0.0, 0.0),
    crs: str = "UTM",
):
    """Create a VR BAG from (base_row, base_col, depth, uncertainty,
    resolution) refinement tuples. Refinement grids are south-up."""
    h, w = base_shape
    base_elev = np.full(base_shape, BAG_NODATA, np.float32)
    meta = np.zeros(base_shape, VARRES_META_DTYPE)
    meta["index"] = BAG_INVALID_INDEX

    records = []
    idx = 0
    for (r, c, depth, unc, res) in refinements:
        dy, dx = depth.shape
        if unc is None:
            unc = np.zeros_like(depth)
        rec = np.zeros(dy * dx, VARRES_REF_DTYPE)
        rec["depth"] = depth.astype(np.float32).reshape(-1)
        rec["depth_uncrt"] = unc.astype(np.float32).reshape(-1)
        records.append(rec)
        meta[r, c] = (idx, dx, dy, res, res, 0.0, 0.0)
        v = depth[depth != BAG_NODATA]
        base_elev[r, c] = v.mean() if v.size else BAG_NODATA
        idx += dy * dx

    allrec = (np.concatenate(records) if records
              else np.zeros(0, VARRES_REF_DTYPE))
    with _h5py().File(str(path), "w") as f:
        root = f.create_group("BAG_root")
        root.create_dataset("elevation", data=base_elev)
        root.create_dataset("uncertainty", data=np.zeros_like(base_elev))
        root.create_dataset("varres_metadata", data=meta)
        root.create_dataset("varres_refinements",
                            data=allrec.reshape(1, -1))
        xml = _metadata_template(base_resolution, origin[0], origin[1],
                                 origin[0] + w * base_resolution,
                                 origin[1] + h * base_resolution, crs)
        root.create_dataset("metadata",
                            data=np.frombuffer(xml.encode(), dtype=np.uint8))
