"""Streaming tiled inference: surveys far larger than host RAM (port of
``bathymetric_gnn_tpu/inference/streaming.py``).

A full-grid pipeline holds about ten arrays of the survey's size; a
60,000 x 60,000 survey is 14.4 GB per f32 array. This pipeline holds only
a rolling row band:

  windowed read (GeoTIFF strips, SR BAG rows, VR BAG refinements
  rasterized band by band) -> a tile row's batch forward on the device
  (``BathymetricPipeline.forward_tiles``: kernel A on the card) -> Hann
  merge into a band of ``2 x tile_size`` rows -> finalized rows streamed
  to an uncompressed, seekable GeoTIFF.

Host memory: O(tile_size x width), whatever the survey's height.

Finalized rows are finished as ``BathymetricPipeline.process`` finishes
its grid (``_finish_channels``: back-fill, then the confidence
calibration; then the correction of confident noise), so the two agree.
The JAX streaming pipeline skips the calibration.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

import numpy as np

from ..config.constants import BAG_NODATA, CLASS_NOISE
from ..data.tiling import TileManager
from ..io.bag import (RefinementGrid, SRBagHandler, VRBagHandler,
                      detect_bag_type)
from ..io.geotiff import (GeoTiffInfo, GeoTiffWindowReader,
                          StreamingGeoTiffWriter)
from ..io.loaders import _place_refinement
from .pipeline import BathymetricPipeline, _unpack_channels

logger = logging.getLogger(__name__)

OUT_BANDS = ("cleaned_depth", "classification", "confidence", "correction",
             "valid_mask")


class RowBandMerger:
    """``TileMerger`` semantics over a rolling row band: Hann-weighted sums
    of confidence and correction, the class of the most confident tile."""

    def __init__(self, tm: TileManager, width: int, band_rows: int):
        self.tm = tm
        self.width = width
        self.band_rows = band_rows
        self.base_row = 0  # global row of buffer row 0
        ch = ("classification", "confidence", "correction")
        self.sum = {c: np.zeros((band_rows, width), np.float32)
                    for c in ch if c != "classification"}
        self.weight = {c: np.zeros((band_rows, width), np.float32)
                       for c in ch if c != "classification"}
        self.cls = np.full((band_rows, width), np.nan, np.float32)
        self.best_conf = np.full((band_rows, width), -np.inf, np.float32)

    def advance(self, new_base: int):
        """Slide the buffer down so row new_base is at index 0."""
        shift = new_base - self.base_row
        if shift <= 0:
            return
        for d in (self.sum, self.weight):
            for c in d:
                d[c] = np.roll(d[c], -shift, 0)
                d[c][-shift:] = 0.0
        self.cls = np.roll(self.cls, -shift, 0)
        self.cls[-shift:] = np.nan
        self.best_conf = np.roll(self.best_conf, -shift, 0)
        self.best_conf[-shift:] = -np.inf
        self.base_row = new_base

    def add_tile(self, spec, results: Dict[str, np.ndarray],
                 tile_valid: np.ndarray):
        r0 = spec.row_start - self.base_row
        r1 = spec.row_end - self.base_row
        assert 0 <= r0 and r1 <= self.band_rows, (r0, r1, self.band_rows)
        sl = np.s_[r0:r1, spec.col_start:spec.col_end]
        bw = self.tm.blend_weights(spec.shape)
        w = np.where(tile_valid, bw, 0.0)
        for c in ("confidence", "correction"):
            self.sum[c][sl] += np.where(tile_valid,
                                        np.nan_to_num(results[c]), 0.0) * w
            self.weight[c][sl] += w
        conf = np.nan_to_num(results["confidence"], nan=-np.inf)
        better = tile_valid & (conf > self.best_conf[sl])
        region = self.cls[sl]
        region[better] = results["classification"][better]
        bc = self.best_conf[sl]
        bc[better] = conf[better]

    def finalize_rows(self, r0: int, r1: int) -> Dict[str, np.ndarray]:
        """Finalized channel rows [r0, r1) (global indices)."""
        a, b = r0 - self.base_row, r1 - self.base_row
        out = {}
        for c in ("confidence", "correction"):
            wsum = self.weight[c][a:b]
            out[c] = np.where(wsum > 0,
                              self.sum[c][a:b] / np.maximum(wsum, 1e-12),
                              np.nan)
        out["classification"] = self.cls[a:b].copy()
        return out


class VRBagWindowReader:
    """Windowed VR BAG reader: north-up rows of the finest-resolution
    refinement mosaic, without building the whole canvas.

    At open time only the refinements' metadata is indexed (the canvas
    rows each covers); ``read_rows`` rasterizes the refinements that meet
    the requested rows, with nearest-center sampling
    (``io/loaders._place_refinement`` with ``row_offset``), to the same
    values as the resampled loader's canvas. Bands advance monotonically
    and a refinement spans far fewer rows than a band, so each
    refinement's records are read from HDF5 O(1) times: the uncertainty of
    the last window and the records that straddle its bottom edge are
    kept. Memory: O(band_rows x width).
    """

    def __init__(self, path):
        import h5py

        h = VRBagHandler(path)
        self._handler = h
        self._f = h5py.File(str(path), "r")
        self._ref = self._f["BAG_root"]["varres_refinements"]
        self.height, self.width = h.resampled_shape
        self.res = h.finest_resolution
        self.bounds = h.bounds
        self.base_cs = h.base_cell_size
        self.bands = 2
        self.nodata = BAG_NODATA
        gt = (self.bounds[0], self.res, 0.0, self.bounds[3], 0.0, -self.res)
        self.info = GeoTiffInfo(
            width=self.width, height=self.height, bands=2,
            dtype=np.dtype(np.float32),
            pixel_scale=(self.res, self.res, 0.0),
            tiepoint=(0.0, 0.0, 0.0, gt[0], gt[3], 0.0),
            nodata=BAG_NODATA, crs_wkt=h.crs,
        )

        md = h.varres_metadata
        rows, cols = np.nonzero(md["dimensions_x"] > 0)
        m = md[rows, cols]
        self._base_row = rows.astype(np.int64)
        self._base_col = cols.astype(np.int64)
        self._dx = m["dimensions_x"].astype(np.int64)
        self._dy = m["dimensions_y"].astype(np.int64)
        self._resx = m["resolution_x"].astype(np.float64)
        self._resy = m["resolution_y"].astype(np.float64)
        self._swx = m["sw_corner_x"].astype(np.float64)
        self._swy = m["sw_corner_y"].astype(np.float64)
        self._index = m["index"].astype(np.int64)
        b = self.bounds
        self._cell_x = b[0] + self._base_col * self.base_cs[0] + self._swx
        self._cell_y = b[1] + self._base_row * self.base_cs[1] + self._swy
        y_max = self._cell_y + self._dy * self._resy
        self._py0 = np.floor((b[3] - y_max) / self.res + 1e-9).astype(int)
        self._py1 = np.ceil((b[3] - self._cell_y) / self.res - 1e-9
                            ).astype(int)
        self._unc_cache = None  # (r0, r1, rows): band 1 follows band 0
        # raw records of the refinements that straddle the last window's
        # bottom edge: the next window rasterizes them again from RAM
        self._rec_cache: dict = {}

    def read_rows(self, band: int, r0: int, r1: int) -> np.ndarray:
        r0 = max(r0, 0)
        r1 = min(r1, self.height)
        if r1 <= r0:
            return np.zeros((0, self.width), np.float32)
        if band == 1:
            c = self._unc_cache
            if c is not None and c[0] == r0 and c[1] == r1:
                return c[2]
        shape = (r1 - r0, self.width)
        depth = np.full(shape, self.nodata, np.float32)
        unc = np.zeros(shape, np.float32)
        sel = np.nonzero((self._py0 < r1) & (self._py1 > r0))[0]
        for i in sel:
            n = int(self._dx[i] * self._dy[i])
            rec = self._rec_cache.get(int(i))
            if rec is None:
                rec = self._ref[0, self._index[i]:self._index[i] + n]
            grid = RefinementGrid(
                base_row=int(self._base_row[i]),
                base_col=int(self._base_col[i]),
                depth=rec["depth"].reshape(self._dy[i], self._dx[i])
                .astype(np.float32),
                uncertainty=rec["depth_uncrt"].reshape(
                    self._dy[i], self._dx[i]).astype(np.float32),
                resolution=(float(self._resx[i]), float(self._resy[i])),
                dimensions=(int(self._dy[i]), int(self._dx[i])),
                sw_corner=(float(self._swx[i]), float(self._swy[i])),
                start_index=int(self._index[i]),
            )
            _place_refinement(depth, unc, grid, float(self._cell_x[i]),
                              float(self._cell_y[i]), self.bounds,
                              self.res, shape, row_offset=r0)
            if self._py1[i] > r1:          # straddles the bottom edge
                self._rec_cache[int(i)] = rec
        # drop records wholly above the window (windows advance
        # monotonically)
        self._rec_cache = {i: r for i, r in self._rec_cache.items()
                           if self._py1[i] > r0}
        self._unc_cache = (r0, r1, unc)
        return depth if band == 0 else unc

    def close(self):
        self._f.close()


class BagWindowReader:
    """SR BAG windowed reader with the ``GeoTiffWindowReader`` interface.

    A BAG stores row 0 = south; rows are served north-up like the rest of
    the pipeline. Band 0 = elevation, band 1 = uncertainty.
    """

    def __init__(self, path):
        import h5py

        if detect_bag_type(path) != "SR":
            raise NotImplementedError("BagWindowReader is the SR path; "
                                      "VR BAGs use VRBagWindowReader")
        handler = SRBagHandler(path)  # parses the georeferencing
        self._f = h5py.File(str(path), "r")
        root = self._f["BAG_root"]
        self._elev = root["elevation"]
        self._unc = root.get("uncertainty")
        self.height, self.width = self._elev.shape
        self.bands = 2 if self._unc is not None else 1
        gt = handler.geotransform
        self.info = GeoTiffInfo(
            width=self.width, height=self.height, bands=self.bands,
            dtype=np.dtype(np.float32),
            pixel_scale=(abs(gt[1]), abs(gt[5]), 0.0),
            tiepoint=(0.0, 0.0, 0.0, gt[0], gt[3], 0.0),
            nodata=BAG_NODATA, crs_wkt=handler.crs,
        )

    def read_rows(self, band: int, r0: int, r1: int) -> np.ndarray:
        r0 = max(r0, 0)
        r1 = min(r1, self.height)
        if r1 <= r0:
            return np.zeros((0, self.width), np.float32)
        ds = self._elev if band == 0 else self._unc
        # north-up row r = file row (H-1-r); one contiguous block, flipped
        block = ds[self.height - r1:self.height - r0]
        return np.ascontiguousarray(block[::-1]).astype(np.float32)

    def close(self):
        self._f.close()


def open_window_reader(path):
    path = str(path)
    if path.lower().endswith(".bag"):
        if detect_bag_type(path) == "VR":
            return VRBagWindowReader(path)
        return BagWindowReader(path)
    return GeoTiffWindowReader(path)


class StreamingPipeline(BathymetricPipeline):
    """``BathymetricPipeline`` in O(band) host memory over windowed
    sources (strip GeoTIFFs, SR BAGs, VR BAGs through the windowed
    refinement rasterizer)."""

    def process_streaming(self, input_path, output_path) -> Dict:
        if self.model is None:
            raise RuntimeError("load_model() first")
        t0 = time.time()
        reader = open_window_reader(input_path)
        h, w = reader.height, reader.width
        info = reader.info
        gt = info.geotransform
        resolution = ((float(abs(gt[1])), float(abs(gt[5]))) if gt
                      else (1.0, 1.0))
        nodata = info.nodata
        has_unc = reader.bands >= 2 and self.in_channels >= 8

        nrows_t, _, specs = self.tm.compute_tile_grid((h, w))
        by_row: Dict[int, list] = {}
        for s in specs:
            by_row.setdefault(s.tile_row, []).append(s)

        band_rows = 2 * self.tm.tile_size
        merger = RowBandMerger(self.tm, w, band_rows)
        writer = StreamingGeoTiffWriter(
            output_path, h, w, len(OUT_BANDS),
            band_descriptions=list(OUT_BANDS),
            pixel_scale=(abs(gt[1]), abs(gt[5])) if gt else None,
            origin=(gt[0], gt[3]) if gt else None,
            nodata=float("nan"), crs_wkt=info.crs_wkt,
            rows_per_strip=self.tm.stride,
        )
        stats = {"tiles_processed": 0, "cells_corrected": 0,
                 "valid_cells": 0, "noise_cells": 0, "conf_sum": 0.0}

        def valid_of(depth):
            valid = np.isfinite(depth) & (np.abs(depth) < 1e5)
            if nodata is not None:
                valid &= depth != nodata
            return valid

        def finalize_and_write(r0, r1):
            if r1 <= r0:
                return
            depth_rows = reader.read_rows(0, r0, r1).astype(np.float32)
            valid = valid_of(depth_rows)
            fin = self._finish_channels(merger.finalize_rows(r0, r1), valid)
            cls, conf, corr = (fin["classification"], fin["confidence"],
                               fin["correction"])
            m = self._correction_mask(fin, valid)
            cleaned = depth_rows.copy()
            cleaned[m] -= corr[m]
            rows = {
                "cleaned_depth": np.where(valid, cleaned, np.nan),
                "classification": np.where(valid, cls, np.nan),
                "confidence": np.where(valid, conf, np.nan),
                "correction": np.where(valid, corr, np.nan),
                "valid_mask": valid.astype(np.float32),
            }
            for bi, name in enumerate(OUT_BANDS):
                writer.write_rows(bi, r0, rows[name])
            stats["valid_cells"] += int(valid.sum())
            stats["noise_cells"] += int((valid & (cls == CLASS_NOISE)).sum())
            stats["cells_corrected"] += int(m.sum())
            stats["conf_sum"] += float(conf[valid].sum())

        def run(tiles):
            """Forward [(spec, depth, valid, unc)] as one batch; merge each
            tile from one copy of the packed results."""
            res = self.forward_tiles(
                np.stack([t[1] for t in tiles]),
                np.stack([t[2] for t in tiles]),
                np.stack([t[3] for t in tiles]) if has_unc else None,
                resolution)
            arr = res.cpu().numpy()  # packed [3, B, H, W]
            for bi, (spec, _, tv, _) in enumerate(tiles):
                merger.add_tile(spec, _unpack_channels(arr[:, bi]),
                                tile_valid=tv)
            stats["tiles_processed"] += len(tiles)

        full = (self.tm.tile_size, self.tm.tile_size)
        flushed = 0
        for tr in sorted(by_row):
            row_specs = by_row[tr]
            r_lo = min(s.row_start for s in row_specs)
            r_hi = max(s.row_end for s in row_specs)
            merger.advance(min(flushed, r_lo))
            if r_hi - merger.base_row > band_rows:
                merger.advance(r_hi - band_rows)
            depth_band = reader.read_rows(0, r_lo, r_hi)
            unc_band = reader.read_rows(1, r_lo, r_hi) if has_unc else None
            valid_band = valid_of(depth_band)

            # full tiles in batches of up to tile_batch; a ragged tile
            # alone, where it falls
            batch = []
            for spec in row_specs:
                sl = np.s_[spec.row_start - r_lo:spec.row_end - r_lo,
                           spec.col_start:spec.col_end]
                tv = valid_band[sl]
                if tv.mean() < self.tm.min_valid_ratio:
                    continue
                tile = (spec, np.nan_to_num(depth_band[sl]).astype(np.float32),
                        tv, np.nan_to_num(unc_band[sl]).astype(np.float32)
                        if has_unc else None)
                if spec.shape != full:
                    run([tile])
                    continue
                batch.append(tile)
                if len(batch) == self.tile_batch:
                    run(batch)
                    batch = []
            if batch:
                run(batch)

            # rows are final once the next tile row cannot touch them: up
            # to its first row, which for the last row, pulled back to end
            # at the survey's edge, lies above (tr + 1) * stride
            final_upto = (min(s.row_start for s in by_row[tr + 1])
                          if tr + 1 in by_row else h)
            finalize_and_write(flushed, final_upto)
            flushed = final_upto
            if tr % 10 == 0:
                logger.info("tile-row %d/%d, %d tiles, %d rows written",
                            tr, nrows_t, stats["tiles_processed"], flushed)
        finalize_and_write(flushed, h)
        writer.close()
        reader.close()

        nv = max(stats["valid_cells"], 1)
        return {
            "tiles_processed": stats["tiles_processed"],
            "valid_cells": stats["valid_cells"],
            "noise_pct": round(100.0 * stats["noise_cells"] / nv, 2),
            "mean_confidence": round(stats["conf_sum"] / nv, 4),
            "cells_corrected": stats["cells_corrected"],
            "elapsed_s": round(time.time() - t0, 2),
        }
