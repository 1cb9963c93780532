"""Overlapping-tile decomposition and seam-free stitching.

Copy of ``bathymetric_gnn_tpu/data/tiling.py`` (pure numpy) for the PyTorch port.

Re-design of the reference's TileManager/TileMerger
(reference: data/tiling.py:22-454). Host-side numpy: tiling is I/O-adjacent
bookkeeping; the per-tile compute runs on device. Semantics preserved:

- stride = tile_size - overlap; edge tiles pulled back to full size
- tiles below min_valid_ratio skipped
- continuous channels: Hann-ramp weighted blending
- 'classification': per-cell keep-from-highest-confidence (discrete labels
  must never be fractionally blended — SURVEY §2.5 Q7)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class TileSpec:
    """Tile placement without data (reference: data/tiling.py:44-52)."""

    row_start: int
    col_start: int
    row_end: int
    col_end: int
    tile_row: int
    tile_col: int

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.row_end - self.row_start, self.col_end - self.col_start)


@dataclass
class Tile:
    """Extracted tile data (reference: data/tiling.py:22-41)."""

    data: np.ndarray
    uncertainty: Optional[np.ndarray]
    spec: TileSpec
    valid_mask: np.ndarray

    @property
    def shape(self) -> Tuple[int, int]:
        return self.data.shape

    @property
    def valid_ratio(self) -> float:
        return float(self.valid_mask.sum()) / self.valid_mask.size


class TileManager:
    """Splits grids into overlapping tiles and stitches them back
    (reference: data/tiling.py:55-330)."""

    def __init__(
        self,
        tile_size: int = 1024,
        overlap: int = 128,
        min_valid_ratio: float = 0.1,
    ):
        if tile_size < 2 * overlap:
            raise ValueError("tile_size must be >= 2x overlap")
        self.tile_size = tile_size
        self.overlap = overlap
        self.min_valid_ratio = min_valid_ratio
        self.stride = tile_size - overlap

    def compute_tile_grid(
        self, grid_shape: Tuple[int, int]
    ) -> Tuple[int, int, List[TileSpec]]:
        """Reference: data/tiling.py:87-138 (edge tiles pulled back)."""
        height, width = grid_shape
        nrows = max(1, (height - self.overlap + self.stride - 1) // self.stride)
        ncols = max(1, (width - self.overlap + self.stride - 1) // self.stride)
        specs = []
        for tr in range(nrows):
            for tc in range(ncols):
                r0 = tr * self.stride
                c0 = tc * self.stride
                r1 = min(r0 + self.tile_size, height)
                c1 = min(c0 + self.tile_size, width)
                if r1 - r0 < self.tile_size and r0 > 0:
                    r0 = max(0, r1 - self.tile_size)
                if c1 - c0 < self.tile_size and c0 > 0:
                    c0 = max(0, c1 - self.tile_size)
                specs.append(TileSpec(r0, c0, r1, c1, tr, tc))
        return nrows, ncols, specs

    def extract_tile(
        self,
        depth: np.ndarray,
        spec: TileSpec,
        uncertainty: Optional[np.ndarray] = None,
        valid_mask: Optional[np.ndarray] = None,
    ) -> Tile:
        sl = np.s_[spec.row_start:spec.row_end, spec.col_start:spec.col_end]
        data = depth[sl]
        if valid_mask is not None:
            vm = valid_mask[sl]
        else:
            vm = np.isfinite(data)
        unc = uncertainty[sl] if uncertainty is not None else None
        return Tile(data=data, uncertainty=unc, spec=spec, valid_mask=vm)

    def iterate_tiles(
        self,
        depth: np.ndarray,
        uncertainty: Optional[np.ndarray] = None,
        valid_mask: Optional[np.ndarray] = None,
    ) -> Iterator[Tile]:
        """Yields tiles above min_valid_ratio (reference: :180-207)."""
        _, _, specs = self.compute_tile_grid(depth.shape)
        for spec in specs:
            t = self.extract_tile(depth, spec, uncertainty, valid_mask)
            if t.valid_ratio >= self.min_valid_ratio:
                yield t

    # -- blending ----------------------------------------------------------

    def blend_weights(self, shape: Tuple[int, int]) -> np.ndarray:
        """Hann-ramp 2-D blend window (reference: :296-330)."""
        return np.outer(
            self._blend_1d(shape[0]), self._blend_1d(shape[1])
        ).astype(np.float32)

    def _blend_1d(self, size: int) -> np.ndarray:
        w = np.ones(size, np.float32)
        ramp = min(self.overlap, size // 4)
        if ramp > 0:
            up = 0.5 * (1 - np.cos(np.pi * np.linspace(0, 1, ramp)))
            w[:ramp] = up
            w[-ramp:] = up[::-1]
        # Conscious fix vs the reference (data/tiling.py:313-330): its ramps
        # hit exactly 0 at tile borders, leaving a zero-weight ring around
        # the whole survey. Floor at eps so a cell covered by only one tile
        # still reconstructs exactly after weight division.
        return np.maximum(w, 1e-3)


class TileMerger:
    """Multi-channel stitcher with confidence-resolved discrete channels
    (reference: data/tiling.py:333-454)."""

    DISCRETE_CHANNELS = {"classification"}

    def __init__(self, tile_manager: TileManager):
        self.tm = tile_manager
        self.outputs: Dict[str, np.ndarray] = {}
        self.weights: Dict[str, np.ndarray] = {}
        self.best_conf: Optional[np.ndarray] = None
        self.shape: Optional[Tuple[int, int]] = None

    def initialize(self, grid_shape: Tuple[int, int], channels: Sequence[str]):
        self.shape = grid_shape
        for ch in channels:
            self.outputs[ch] = np.full(grid_shape, np.nan, np.float32)
            if ch not in self.DISCRETE_CHANNELS:
                self.weights[ch] = np.zeros(grid_shape, np.float32)
        self.best_conf = np.full(grid_shape, -np.inf, np.float32)

    def add_tile(
        self,
        spec: TileSpec,
        results: Dict[str, np.ndarray],
        tile_valid: Optional[np.ndarray] = None,
    ):
        """Weighted-accumulate continuous channels; keep-best-confidence for
        discrete ones (reference: :384-428)."""
        sl = np.s_[spec.row_start:spec.row_end, spec.col_start:spec.col_end]
        bw = self.tm.blend_weights(spec.shape)
        if tile_valid is None:
            probe = next(iter(results.values()))
            tile_valid = np.isfinite(probe)
        w = np.where(tile_valid, bw, 0.0)

        conf = results.get("confidence")
        for ch, data in results.items():
            if ch in self.DISCRETE_CHANNELS:
                continue
            out = self.outputs[ch]
            acc = self.weights[ch]
            region = out[sl]
            # NaN-initialized cells become 0 before accumulation (:251-252)
            first = np.isnan(region) & (w > 0)
            region[first] = 0.0
            region += np.where(tile_valid, np.nan_to_num(data), 0.0) * w
            acc[sl] += w
        if "classification" in results:
            cls_out = self.outputs["classification"]
            c = conf if conf is not None else bw
            better = tile_valid & (np.nan_to_num(c, nan=-np.inf) > self.best_conf[sl])
            region = cls_out[sl]
            region[better] = results["classification"][better]
            bc = self.best_conf[sl]
            bc[better] = np.nan_to_num(c, nan=-np.inf)[better]

    def finalize(self) -> Dict[str, np.ndarray]:
        """Divide by accumulated weights (reference: :430-454)."""
        final = {}
        for ch, out in self.outputs.items():
            if ch in self.DISCRETE_CHANNELS:
                final[ch] = out
            else:
                acc = self.weights[ch]
                with np.errstate(invalid="ignore"):
                    final[ch] = np.where(acc > 0, out / np.maximum(acc, 1e-12),
                                         np.nan)
        return final
