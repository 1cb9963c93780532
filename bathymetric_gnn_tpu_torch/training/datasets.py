"""Training datasets of graph samples (port of
``bathymetric_gnn_tpu/training/datasets.py``).

Synthetic-noise tiles (``SyntheticTileDataset``) and 5-band ground-truth
rasters (``GroundTruthTileDataset``) become bucketed PaddedGraphs with
per-node targets; correction targets are normalized by the node's
local_std with a floor and a cap. Everything here is NumPy on the host:
noise synthesis, the graph build (``data/graph_build.GraphBuilder``, the
k-NN branch: the only one ported) and the batching. The same seed gives
the same graphs and targets as the JAX package.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..config.config import Config
from ..config.constants import (CLASS_NOISE, CORRECTION_NORM_CAP,
                                CORRECTION_NORM_FLOOR)
from ..data.graph_build import BuiltGraph, GraphBuilder
from ..data.synthetic_noise import NoiseAugmentor, SyntheticNoiseGenerator
from ..data.tiling import TileManager
from ..ops.graph import PaddedGraph

logger = logging.getLogger(__name__)


@dataclass
class GraphSample:
    """One training example: padded graph + padded targets."""

    graph: PaddedGraph
    targets: Dict[str, np.ndarray]  # labels [N_pad], correction, noise_mask
    num_nodes: int


def normalize_correction(raw_correction: np.ndarray,
                         local_std: np.ndarray) -> np.ndarray:
    """correction / max(local_std, FLOOR), clipped to +-CAP."""
    denom = np.maximum(local_std, CORRECTION_NORM_FLOOR)
    return np.clip(raw_correction / denom, -CORRECTION_NORM_CAP,
                   CORRECTION_NORM_CAP).astype(np.float32)


def targets_from_built_graph(bg: BuiltGraph, labels_grid: np.ndarray,
                             raw_correction_grid: np.ndarray
                             ) -> Dict[str, np.ndarray]:
    """Gather per-node training targets from label/correction grids."""
    n_pad = bg.graph.num_nodes_padded
    n = bg.num_nodes
    labels = np.zeros(n_pad, np.int32)
    corr = np.zeros(n_pad, np.float32)
    rows, cols = bg.rows[:n], bg.cols[:n]
    labels[:n] = labels_grid[rows, cols]
    local_std = np.asarray(bg.graph.local_std)[:n]
    corr[:n] = normalize_correction(raw_correction_grid[rows, cols],
                                    local_std)
    noise_mask = labels == CLASS_NOISE
    noise_mask[n:] = False
    return {"labels": labels, "correction": corr, "noise_mask": noise_mask}


class SyntheticTileDataset:
    """Clean surveys + synthetic noise -> training graphs. Each item draws
    new noise from the dataset's generator, in call order."""

    def __init__(
        self,
        clean_grids: Sequence[np.ndarray],
        config: Optional[Config] = None,
        tile_size: int = 256,
        overlap: int = 32,
        min_valid_ratio: float = 0.3,
        seed: int = 0,
        uncertainty_grids: Optional[Sequence[np.ndarray]] = None,
        resolutions: Optional[Sequence[Tuple[float, float]]] = None,
    ):
        self.config = config or Config()
        self.builder = GraphBuilder(self.config.graph, self.config.bucket)
        self.tm = TileManager(tile_size, overlap, min_valid_ratio)
        gen = SyntheticNoiseGenerator(self.config.synthetic_noise, seed=seed)
        self.augmentor = NoiseAugmentor(gen, seed=seed + 1)
        self.rng = np.random.default_rng(seed + 2)
        # clean tiles cached in memory (they are small beside a survey)
        self.tiles: List[Tuple[np.ndarray, Optional[np.ndarray],
                               Tuple[float, float]]] = []
        for i, grid in enumerate(clean_grids):
            unc = uncertainty_grids[i] if uncertainty_grids is not None \
                else None
            res = resolutions[i] if resolutions is not None else (1.0, 1.0)
            for t in self.tm.iterate_tiles(np.asarray(grid, np.float32), unc):
                self.tiles.append((
                    t.data.copy(),
                    t.uncertainty.copy() if t.uncertainty is not None
                    else None, res))
        logger.info("SyntheticTileDataset: %d tiles cached", len(self.tiles))

    def __len__(self) -> int:
        return len(self.tiles)

    def raw_item(self, idx: int, seed: Optional[int] = None) -> Dict:
        """Noise synthesis + target grids of tile ``idx``. ``seed`` makes
        the draw a function of (seed, tile) instead of the dataset's
        sequential generator."""
        clean, unc, res = self.tiles[idx]
        valid = np.isfinite(clean)
        if seed is None:
            lbl = self.augmentor(clean, valid)
        else:
            gen = SyntheticNoiseGenerator(self.config.synthetic_noise,
                                          seed=seed)
            aug = NoiseAugmentor(gen, self.augmentor.intensity_range,
                                 seed=seed + 1)
            lbl = aug(clean, valid)
        raw_corr = (lbl.noisy_depth - lbl.clean_depth).astype(np.float32)
        return {"noisy": lbl.noisy_depth, "valid": valid, "unc": unc,
                "res": res, "labels": lbl.classification,
                "raw_corr": raw_corr}

    def finalize(self, raw: Dict) -> GraphSample:
        """Graph build + per-node target gather."""
        bg = self.builder.build_graph(raw["noisy"], raw["valid"],
                                      raw["unc"], raw["res"])
        targets = targets_from_built_graph(bg, raw["labels"],
                                           raw["raw_corr"])
        return GraphSample(bg.graph, targets, bg.num_nodes)

    def __getitem__(self, idx: int) -> GraphSample:
        return self.finalize(self.raw_item(idx))

    def class_counts(self, sample_limit: int = 50) -> np.ndarray:
        """Approximate per-class node counts, for the class weights."""
        counts = np.zeros(3, np.int64)
        idxs = self.rng.choice(len(self), min(sample_limit, len(self)),
                               replace=False)
        for i in idxs:
            s = self[int(i)]
            live = s.targets["labels"][: s.num_nodes]
            counts += np.bincount(live, minlength=3)[:3]
        return counts

    def sample_normalized_corrections(self, sample_limit: int = 20
                                      ) -> np.ndarray:
        vals = []
        idxs = self.rng.choice(len(self), min(sample_limit, len(self)),
                               replace=False)
        for i in idxs:
            s = self[int(i)]
            m = s.targets["noise_mask"][: s.num_nodes]
            vals.append(s.targets["correction"][: s.num_nodes][m])
        return np.concatenate(vals) if vals else np.array([])


class GroundTruthTileDataset:
    """Lazy tiled dataset over 5-band ground-truth rasters (labels,
    difference, noisy, clean, uncertainty), with an LRU-by-insertion cache
    of built samples."""

    BANDS = ("labels", "difference", "noisy", "clean", "uncertainty")

    def __init__(
        self,
        gt_files: Sequence[str],
        config: Optional[Config] = None,
        tile_size: int = 512,
        overlap: int = 64,
        min_valid_ratio: float = 0.1,
        cache_size: int = 256,
        seed: int = 0,
    ):
        from ..io.loaders import read_raster_bands

        self.config = config or Config()
        self.builder = GraphBuilder(self.config.graph, self.config.bucket)
        self.tm = TileManager(tile_size, overlap, min_valid_ratio)
        self._read_bands = read_raster_bands
        self.rng = np.random.default_rng(seed)
        # scan band 1 only: (file, spec) of tiles with enough labeled cells
        self.index: List[Tuple[str, object]] = []
        self._class_counts = np.zeros(3, np.int64)
        self._cache: Dict[int, GraphSample] = {}
        self._cache_order: List[int] = []
        self.cache_size = cache_size
        for path in gt_files:
            bands, _meta = self._read_bands(path, bands=[1])
            labels = bands[0]
            valid = labels >= 0
            _, _, specs = self.tm.compute_tile_grid(labels.shape)
            for spec in specs:
                sl = np.s_[spec.row_start:spec.row_end,
                           spec.col_start:spec.col_end]
                v = valid[sl]
                if v.mean() >= self.tm.min_valid_ratio:
                    self.index.append((path, spec))
                    lv = labels[sl][v].astype(np.int64)
                    self._class_counts += np.bincount(lv, minlength=3)[:3]
        logger.info("GroundTruthTileDataset: %d tiles indexed",
                    len(self.index))

    def __len__(self) -> int:
        return len(self.index)

    def __getstate__(self):
        # a worker process (utils/mp_loader) builds what the parent's
        # cache lacks and sends it back: the cache stays behind
        state = dict(self.__dict__)
        state["_cache"], state["_cache_order"] = {}, []
        return state

    def class_counts(self) -> np.ndarray:
        return self._class_counts

    def raw_item(self, idx: int, seed: Optional[int] = None) -> Dict:
        """Raster IO + window slicing of tile ``idx`` (``seed`` is taken
        for the synthetic dataset's interface; GT tiles are fixed). A
        GeoTIFF is read windowed: only the strips of the tile's rows."""
        path, spec = self.index[idx]
        sl_rows = (spec.row_start, spec.row_end)
        sl_cols = np.s_[spec.col_start:spec.col_end]
        if str(path).lower().endswith((".tif", ".tiff")):
            from ..io.geotiff import GeoTiffWindowReader

            with GeoTiffWindowReader(path) as rd:
                def band(i):
                    return rd.read_rows(i, *sl_rows)[:, sl_cols]

                labels = band(0)
                diff = band(1)
                noisy = band(2)
                unc = band(4) if rd.bands > 4 else None
                ps = rd.info.pixel_scale
                res = (abs(ps[0]), abs(ps[1])) if ps else (1.0, 1.0)
        else:
            bands, meta = self._read_bands(path)
            sl = np.s_[spec.row_start:spec.row_end,
                       spec.col_start:spec.col_end]
            labels = bands[0][sl]
            diff = bands[1][sl]
            noisy = bands[2][sl]
            unc = bands[4][sl] if len(bands) > 4 else None
            res = meta.get("resolution", (1.0, 1.0))
        valid = labels >= 0
        return {"noisy": noisy, "valid": valid, "unc": unc, "res": res,
                "labels": np.maximum(labels, 0), "raw_corr": diff}

    def finalize(self, raw: Dict) -> GraphSample:
        bg = self.builder.build_graph(raw["noisy"], raw["valid"],
                                      raw["unc"], raw["res"])
        targets = targets_from_built_graph(bg, raw["labels"],
                                           raw["raw_corr"])
        return GraphSample(bg.graph, targets, bg.num_nodes)

    def cached(self, idx: int) -> Optional[GraphSample]:
        """The built sample of tile ``idx`` if the cache holds it (a GT
        tile has no random draw: one build serves every epoch)."""
        return self._cache.get(idx)

    def remember(self, idx: int, sample: GraphSample) -> None:
        """Cache a built sample of tile ``idx``, built here or by a worker
        process (``utils/mp_loader``); past ``cache_size`` the oldest
        goes."""
        if idx in self._cache:
            return
        self._cache[idx] = sample
        self._cache_order.append(idx)
        if len(self._cache_order) > self.cache_size:
            evict = self._cache_order.pop(0)
            self._cache.pop(evict, None)

    def __getitem__(self, idx: int) -> GraphSample:
        sample = self.cached(idx)
        if sample is None:
            sample = self.finalize(self.raw_item(idx))
            self.remember(idx, sample)
        return sample

    def sample_normalized_corrections(self, sample_limit: int = 20
                                      ) -> np.ndarray:
        vals = []
        idxs = self.rng.choice(len(self), min(sample_limit, len(self)),
                               replace=False)
        for i in idxs:
            s = self[int(i)]
            m = s.targets["noise_mask"][: s.num_nodes]
            vals.append(s.targets["correction"][: s.num_nodes][m])
        return np.concatenate(vals) if vals else np.array([])


def collate_samples(samples: Sequence[GraphSample]
                    ) -> Tuple[PaddedGraph, Dict[str, np.ndarray]]:
    """Stack same-bucket samples along a leading batch axis ([B, ...]
    arrays); ``ops/graph.merge_stacked`` flattens the graph again."""
    graphs = PaddedGraph(**{
        f.name: np.stack([np.asarray(getattr(s.graph, f.name))
                          for s in samples])
        for f in dataclasses.fields(PaddedGraph)})
    targets = {k: np.stack([s.targets[k] for s in samples])
               for k in samples[0].targets}
    return graphs, targets


def epoch_batches(dataset, batch_size: int, rng: np.random.Generator,
                  shuffle: bool = True
                  ) -> Iterator[Tuple[PaddedGraph, Dict[str, np.ndarray]]]:
    """Shuffled fixed-size batches (the ragged tail is dropped, so every
    batch has the same shape)."""
    order = np.arange(len(dataset))
    if shuffle:
        rng.shuffle(order)
    for s in range(0, len(order) - batch_size + 1, batch_size):
        samples = [dataset[int(i)] for i in order[s:s + batch_size]]
        yield collate_samples(samples)
