"""Tiled end-to-end inference (port of ``bathymetric_gnn_tpu/inference/pipeline.py``).

Load model -> tile -> featurize + dense-grid GAT forward on the device ->
stitch -> calibrate confidence -> correct -> write. Corrections are
denormalized by the per-cell local std, tiles are Hann-stitched with
confidence-argmax classification, unprocessed valid cells are back-filled
as seafloor / confidence 0, and corrections are subtracted on confident
noise. Each GAT layer runs the CUDA kernel on the card; on the CPU (only
when asked for with ``device="cpu"``) it runs the kernel's plain version.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..config.config import Config
from ..config.constants import (CLASS_NOISE, CLASS_SEAFLOOR,
                                CORRECTION_NORM_FLOOR)
from ..data.graph_build import build_grid_inputs
from ..data.tiling import TileManager, TileMerger
from ..io.loaders import BathymetricGrid, BathymetricLoader, BathymetricWriter
from ..models.grid_gat import GridBathymetricGNN
from ..utils import prof
from ..utils.weights import load_state_dict, state_dict_from_flax

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_device(device=None) -> torch.device:
    """``None`` means the card. Raises when no CUDA device is present,
    unless the caller asks for the CPU (``device="cpu"``): nothing falls
    back to the CPU unasked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(CLI: --device cpu) to run on the CPU")
    return dev


def load_confidence_calibration(checkpoint_dir) -> Dict:
    """Platt parameters {"scale", "bias"} from calibration.json in the
    checkpoint dir (or its parent run dir); identity when absent. Legacy
    files carrying only ``confidence_temperature`` map to scale = 1/T."""
    for d in (Path(checkpoint_dir), Path(checkpoint_dir).parent):
        f = d / "calibration.json"
        if f.exists():
            try:
                info = json.loads(f.read_text())
                if "confidence_scale" in info:
                    return {"scale": float(info["confidence_scale"]),
                            "bias": float(info.get("confidence_bias", 0.0))}
                t = float(info.get("confidence_temperature", 1.0))
                return {"scale": 1.0 / t, "bias": 0.0}
            except (ValueError, OSError, ZeroDivisionError):
                logger.warning("unreadable calibration.json at %s", f)
    return {"scale": 1.0, "bias": 0.0}


def apply_confidence_calibration(conf: np.ndarray, scale: float,
                                 bias: float = 0.0):
    """conf' = sigmoid(scale * logit(conf) + bias): Platt scaling of the
    confidence head, identity at (1, 0). ``bias`` carries the
    decision-aligned shift fitted by the JAX trainer; it is applied as
    is."""
    if scale == 1.0 and bias == 0.0:
        return conf
    c = np.clip(conf, 1e-6, 1.0 - 1e-6)
    z = np.log(c / (1.0 - c))
    return (1.0 / (1.0 + np.exp(-(scale * z + bias)))).astype(conf.dtype)


def apply_confidence_temperature(conf: np.ndarray, t: float):
    """The legacy single-temperature form: conf' = sigmoid(logit(conf) /
    t), the Platt map at (1 / t, 0)."""
    return apply_confidence_calibration(conf, 1.0 / t, 0.0)


def _pack_channels(out: Dict, corr: Optional[torch.Tensor]) -> torch.Tensor:
    """(classification, confidence, correction) packed into one f16
    tensor [3, B, H, W]: one device->host copy per batch. The outputs are
    defined by this rounding (the confidence thresholds compare f16
    values), as in the JAX pipeline."""
    if corr is None:
        corr = torch.zeros_like(out["confidence"])
    return torch.stack([
        out["predicted_class"].to(torch.float16),
        out["confidence"].to(torch.float16),
        corr.to(torch.float16),
    ])


def _unpack_channels(arr: np.ndarray) -> Dict[str, np.ndarray]:
    """Host-side inverse of _pack_channels for one tile ([3, H, W])."""
    return {
        "classification": arr[0].astype(np.float32),
        "confidence": arr[1].astype(np.float32),
        "correction": arr[2].astype(np.float32),
    }


def infer_in_channels(state_dict: Dict[str, torch.Tensor]) -> int:
    """Input width of the first extractor Linear."""
    return int(state_dict["MLPFeatureExtractor_0.TorchLinear_0.kernel"]
               .shape[0])


class BathymetricPipeline:
    """Load model -> tile -> dense-grid forward -> stitch -> write.

    ``device=None`` runs on the card and raises without one; the CPU runs
    only when asked for (``device="cpu"``). The path sets
    ``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32`` to False: the JAX reference
    computes in true f32, and TF32 would keep only ~3 decimal digits in
    the plain-PyTorch products around the kernel (features, heads).
    """

    def __init__(self, config: Optional[Config] = None,
                 vr_bag_mode: str = "resampled", tile_batch: int = 8,
                 device=None):
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config or Config()
        self.loader = BathymetricLoader(vr_bag_mode)
        self.writer = BathymetricWriter(compress_level=1)  # write speed
        # is on the survey wall-clock path; level 1 is ~3x faster
        t = self.config.tile
        self.tm = TileManager(t.tile_size, t.overlap, t.min_valid_ratio)
        self.tile_batch = max(1, tile_batch)
        self.model: Optional[GridBathymetricGNN] = None
        self.in_channels = 7

    # -- model -------------------------------------------------------------

    def load_model(self, checkpoint_dir):
        """Load a port checkpoint (``utils/weights.save_checkpoint``).
        Model config: ``config.yaml`` in the checkpoint dir, else in its
        parent, else defaults. Calibration, applied to this pipeline's
        config: a non-default ``confidence_temperature`` wins (scale = 1/T,
        bias = 0); else an explicit scale/bias; else calibration.json."""
        path = Path(checkpoint_dir)
        state_dict, _meta = load_state_dict(path)
        cfg = Config()
        for cand in (path / "config.yaml", path.parent / "config.yaml"):
            if cand.exists():
                cfg = Config.load(cand)
                break
        self.config.model = cfg.model
        cal = load_confidence_calibration(path)
        inf = self.config.inference
        if inf.confidence_temperature != 1.0:
            inf.confidence_scale = 1.0 / inf.confidence_temperature
            inf.confidence_bias = 0.0
        elif inf.confidence_scale == 1.0 and inf.confidence_bias == 0.0:
            inf.confidence_scale = cal["scale"]
            inf.confidence_bias = cal["bias"]
        self.use_state_dict(state_dict)

    def use_variables(self, params: Dict, batch_stats: Dict,
                      from_coo: bool = True):
        """Wire in-memory flax variables (nested dicts of arrays), as the
        JAX pipeline's ``use_variables`` takes them."""
        self.use_state_dict(state_dict_from_flax(
            params, batch_stats, "coo" if from_coo else "grid"))

    def use_state_dict(self, state_dict: Dict[str, torch.Tensor]):
        """Wire in-memory weights (the port's state_dict, grid layout)."""
        self.in_channels = infer_in_channels(state_dict)
        mc = self.config.model
        self.model = GridBathymetricGNN(
            in_channels=self.in_channels,
            hidden_channels=mc.hidden_channels, num_layers=mc.num_layers,
            heads=mc.heads, num_classes=mc.num_classes,
            predict_correction=mc.predict_correction,
            feature_extractor_layers=mc.feature_extractor_layers,
            edge_dim=3, connectivity=self.config.graph.connectivity,
            compute_dtype=_DTYPES[mc.compute_dtype],
        )
        self.model.load_state_dict(state_dict)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def forward_tiles(self, depth: np.ndarray, valid: np.ndarray,
                      uncertainty: Optional[np.ndarray],
                      resolution) -> torch.Tensor:
        """[B, H, W] tiles -> packed f16 [3, B, H, W] on the device
        (featurization, model, correction denormalization). Spans
        (``utils/prof``): ``pipeline.forward_tiles`` around
        ``pipeline.upload``, ``pipeline.featurize``, ``model.layers`` and
        ``pipeline.heads``."""
        dev = self.device
        b = int(depth.shape[0])
        with prof.TRACER.root("pipeline.forward_tiles", {"tiles": b}) as sp:
            if sp is not None:
                sp.work["cells"] = int(np.count_nonzero(valid))
            with prof.TRACER.span("pipeline.upload", {"tiles": b}):
                d = torch.from_numpy(np.ascontiguousarray(depth, np.float32)
                                     ).to(dev)
                v = torch.from_numpy(np.ascontiguousarray(valid)).to(dev)
                u = (torch.from_numpy(np.ascontiguousarray(
                    uncertainty, np.float32)).to(dev)
                    if uncertainty is not None else None)
            with prof.TRACER.span("pipeline.featurize", {"tiles": b}, dev):
                feats, v, nbr, eattr, local_std = build_grid_inputs(
                    d, v, u, resolution=resolution,
                    connectivity=self.config.graph.connectivity,
                    stats_window=self.config.graph.local_stats_window,
                    with_uncertainty=u is not None)
            x = self.model.trunk(feats, v, nbr, eattr)
            with prof.TRACER.span("pipeline.heads", {"tiles": b}, dev):
                out = self.model.heads(x)
                corr = out.get("correction")
                if corr is not None:
                    corr = corr * local_std.clamp_min(CORRECTION_NORM_FLOOR)
                return _pack_channels(out, corr)

    # -- processing --------------------------------------------------------

    def process(self, input_path, output_path,
                export_extras: bool = True) -> Dict:
        """Full-survey tiled inference."""
        if self.model is None:
            raise RuntimeError("load_model() first")
        t0 = time.time()
        grid = self.loader.load(input_path)
        valid = grid.valid_mask
        use_unc = (grid.uncertainty is not None
                   and self.in_channels >= 8)

        merger = TileMerger(self.tm)
        merger.initialize(grid.depth.shape,
                          ["classification", "confidence", "correction"])
        resolution = (float(grid.resolution[0]), float(grid.resolution[1]))
        n_tiles = 0

        # Work is queued on the device asynchronously; a batch's results
        # are copied to the host and merged only once a few later batches
        # are in flight, overlapping device compute with numpy stitching.
        inflight: list = []
        MAX_INFLIGHT = 4

        def merge_ready(force=False):
            nonlocal n_tiles
            while inflight and (force or len(inflight) > MAX_INFLIGHT):
                tiles, res = inflight.pop(0)
                work = {"tiles": len(tiles)}
                with prof.TRACER.span("pipeline.to_host", work):
                    arr = res.cpu().numpy()  # ONE copy: [3, B, H, W]
                with prof.TRACER.span("pipeline.merge", work):
                    for bi, t in enumerate(tiles):
                        merger.add_tile(t.spec, _unpack_channels(arr[:, bi]),
                                        tile_valid=t.valid_mask)
                        n_tiles += 1
                if n_tiles and n_tiles % 50 < len(tiles):
                    logger.info("processed %d tiles", n_tiles)

        def dispatch(tiles):
            with prof.TRACER.span("pipeline.stack", {"tiles": len(tiles)}):
                stacked = (
                    np.stack([np.nan_to_num(t.data) for t in tiles]),
                    np.stack([t.valid_mask for t in tiles]),
                    np.stack([np.nan_to_num(t.uncertainty) for t in tiles])
                    if use_unc else None)
            res = self.forward_tiles(*stacked, resolution)
            inflight.append((tiles, res))
            merge_ready()

        full_shape = (self.tm.tile_size, self.tm.tile_size)
        pending: list = []
        for tile in self.tm.iterate_tiles(grid.depth, grid.uncertainty, valid):
            if self.tile_batch > 1 and tile.shape == full_shape:
                pending.append(tile)
                if len(pending) == self.tile_batch:
                    dispatch(pending)
                    pending = []
            else:
                dispatch([tile])
        for t in pending:  # the ragged tail runs one tile at a time
            dispatch([t])
        merge_ready(force=True)

        final = self._finish_channels(merger.finalize(), valid)
        cleaned, n_corrected = self._apply_corrections(grid, final, valid)
        out_grid = BathymetricGrid(
            depth=cleaned,
            uncertainty=self._scale_uncertainty(grid, final, valid),
            geotransform=grid.geotransform, crs=grid.crs,
            resolution=grid.resolution, nodata=grid.nodata,
        )
        extra = None
        if export_extras:
            extra = {
                "classification": final["classification"],
                "confidence": final["confidence"],
                "correction": final["correction"],
                "valid_mask": valid.astype(np.float32),
            }
        src_bag = (grid.source_path
                   if str(output_path).lower().endswith(".bag") else None)
        self.writer.save(out_grid, output_path, extra_bands=extra,
                         source_bag=src_bag)

        stats = self._summary(grid, final, valid, n_tiles, n_corrected,
                              time.time() - t0)
        logger.info("inference summary: %s", stats)
        return stats

    def _finish_channels(self, final: Dict[str, np.ndarray],
                         valid: np.ndarray) -> Dict[str, np.ndarray]:
        """Merged channels -> final ones, in place: unprocessed valid cells
        back-filled as seafloor / confidence 0 / correction 0, the
        remaining NaNs zeroed, then the confidence calibrated."""
        unproc = valid & ~np.isfinite(final["classification"])
        final["classification"][unproc] = CLASS_SEAFLOOR
        final["confidence"][unproc] = 0.0
        final["correction"][unproc] = 0.0
        for ch in ("confidence", "correction"):
            final[ch] = np.nan_to_num(final[ch], nan=0.0)
        final["confidence"] = apply_confidence_calibration(
            final["confidence"], self.config.inference.confidence_scale,
            self.config.inference.confidence_bias)
        return final

    def _correction_mask(self, final, valid) -> np.ndarray:
        """Confident noise: the cells whose correction is applied."""
        thr = self.config.inference.auto_correct_threshold
        return (valid & (final["classification"] == CLASS_NOISE)
                & (final["confidence"] > thr))

    def _apply_corrections(self, grid, final, valid):
        """cleaned = original - correction on confident noise."""
        cleaned = grid.depth.astype(np.float32).copy()
        m = self._correction_mask(final, valid)
        cleaned[m] -= final["correction"][m]
        return cleaned, int(m.sum())

    def _scale_uncertainty(self, grid, final, valid):
        """uncertainty *= (2 - confidence) on corrected cells."""
        if grid.uncertainty is None:
            return None
        unc = grid.uncertainty.astype(np.float32).copy()
        m = self._correction_mask(final, valid)
        unc[m] *= (2.0 - final["confidence"][m])
        return unc

    def _summary(self, grid, final, valid, n_tiles, n_corrected, dt):
        nv = max(int(valid.sum()), 1)
        cls = final["classification"][valid]
        return {
            "tiles_processed": n_tiles,
            "valid_cells": nv,
            "seafloor_pct": float((cls == 0).mean() * 100),
            "feature_pct": float((cls == 1).mean() * 100),
            "noise_pct": float((cls == 2).mean() * 100),
            "mean_confidence": float(final["confidence"][valid].mean()),
            "cells_corrected": n_corrected,
            "elapsed_s": round(dt, 2),
        }
