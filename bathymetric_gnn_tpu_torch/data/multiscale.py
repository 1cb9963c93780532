"""Multi-scale graph pyramid (port of ``bathymetric_gnn_tpu/data/multiscale.py``).

Coarsened copies of a tile at scales [1, 2, 4] by nanmean pooling with a
>= 0.5-majority validity mask (reference: data/graph_construction.py:
508-607), each built into a graph by the port's ``GraphBuilder`` (on the
host) at the scaled resolution. The reference builds the pyramid but never
feeds it to the model; neither package does.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from ..config.config import BucketConfig, GraphConfig
from .graph_build import BuiltGraph, GraphBuilder


def downsample_depth(depth: np.ndarray, valid: np.ndarray, factor: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """nanmean pooling + majority-valid mask
    (reference: data/graph_construction.py:583-607)."""
    if factor == 1:
        return depth.copy(), valid.copy()
    h, w = depth.shape
    th, tw = h // factor * factor, w // factor * factor
    d = np.where(valid, depth, np.nan)[:th, :tw]
    v = valid[:th, :tw]
    d4 = d.reshape(th // factor, factor, tw // factor, factor)
    v4 = v.reshape(th // factor, factor, tw // factor, factor)
    # nansum/count instead of nanmean: all-NaN pools are common at swath
    # gaps and nanmean warns "Mean of empty slice" on every one of them
    cnt = np.count_nonzero(~np.isnan(d4), axis=(1, 3))
    pooled = np.nansum(d4, axis=(1, 3)) / np.maximum(cnt, 1)
    pooled = np.where(cnt > 0, pooled, np.nan)
    frac = v4.mean(axis=(1, 3))
    pooled_valid = frac >= 0.5
    pooled = np.where(pooled_valid, np.nan_to_num(pooled), np.nan)
    return pooled.astype(np.float32), pooled_valid


class MultiScaleGraphBuilder:
    """Hierarchical graph pyramid over a tile."""

    def __init__(
        self,
        scales: Sequence[int] = (1, 2, 4),
        graph_config: Optional[GraphConfig] = None,
        bucket_config: Optional[BucketConfig] = None,
    ):
        self.scales = tuple(scales)
        self.builder = GraphBuilder(graph_config, bucket_config)

    def build_multiscale_graph(
        self,
        depth: np.ndarray,
        valid_mask: Optional[np.ndarray] = None,
        uncertainty: Optional[np.ndarray] = None,
        resolution: Tuple[float, float] = (1.0, 1.0),
    ) -> Dict[int, BuiltGraph]:
        """Scale -> BuiltGraph (resolution scaled per level)."""
        if valid_mask is None:
            valid_mask = np.isfinite(depth)
        out: Dict[int, BuiltGraph] = {}
        for s in self.scales:
            d, v = downsample_depth(depth, valid_mask, s)
            unc = None
            if uncertainty is not None:
                unc, _ = downsample_depth(uncertainty, valid_mask, s)
                unc = np.nan_to_num(unc)
            res = (resolution[0] * s, resolution[1] * s)
            out[s] = self.builder.build_graph(np.nan_to_num(d), v, unc, res)
        return out
