"""Dense-grid model inputs (port of ``bathymetric_gnn_tpu/data/graph_build.py:213-243``).

Only ``build_grid_inputs``, batched over [B, H, W] tiles: it stands in for
the JAX path's ``jax.vmap`` of the per-tile function. COO graph
construction is ported in a later slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..models.grid_gat import incoming_edge_attrs, neighbor_masks
from ..ops import features as feat_ops
from ..ops.edges import offsets_for_connectivity


def build_grid_inputs(
    depth: torch.Tensor,
    valid_mask: torch.Tensor,
    uncertainty: Optional[torch.Tensor] = None,
    *,
    resolution: Tuple[float, float] = (1.0, 1.0),
    connectivity: int = 8,
    stats_window: int = 5,
    with_uncertainty: bool = False,
):
    """Inputs of GridBathymetricGNN for [B, H, W] tiles: (features
    [B, H, W, F], valid [B, H, W] bool, nbr_mask [B, K, H, W] bool,
    edge_attr [B, K, H, W, 3], local_std [B, H, W]), all on the device of
    ``depth``."""
    valid_mask = valid_mask.to(torch.bool)
    depth = depth.to(torch.float32)
    depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
    gf = feat_ops.compute_grid_features(
        depth, valid_mask, uncertainty if with_uncertainty else None,
        stats_window)
    depth_filled = torch.where(valid_mask, depth, gf.local_mean)
    offsets = offsets_for_connectivity(connectivity)
    nbr = neighbor_masks(valid_mask, offsets)
    eattr = incoming_edge_attrs(depth_filled, offsets,
                                (float(resolution[0]), float(resolution[1])))
    eattr = torch.where(nbr[..., None], eattr, torch.zeros_like(eattr))
    return gf.features, valid_mask, nbr, eattr, gf.local_std
