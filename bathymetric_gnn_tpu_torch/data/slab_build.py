"""Slab-batched inputs for VR refinement grids (port of
``bathymetric_gnn_tpu/data/slab_build.py``).

A VR BAG holds thousands of small refinement grids (3x3..50x50) of some
two thousand distinct shapes. The native VR path pads each grid on the
host into an S x S frame (``pack_slab``), stacks a flush's grids into one
[B, S, S] slab, uploads it once and featurizes it on the device in one
batched pass: ``build_slab_grid_inputs`` gives the dense grid model's
inputs, ``build_slab_ell`` the ELL graph of the slab's valid cells.

Boundary semantics: the masked local statistics do not see the invalid
padding, but ``np.gradient``'s one-sided differences and the Laplacian's
edge-replicating boundary fire at the slab's edge, not at the grid's. Two
per-cell fixups (``_boundary_fixups``) restore each grid's values at its
true bottom and right borders (its top and left borders are the slab's),
so the slab's features equal the per-grid builder's.

The edge attributes take each grid's resolution, ``res`` [B, 2], and the
JAX slab's slope, arctan(ddiff / max(dist, 1e-12)) in degrees.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..models.grid_gat import neighbor_masks, shift
from ..ops.edges import offsets_for_connectivity
from ..ops.ell import EllGraph
from ..ops.features import (_box_filter_sum, atan_deg, compute_grid_features,
                             sqrt)


def _boundary_fixups(feats: torch.Tensor, depth_filled: torch.Tensor,
                     valid: torch.Tensor, hs: torch.Tensor,
                     ws: torch.Tensor) -> torch.Tensor:
    """Per-grid gradient and curvature at the true borders of each grid
    of the slab: feats [B, S, S, F], depth_filled [B, S, S], valid
    [B, S, S] bool, hs / ws [B] the grids' heights and widths."""
    b, s, _, _ = feats.shape
    dev = feats.device
    r = torch.arange(s, device=dev).reshape(1, s, 1)
    c = torch.arange(s, device=dev).reshape(1, 1, s)
    h = hs.reshape(b, 1, 1)
    w = ws.reshape(b, 1, 1)
    df = depth_filled
    up = torch.roll(df, 1, dims=1)      # df[r - 1]
    down = torch.roll(df, -1, dims=1)   # df[r + 1]
    left = torch.roll(df, 1, dims=2)    # df[c - 1]
    right = torch.roll(df, -1, dims=2)  # df[c + 1]
    gx, gy, curv = feats[..., 3], feats[..., 4], feats[..., 6]
    # one-sided differences at the true last row / column (at the slab's
    # edge the formula gives the value the slab already has)
    last_r = (r == h - 1) & (h >= 2)
    last_c = (c == w - 1) & (w >= 2)
    gy = torch.where(last_r, df - up, gy)
    gx = torch.where(last_c, df - left, gx)
    gmag = sqrt(gx * gx + gy * gy)
    # the Laplacian's replicated edge: the neighbour past a true border
    # inside the slab mirrors to the border cell (weight 1), not to the
    # local-mean fill
    zero = torch.zeros((), device=dev)
    curv = curv + torch.where(last_r & (h < s), df - down, zero)
    curv = curv + torch.where(last_c & (w < s), df - right, zero)
    # the <3-valid-neighbours curvature gate, again
    count3 = _box_filter_sum(valid.to(torch.float32), 3)
    curv = torch.where(count3 < 3, zero, curv)
    out = feats.clone()
    out[..., 3], out[..., 4], out[..., 5], out[..., 6] = gx, gy, gmag, curv
    return out


def _slab_features(depth, valid, uncertainty, hs, ws, stats_window,
                   with_uncertainty):
    """(features with the border fixups, filled depth, valid, the grid
    features) of a slab; the valid mask comes from the NODATA depth and
    the grids' extents when not given."""
    b, s, _ = depth.shape
    if valid is None:
        # BAG NODATA (>= 1e5 or not finite) and the frame
        rr = torch.arange(s, device=depth.device).reshape(1, s, 1)
        cc = torch.arange(s, device=depth.device).reshape(1, 1, s)
        valid = (torch.isfinite(depth) & (depth.abs() < 1.0e5)
                 & (rr < hs.reshape(b, 1, 1)) & (cc < ws.reshape(b, 1, 1)))
    zero = torch.zeros((), device=depth.device)
    depth0 = torch.where(valid, torch.nan_to_num(depth.to(torch.float32)),
                         zero)
    gf = compute_grid_features(depth0, valid,
                               uncertainty if with_uncertainty else None,
                               stats_window)
    df = torch.where(valid, depth0, gf.local_mean)
    feats = _boundary_fixups(gf.features, df, valid, hs, ws)
    return feats, df, valid, gf


def _slope(ddiff: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    return atan_deg(ddiff / dist.clamp_min(1e-12))


def build_slab_grid_inputs(depth: torch.Tensor, valid: Optional[torch.Tensor],
                           uncertainty: Optional[torch.Tensor],
                           hs: torch.Tensor, ws: torch.Tensor,
                           res: torch.Tensor, *, connectivity: int,
                           with_uncertainty: bool, stats_window: int = 5):
    """Slab [B, S, S] (NODATA >= 1e5 or NaN at invalid cells) -> the dense
    grid model's inputs: (features [B, S, S, F], valid [B, S, S] bool,
    nbr_mask [B, K, S, S] bool, edge_attr [B, K, S, S, 3], local_std
    [B, S, S]), on the device of ``depth``. ``res`` [B, 2] holds each
    grid's (res_x, res_y)."""
    feats, df, valid, gf = _slab_features(
        depth, valid, uncertainty, hs, ws, stats_window, with_uncertainty)
    offsets = offsets_for_connectivity(connectivity)
    nbr = neighbor_masks(valid, offsets)
    rx = res[:, 0].reshape(-1, 1, 1)
    ry = res[:, 1].reshape(-1, 1, 1)
    planes = []
    for dr, dc in offsets:
        dist = sqrt((dc * rx) ** 2 + (dr * ry) ** 2)
        ddiff = df - shift(df, dr, dc)
        planes.append(torch.stack(
            [dist.expand_as(ddiff), ddiff, _slope(ddiff, dist)], -1))
    eattr = torch.stack(planes, dim=1)
    eattr = torch.where(nbr[..., None], eattr, torch.zeros((), device=df.device))
    return feats, valid, nbr, eattr, gf.local_std


def build_slab_ell(depth: torch.Tensor, valid: Optional[torch.Tensor],
                   uncertainty: Optional[torch.Tensor], hs: torch.Tensor,
                   ws: torch.Tensor, res: torch.Tensor, *, connectivity: int,
                   n_pad: int, with_uncertainty: bool, stats_window: int = 5,
                   lin: Optional[torch.Tensor] = None
                   ) -> Tuple[EllGraph, torch.Tensor, torch.Tensor,
                              torch.Tensor]:
    """Slab -> the ELL graph of its valid cells, n_pad nodes in row-major
    order per grid, grids in slab order (each grid's ``np.nonzero``
    order). ``lin``: the flat indices (b * S * S + r * S + c) of the valid
    cells in that order, on the device; a caller that knows them (the VR
    processor, from its host masks) passes them so that no ``nonzero``
    waits for the device; else they are found here. Returns (graph of
    tensors, rows, cols, grid index), the last three [n_pad]."""
    b, s, _ = depth.shape
    cells = s * s
    dev = depth.device
    feats, df, valid, gf = _slab_features(
        depth, valid, uncertainty, hs, ws, stats_window, with_uncertainty)
    f = feats.shape[-1]

    if lin is None:
        (lin,) = torch.nonzero(valid.reshape(-1), as_tuple=True)
    n = lin.shape[0]
    if n > n_pad:
        raise ValueError(f"{n} valid cells > n_pad {n_pad}")
    lin = torch.cat([lin.to(torch.long),
                     torch.zeros(n_pad - n, dtype=torch.long, device=dev)])
    node_valid = torch.arange(n_pad, device=dev) < n
    bi = lin // cells
    rc = lin - bi * cells
    r = rc // s
    c = rc - r * s
    # cell -> node slot (-1: none)
    idx_flat = torch.full((b * cells,), -1, dtype=torch.int32, device=dev)
    idx_flat[lin[:n]] = torch.arange(n, dtype=torch.int32, device=dev)

    df_flat = df.reshape(-1)
    d_ctr = df_flat[lin]
    res_x = res[:, 0][bi]
    res_y = res[:, 1][bi]
    zero = torch.zeros((), device=dev)
    srcs, masks, attrs = [], [], []
    for dr, dc in offsets_for_connectivity(connectivity):
        nr, nc = r + dr, c + dc
        inb = (nr >= 0) & (nr < s) & (nc >= 0) & (nc < s)
        nbr_lin = bi * cells + nr.clamp(0, s - 1) * s + nc.clamp(0, s - 1)
        nbr = idx_flat[nbr_lin]
        ok = node_valid & inb & (nbr >= 0)
        # incoming edge (r + dr, c + dc) -> (r, c): ddiff = dst - src
        ddiff = d_ctr - df_flat[nbr_lin]
        dist = sqrt((dc * res_x) ** 2 + (dr * res_y) ** 2)
        ea = torch.stack([dist, ddiff, _slope(ddiff, dist)], -1)
        srcs.append(torch.where(ok, nbr, torch.zeros_like(nbr)))
        masks.append(ok)
        attrs.append(torch.where(ok[:, None], ea, zero))

    x = torch.where(node_valid[:, None], feats.reshape(b * cells, f)[lin],
                    zero)
    local_std = torch.where(node_valid, gf.local_std.reshape(-1)[lin], zero)
    pos = torch.stack([c.to(torch.float32), r.to(torch.float32)], -1)
    graph_id = torch.where(node_valid, bi, torch.full_like(bi, -1)
                           ).to(torch.int32)
    g = EllGraph(x=x, nbr_src=torch.stack(srcs, 1),
                 nbr_mask=torch.stack(masks, 1),
                 edge_attr=torch.stack(attrs, 1), node_mask=node_valid,
                 pos=pos, local_std=local_std, graph_id=graph_id)
    return g, r, c, bi


def pack_slab(grids, slab_size: int, b_pad: int, with_uncertainty: bool,
              implicit_valid: bool = False):
    """Host packing of refinement grids, each (depth, valid, uncertainty
    or None, (res_x, res_y)), into slab arrays: (depth [b_pad, S, S],
    valid [b_pad, S, S] bool or None, uncertainty [b_pad, S, S] or None,
    hs, ws [b_pad] int32, res [b_pad, 2] f32). With ``implicit_valid`` the
    valid mask is not packed: invalid cells hold NODATA (1e6) in the depth
    slab and the device derives the mask from it (half the upload)."""
    s = slab_size
    fill = np.float32(1.0e6) if implicit_valid else np.float32(0.0)
    depth = np.full((b_pad, s, s), fill, np.float32)
    valid = None if implicit_valid else np.zeros((b_pad, s, s), bool)
    unc = np.zeros((b_pad, s, s), np.float32) if with_uncertainty else None
    hs = np.ones(b_pad, np.int32)
    ws = np.ones(b_pad, np.int32)
    res = np.ones((b_pad, 2), np.float32)
    for i, (d, v, u, rxy) in enumerate(grids):
        h, w = d.shape
        if implicit_valid:
            depth[i, :h, :w] = np.where(
                v, np.nan_to_num(d.astype(np.float32)), np.float32(1.0e6))
        else:
            depth[i, :h, :w] = np.nan_to_num(d.astype(np.float32))
            valid[i, :h, :w] = v
        if with_uncertainty and u is not None:
            unc[i, :h, :w] = np.nan_to_num(u.astype(np.float32))
        hs[i], ws[i] = h, w
        res[i] = rxy
    return depth, valid, unc, hs, ws, res
