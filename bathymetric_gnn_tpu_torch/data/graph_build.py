"""Model inputs from gridded depth (port of
``bathymetric_gnn_tpu/data/graph_build.py``).

- ``build_grid_inputs``: the dense-grid model's inputs, batched over
  [B, H, W] tiles (it stands in for the JAX path's ``jax.vmap`` of the
  per-tile function).
- ``GraphBuilder``: a grid's featurization plus its edges, on the host
  (torch on the CPU), packed into an ``ops.graph.PaddedGraph``. With
  ``knn_k == 0`` (``build_grid_graph``, the JAX ``_build_graph_device``)
  the edges are the grid's 4/8-connectivity (+ self loops), nodes in
  row-major order; with ``knn_k > 0`` k-NN edges over the valid cells,
  nodes in Hilbert order (``_build_knn_from_grid``, ``build_knn_graph``).
  The host, not the card: a serving flush builds its next graphs while
  the card runs the previous forward, and a graph built on the card would
  have to come back through a copy that waits for that forward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..config.config import BucketConfig, GraphConfig
from ..models.grid_gat import incoming_edge_attrs, neighbor_masks
from ..ops import edges as edge_ops
from ..ops import features as feat_ops
from ..ops.edges import offsets_for_connectivity
from ..ops.graph import PaddedGraph, make_padded_graph, round_up_to_bucket


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


def build_grid_graph(depth: torch.Tensor, valid_mask: torch.Tensor,
                     uncertainty: Optional[torch.Tensor], *,
                     resolution: Tuple[float, float], connectivity: int,
                     include_self_loops: bool, n_pad: int, e_pad: int,
                     stats_window: int):
    """One grid [H, W] -> its grid-connectivity graph as a PaddedGraph of
    NumPy arrays, with the node rows and cols [n_pad] (row-major valid
    cells; padded slots at (0, 0)). The JAX ``_build_graph_device``'s
    function, on the device of ``depth``."""
    depth = torch.where(torch.isfinite(depth), depth, torch.zeros_like(depth))
    gf = feat_ops.compute_grid_features(
        depth[None], valid_mask[None],
        None if uncertainty is None else uncertainty[None], stats_window)
    feats, local_std = gf.features[0], gf.local_std[0]
    rows, cols, node_valid = edge_ops.enumerate_nodes(valid_mask, n_pad)
    depth_c = torch.where(valid_mask, depth, torch.zeros_like(depth))
    depth_filled = torch.where(valid_mask, depth_c, gf.local_mean[0])
    src, dst, attr, mask = edge_ops.enumerate_edges_coo(
        valid_mask, rows, cols, node_valid, depth_filled, resolution,
        connectivity, include_self_loops)
    src, dst, attr, emask = edge_ops.compact_edges(src, dst, attr, mask,
                                                   e_pad, n_pad)
    rl, cl = rows.long(), cols.long()
    x = torch.where(node_valid[:, None], feats[rl, cl],
                    torch.zeros((), device=depth.device))
    lstd = torch.where(node_valid, local_std[rl, cl],
                       torch.zeros((), device=depth.device))
    pos = torch.stack([cols, rows], -1).to(torch.float32)
    g = PaddedGraph(
        x=x.cpu().numpy(), edge_src=src.cpu().numpy(),
        edge_dst=dst.cpu().numpy(), edge_attr=attr.cpu().numpy(),
        node_mask=node_valid.cpu().numpy(), edge_mask=emask.cpu().numpy(),
        pos=pos.cpu().numpy(), local_std=lstd.cpu().numpy(),
        graph_id=np.zeros(n_pad, np.int32))
    return g, rows.cpu().numpy(), cols.cpu().numpy()


class BuiltGraph:
    """A PaddedGraph plus what maps its nodes back onto the grid: node i
    sits at grid cell (rows[i], cols[i]); ``perm[i]`` is the index of node
    i in the input order (row-major valid cells) before the Hilbert sort."""

    def __init__(self, graph: PaddedGraph, grid_shape, num_nodes, rows,
                 cols, perm=None):
        self.graph = graph
        self.grid_shape = grid_shape
        self.num_nodes = num_nodes
        self.rows = rows
        self.cols = cols
        self.perm = perm

    def graph_to_grid(self, node_values: np.ndarray,
                      fill: float = np.nan) -> np.ndarray:
        """Scatter per-node values back onto the grid."""
        out = np.full(self.grid_shape, fill, np.float32)
        n = self.num_nodes
        out[self.rows[:n], self.cols[:n]] = np.asarray(node_values)[:n]
        return out


class GraphBuilder:
    """Builds PaddedGraphs from gridded depth on the host (featurization
    with the port's torch ops on the CPU)."""

    def __init__(self, graph_config: Optional[GraphConfig] = None,
                 bucket_config: Optional[BucketConfig] = None):
        self.cfg = graph_config or GraphConfig()
        self.buckets = bucket_config or BucketConfig()

    def pad_sizes(self, num_valid: int) -> Tuple[int, int]:
        """(n_pad, e_pad) of a grid-connectivity graph of ``num_valid``
        nodes: the node bucket, and connectivity (+ 1 with self loops)
        slots a node."""
        n_pad = round_up_to_bucket(max(num_valid, 1),
                                   self.buckets.node_buckets)
        k = self.cfg.connectivity + (1 if self.cfg.include_self_loops else 0)
        return n_pad, n_pad * k

    def build_graph(
        self,
        depth: np.ndarray,
        valid_mask: Optional[np.ndarray] = None,
        uncertainty: Optional[np.ndarray] = None,
        resolution: Tuple[float, float] = (1.0, 1.0),
    ) -> BuiltGraph:
        """Grid -> graph: grid connectivity with ``knn_k == 0``; with
        ``knn_k > 0`` the grid featurization is kept and the edges come
        from a k-NN build over the valid-cell coordinates."""
        if valid_mask is None:
            valid_mask = np.isfinite(depth)
        if self.cfg.knn_k > 0:
            return self._build_knn_from_grid(depth, valid_mask, uncertainty,
                                             resolution)
        valid_mask = np.asarray(valid_mask, bool)
        num_valid = int(valid_mask.sum())
        n_pad, e_pad = self.pad_sizes(num_valid)
        g, rows, cols = build_grid_graph(
            torch.from_numpy(np.asarray(depth, np.float32)),
            torch.from_numpy(valid_mask),
            None if uncertainty is None else
            torch.from_numpy(np.asarray(uncertainty, np.float32)),
            resolution=(float(resolution[0]), float(resolution[1])),
            connectivity=self.cfg.connectivity,
            include_self_loops=self.cfg.include_self_loops,
            n_pad=n_pad, e_pad=e_pad,
            stats_window=self.cfg.local_stats_window)
        return BuiltGraph(g, grid_shape=depth.shape, num_nodes=num_valid,
                          rows=rows, cols=cols)

    def _build_knn_from_grid(self, depth, valid_mask, uncertainty,
                             resolution) -> BuiltGraph:
        """Grid featurization + k-NN edges over the valid cells. Node
        features are those of the grid path; the nodes are Hilbert-ordered
        by ``build_knn_graph`` and rows/cols carry the permutation."""
        depth = np.asarray(depth, np.float32)
        valid_mask = np.asarray(valid_mask, bool)
        unc = (torch.from_numpy(np.asarray(uncertainty, np.float32))[None]
               if uncertainty is not None else None)
        gf = feat_ops.compute_grid_features(
            torch.from_numpy(np.where(np.isfinite(depth), depth, 0.0)
                             .astype(np.float32))[None],
            torch.from_numpy(valid_mask)[None], unc,
            self.cfg.local_stats_window)
        rows, cols = np.nonzero(valid_mask)
        feats = gf.features[0].numpy()[rows, cols]
        lstd = gf.local_std[0].numpy()[rows, cols]
        dvals = np.where(np.isfinite(depth), depth, 0.0)[rows, cols]
        pos = np.stack([cols, rows], -1).astype(np.float32)
        bg = self.build_knn_graph(
            feats, pos, k=self.cfg.knn_k, local_std=lstd,
            resolution=(float(resolution[0]), float(resolution[1])),
            depth=dvals)
        bg.grid_shape = depth.shape
        bg.rows = rows[bg.perm]
        bg.cols = cols[bg.perm]
        return bg

    def build_knn_graph(
        self,
        x: np.ndarray,
        pos: np.ndarray,
        k: int,
        local_std: Optional[np.ndarray] = None,
        resolution: Tuple[float, float] = (1.0, 1.0),
        depth: Optional[np.ndarray] = None,
        spatial_sort: bool = True,
    ) -> BuiltGraph:
        """k-NN graph from node coordinates. ``spatial_sort`` first puts
        the nodes in Hilbert order. Edge features are [distance, depth
        difference (dst - src), slope in degrees]."""
        n = x.shape[0]
        order = None
        if spatial_sort and n > 1:
            order = edge_ops.hilbert_order(pos)
            x = np.asarray(x)[order]
            pos = np.asarray(pos)[order]
            if local_std is not None:
                local_std = np.asarray(local_std)[order]
            if depth is not None:
                depth = np.asarray(depth)[order]
        ei = edge_ops.knn_edges(pos, k)
        res = np.asarray(resolution, np.float32)
        delta = (pos[ei[1]] - pos[ei[0]]) * res[None, :]
        dist = np.sqrt((delta ** 2).sum(-1)).astype(np.float32)
        if depth is not None:
            ddiff = (depth[ei[1]] - depth[ei[0]]).astype(np.float32)
        else:
            ddiff = np.zeros_like(dist)
        with np.errstate(divide="ignore", invalid="ignore"):
            slope = np.degrees(np.arctan(np.where(
                dist > 0, ddiff / np.maximum(dist, 1e-12), 0.0)))
        attr = np.stack([dist, ddiff, slope], -1).astype(np.float32)
        n_pad = round_up_to_bucket(max(n, 1), self.buckets.node_buckets)
        g = make_padded_graph(x, ei, attr, n_pad=n_pad,
                              e_pad=n_pad * max(k, 1), pos=pos,
                              local_std=local_std)
        return BuiltGraph(g, grid_shape=None, num_nodes=n, rows=None,
                          cols=None,
                          perm=order if order is not None else np.arange(n))
