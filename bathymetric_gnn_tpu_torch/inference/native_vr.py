"""Native VR BAG inference: bucketed batching of refinement grids (port of
``bathymetric_gnn_tpu/inference/native_vr.py``).

Thousands of small refinement grids (3x3..50x50) are batched under a node
budget, run in one forward per chunk, and un-batched back onto their
grids, in input order. Two routes, as in the JAX processor:

- the default route (``graph.knn_k == 0``): grids with both sides up to
  ``slab_size`` (and the smaller at least 2) are deferred to the flush,
  padded on the host into one [B, S, S] slab per chunk (``data/slab_build.
  pack_slab``), uploaded once, featurized on the device and served by the
  dense grid model (``GridBathymetricGNN``: kernel A on the card, f32 or
  bf16 with the BatchNorm folded into its epilogue); with ``use_grid``
  off, by the slab's ELL graph (``build_slab_ell``) through the ELL model.
  Larger and one-cell-thin grids get grid-connectivity graphs
  (``data/graph_build.GraphBuilder``, on the host) through the ELL model
  on the ``"xla"`` route (``GATConvELL``: kernel C on the card);
- the k-NN route (``knn_k > 0``): every grid becomes a k-NN graph on the
  host, through the ELL model on route C (kernel C; ``sparse_kernel``
  "auto" resolves to "banded_pallas" for a GAT model, as on the TPU) or,
  with ``sparse_kernel="banded"``, kernel E and the spill fold over each
  chunk's band/spill decomposition (``ops/ell_banded.band_ell``, 128-row
  bands, built on the host beside the graph).

A GCN, GraphSAGE or GIN model takes the same routes with the ELL model's
plain layers (slabs as ELL graphs, ``build_slab_ell``: the dense grid
model is GAT only). ``use_ell=False`` serves the COO model
(``models/gnn.BathymetricGNN``, any type): no slabs, every grid's graph
batched (``batch_graphs``) into a ``CooGraph`` with its destination table,
whose segment sums run kernel F on the card.

On the CPU (only when asked for with ``device="cpu"``) the kernels' plain
versions run. Chunks hold at most the largest node bucket's nodes, slab
chunks at most ``slab_batch_buckets[-1]`` grids (the JAX processor splits
slabs by nodes only and then fails to bucket a flush of more grids). The
slab is not padded to a batch bucket: the JAX processor pads for its
compile-once static shapes, which eager torch and the kernels do not need.

One flush generation stays in flight: a flush launches its chunks on the
device and starts non-blocking copies of the packed f16 outputs to pinned
host memory, and its results are taken one flush later, in input order
(``drain`` takes the rest), so the host's packing and graph building of
the next batch overlap the device's work. Nothing in a launch waits for
the device: a slab chunk's compaction indices come from the host's masks.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config.config import Config
from ..config.constants import CORRECTION_NORM_FLOOR
from ..data.graph_build import GraphBuilder
from ..data.slab_build import (build_slab_ell, build_slab_grid_inputs,
                               pack_slab)
from ..models.gnn import make_model
from ..models.gnn_ell import make_ell_model
from ..models.grid_gat import GridBathymetricGNN
from ..ops.ell import coo_to_ell
from ..ops.ell_banded import band_ell
from ..ops.graph import CooGraph, batch_graphs, round_up_to_bucket
from ..utils.weights import coo_state_dict
from .pipeline import _DTYPES, infer_in_channels, resolve_device

logger = logging.getLogger(__name__)


def _pack_outputs(out: Dict[str, torch.Tensor],
                  local_std: torch.Tensor) -> torch.Tensor:
    """[..., 3] f16 (class, confidence, correction x max(local_std,
    floor)): one copy back per chunk. Classes {0, 1, 2} are exact in f16;
    confidence and correction round to f16, as in the JAX path."""
    corr = out.get("correction")
    if corr is None:
        corr = torch.zeros_like(out["confidence"])
    else:
        corr = corr * local_std.clamp_min(CORRECTION_NORM_FLOOR)
    return torch.stack([out["predicted_class"].to(torch.float16),
                        out["confidence"].to(torch.float16),
                        corr.to(torch.float16)], dim=-1)


def _upload(arrays: Sequence[Optional[np.ndarray]],
            device: torch.device) -> List[Optional[torch.Tensor]]:
    """Host arrays as tensors on ``device``; on the card through one
    pinned staging buffer and one non-blocking copy."""
    if device.type != "cuda":
        return [None if a is None else torch.from_numpy(a) for a in arrays]
    spans, size = [], 0
    for a in arrays:
        spans.append(size)
        if a is not None:
            size += -(-a.nbytes // 16) * 16
    host = torch.empty(max(size, 16), dtype=torch.uint8, pin_memory=True)
    staged = host.numpy()
    for a, off in zip(arrays, spans):
        if a is not None:
            staged[off:off + a.nbytes] = np.ascontiguousarray(a).view(
                np.uint8).reshape(-1)
    dev = host.to(device, non_blocking=True)
    return [None if a is None else
            dev[off:off + a.nbytes].view(torch.from_numpy(a[:0]).dtype)
            .reshape(a.shape) for a, off in zip(arrays, spans)]


class NativeVRProcessor:
    """Batches refinement grids into single forward passes.

    ``state_dict``: the port's (grid-named) weights; the model's widths
    come from ``config.model``. ``device=None`` means the card and raises
    without one; ``"cpu"`` runs the plain versions of the kernels.
    ``use_slab``, ``use_grid``, ``slab_size``, ``slab_batch_buckets`` and
    ``compute_dtype`` are the JAX processor's: the slab route needs
    ``knn_k == 0`` and no explicit self loops; ``use_grid`` (default on for
    GAT) serves slabs through the dense grid model in ``compute_dtype``
    (None: bf16 on the card, which plays the TPU's role, f32 on the CPU).
    ``use_ell=False`` serves the COO model on graphs only, as the JAX
    processor does.
    """

    def __init__(
        self,
        state_dict: Dict[str, torch.Tensor],
        config: Optional[Config] = None,
        node_budget: int = 50000,
        node_buckets: Tuple[int, ...] = (1024, 4096, 16384, 65536, 131072),
        device=None,
        use_ell: bool = True,
        use_slab: bool = True,
        use_grid: Optional[bool] = None,
        slab_size: int = 56,
        slab_batch_buckets: Tuple[int, ...] = (8, 32, 128, 512, 2048),
        compute_dtype: Optional[str] = None,
    ):
        self.config = cfg = config or Config()
        self.use_ell = use_ell
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.knn_k = int(cfg.graph.knn_k)
        gat = cfg.model.gnn_type == "GAT"
        sk = cfg.model.sparse_kernel
        if sk == "auto":
            sk = "banded_pallas" if self.knn_k > 0 and gat else "xla"
        if sk != "xla" and (self.knn_k == 0 or not gat):
            logger.warning("sparse_kernel=%s needs knn_k>0 and GAT; "
                           "falling back to xla", sk)
            sk = "xla"
        self.sparse_kernel = sk
        # the slab ELL has exactly `connectivity` incoming slots: explicit
        # self-loop edges would need one more
        self.use_slab = (use_slab and use_ell and self.knn_k == 0
                         and not cfg.graph.include_self_loops)
        if use_grid is None:
            use_grid = gat
        self.use_grid = bool(use_grid and self.use_slab and gat)
        self.slab_size = slab_size
        self.slab_batch_buckets = slab_batch_buckets
        self.in_channels = infer_in_channels(state_dict)
        if use_ell:
            self.model = make_ell_model(cfg.model, self.in_channels,
                                        edge_dim=3, sparse_kernel=sk)
        else:
            self.model = make_model(cfg.model, self.in_channels, edge_dim=3)
        self.model.load_state_dict(coo_state_dict(state_dict))
        self.model.to(self.device).eval()
        self.compute_dtype = None
        if self.use_grid:
            if compute_dtype is None:
                compute_dtype = ("bfloat16" if self.device.type == "cuda"
                                 else "float32")
            self.compute_dtype = compute_dtype
            mc = cfg.model
            self.grid_model = GridBathymetricGNN(
                in_channels=self.in_channels,
                hidden_channels=mc.hidden_channels,
                num_layers=mc.num_layers, heads=mc.heads,
                num_classes=mc.num_classes,
                predict_correction=mc.predict_correction,
                feature_extractor_layers=mc.feature_extractor_layers,
                edge_dim=3, connectivity=cfg.graph.connectivity,
                compute_dtype=_DTYPES[compute_dtype], dropout=0.0)
            self.grid_model.load_state_dict(state_dict)
            self.grid_model.to(self.device).eval()
        # graphs are built on the host, featurization included: on the
        # card each grid's copy back would wait for the in-flight forward
        # and undo the overlap of host and device work
        self.builder = GraphBuilder(cfg.graph, cfg.bucket)
        self.node_budget = node_budget
        self.node_buckets = node_buckets
        self.pending: List[Dict] = []
        self.pending_nodes = 0
        # launched-but-unresolved flush generations: per chunk (kind,
        # indices, entries, host tensor, copy-done event)
        self._inflight: List[List[tuple]] = []
        self.inflight_window = 1

    # -- batching ----------------------------------------------------------

    def add_to_batch(self, depth: np.ndarray, uncertainty: np.ndarray,
                     resolution: Tuple[float, float], context=None) -> None:
        valid = np.isfinite(depth) & (np.abs(depth) < 1.0e5)
        h, w = depth.shape
        unc = uncertainty if self.in_channels >= 8 else None
        if (self.use_slab and h <= self.slab_size and w <= self.slab_size
                and min(h, w) >= 2):
            # all its work waits for the flush (slab route)
            n = int(valid.sum())
            self.pending.append({
                "kind": "slab", "depth": np.asarray(depth, np.float32),
                "valid": valid,
                "uncertainty": (None if unc is None
                                else np.asarray(unc, np.float32)),
                "resolution": (float(resolution[0]), float(resolution[1])),
                "shape": depth.shape, "context": context, "num_nodes": n,
            })
            self.pending_nodes += n
            return
        bg = self.builder.build_graph(np.where(valid, depth, np.nan), valid,
                                      unc, resolution)
        g = bg.graph
        n = bg.num_nodes
        self.pending.append({
            "kind": "graph", "x": g.x[:n],
            "edge_index": np.stack([g.edge_src, g.edge_dst])[:, g.edge_mask],
            "edge_attr": g.edge_attr[g.edge_mask],
            "local_std": g.local_std[:n],
            "rows": bg.rows[:n], "cols": bg.cols[:n],
            "shape": depth.shape, "context": context, "num_nodes": n,
        })
        self.pending_nodes += n

    def batch_ready(self) -> bool:
        return self.pending_nodes >= self.node_budget

    def flush_batch(self) -> List[Dict]:
        """Launch one forward generation over all pending grids; returns
        the per-grid results of finished generations (one generation stays
        in flight; :meth:`drain` resolves the rest)."""
        if self.pending:
            gen: List[tuple] = []
            kinds = [p["kind"] for p in self.pending]
            slab_idx = [i for i, k in enumerate(kinds) if k == "slab"]
            graph_idx = [i for i, k in enumerate(kinds) if k == "graph"]
            if slab_idx:
                self._launch_chunks(slab_idx, gen, self._launch_slab_chunk,
                                    self.slab_batch_buckets[-1])
            if graph_idx:
                self._launch_chunks(graph_idx, gen,
                                    self._launch_graphs_chunk)
            self._inflight.append(gen)
            self.pending = []
            self.pending_nodes = 0
        results: List[Dict] = []
        while len(self._inflight) > self.inflight_window:
            results.extend(self._resolve_generation(self._inflight.pop(0)))
        return results

    def drain(self) -> List[Dict]:
        """Flush remaining pending grids and resolve all in-flight work."""
        results = self.flush_batch()
        while self._inflight:
            results.extend(self._resolve_generation(self._inflight.pop(0)))
        return results

    @staticmethod
    def _unpack_forward(packed: np.ndarray) -> Dict[str, np.ndarray]:
        return {
            "classification": packed[:, 0].astype(np.int32),
            "confidence": packed[:, 1].astype(np.float32),
            "correction": packed[:, 2].astype(np.float32),
        }

    def _resolve_generation(self, gen) -> List[Dict]:
        per_idx = {}
        for kind, idxs, entries, host, done in gen:
            if done is not None:
                done.synchronize()
            out = self._unpack_forward(host.numpy())
            offset = 0
            for i, p in zip(idxs, entries):
                n = p["num_nodes"]
                if kind == "slab":
                    rows, cols = np.nonzero(p["valid"])
                else:
                    rows, cols = p["rows"], p["cols"]
                per_idx[i] = self._to_grids(
                    p, out, slice(offset, offset + n), rows, cols)
                offset += n
        return [per_idx[i] for i in sorted(per_idx)]

    @staticmethod
    def _to_grids(p: Dict, out: Dict, sl: slice, rows, cols) -> Dict:
        grids = {}
        for ch in ("classification", "confidence", "correction"):
            arr = np.full(p["shape"], np.nan, np.float32)
            arr[rows, cols] = out[ch][sl]
            grids[ch] = arr
        grids["classification"] = np.nan_to_num(
            grids["classification"], nan=-1).astype(np.int64)
        grids["confidence"] = np.nan_to_num(grids["confidence"])
        grids["correction"] = np.nan_to_num(grids["correction"])
        grids["context"] = p["context"]
        return grids

    def _launch_chunks(self, idx: List[int], gen: List, launch,
                       max_grids: Optional[int] = None) -> None:
        """Pending entries ``idx`` in chunks of at most the largest node
        bucket's nodes (and ``max_grids`` grids), each launched by
        ``launch``."""
        cap = self.node_buckets[-1]
        chunk, chunk_nodes = [], 0
        for i in idx:
            n = self.pending[i]["num_nodes"]
            if chunk and (chunk_nodes + n > cap or len(chunk) == max_grids):
                gen.append(launch(chunk))
                chunk, chunk_nodes = [], 0
            chunk.append(i)
            chunk_nodes += n
        if chunk:
            gen.append(launch(chunk))

    def _copy_back(self, packed: torch.Tensor):
        """(host tensor, copy-done event or None): a non-blocking copy of
        the packed outputs into pinned memory on the card."""
        if not packed.is_cuda:
            return packed, None
        host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done

    @torch.no_grad()
    def _launch_slab_chunk(self, idx: List[int]):
        """Small grids in one slab: host packing and compaction indices,
        one upload, featurization and the forward on the device, and a
        non-blocking copy of the packed outputs (node slots in row-major,
        grid-major order) back."""
        entries = [self.pending[i] for i in idx]
        s = self.slab_size
        with_unc = self.in_channels >= 8
        n_total = sum(p["num_nodes"] for p in entries)
        depth, _, unc, hs, ws, res = pack_slab(
            [(p["depth"], p["valid"], p["uncertainty"], p["resolution"])
             for p in entries], s, len(entries), with_unc,
            implicit_valid=True)
        # the valid cells' flat slab indices, from the host's masks: a
        # nonzero on the device would wait for the in-flight forward
        lin = np.concatenate([
            b * s * s + rows * s + cols for b, (rows, cols) in enumerate(
                np.nonzero(p["valid"]) for p in entries)]).astype(np.int64)
        depth, unc, hs, ws, res, lin = _upload(
            (depth, unc, hs, ws, res, lin), self.device)
        gcfg = self.config.graph
        kw = dict(connectivity=gcfg.connectivity, with_uncertainty=with_unc,
                  stats_window=gcfg.local_stats_window)
        if self.use_grid:
            feats, valid, nbr, eattr, lstd = build_slab_grid_inputs(
                depth, None, unc, hs, ws, res, **kw)
            out = self.grid_model(feats, valid, nbr, eattr)
            packed = _pack_outputs(out, lstd).reshape(-1, 3)[lin]
        else:
            n_pad = round_up_to_bucket(max(n_total, 1), self.node_buckets)
            g, _, _, _ = build_slab_ell(depth, None, unc, hs, ws, res,
                                        n_pad=n_pad, lin=lin, **kw)
            packed = _pack_outputs(self.model(g), g.local_std)[:n_total]
        host, done = self._copy_back(packed)
        logger.debug("slab-launched %d grids (%d nodes)", len(entries),
                     n_total)
        return "slab", idx, entries, host, done

    @torch.no_grad()
    def _launch_graphs_chunk(self, idx: List[int]):
        """Host concat + ELL pack (or the COO tables), one copy to the
        device, one forward, and a non-blocking copy of the packed outputs
        back."""
        entries = [self.pending[i] for i in idx]
        n_total = sum(p["num_nodes"] for p in entries)
        if n_total > self.node_buckets[-1]:
            # a single oversized graph: one-off power-of-two bucket
            n_pad = 1 << (n_total - 1).bit_length()
        else:
            n_pad = round_up_to_bucket(n_total, self.node_buckets)
        gcfg = self.config.graph
        max_deg = self.knn_k or (gcfg.connectivity
                                 + (1 if gcfg.include_self_loops else 0))
        graph, _ = batch_graphs(
            [(p["x"], p["edge_index"], p["edge_attr"]) for p in entries],
            n_pad=n_pad, e_pad=n_pad * max_deg,
            local_std_list=[p["local_std"] for p in entries])
        if self.use_ell:
            ell = coo_to_ell(graph, max_degree=max_deg)
            banded = (band_ell(ell, band_rows=128).to(self.device)
                      if self.sparse_kernel == "banded" else None)
            g = ell.to(self.device)
            out = self.model(g, banded=banded)
        else:
            g = CooGraph.from_padded(graph, src_table=False).to(self.device)
            out = self.model(g)
        packed = _pack_outputs(out, g.local_std)[:n_total]
        host, done = self._copy_back(packed)
        logger.debug("launched %d graphs (%d nodes, bucket %d)",
                     len(entries), n_total, n_pad)
        return "graph", idx, entries, host, done

    def process_grid(self, depth, uncertainty, resolution) -> Dict:
        """Single-grid convenience path."""
        self.add_to_batch(depth, uncertainty, resolution)
        return self.drain()[-1]
