"""Native VR BAG inference: bucketed batching of refinement graphs (port of
``bathymetric_gnn_tpu/inference/native_vr.py``, its k-NN graph path).

Thousands of small refinement grids (3x3..50x50) are turned into k-NN
graphs on the host (``data/graph_build``, featurization included),
packed into padded ELL batches under a node budget, run through
``EllBathymetricGNN`` in one forward per chunk of at most the largest node
bucket, and un-batched back onto their grids. On the card every GAT layer
runs kernel C (``sparse_kernel`` "auto" resolves to "banded_pallas" for a
k-NN GAT model, as on the TPU), or with ``sparse_kernel="banded"`` kernel
E and the spill fold, over each chunk's band/spill decomposition
(``ops/ell_banded.band_ell``, 128-row bands, built on the host beside the
graph); on the CPU (only when asked for with ``device="cpu"``) the
kernels' plain versions run.

One flush generation stays in flight: a flush launches its chunks on the
device and starts non-blocking copies of the packed f16 outputs to pinned
host memory, and its results are taken one flush later, in input order
(``drain`` takes the rest), so host-side graph building of the next batch
overlaps the device's work.

Not ported: the default route for ``knn_k == 0`` (slabs through the dense
grid model, large grids through grid-connectivity graphs); it raises.
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config.config import Config
from ..config.constants import CORRECTION_NORM_FLOOR
from ..data.graph_build import GraphBuilder
from ..models.gnn_ell import make_ell_model
from ..ops.ell import coo_to_ell
from ..ops.ell_banded import band_ell
from ..ops.graph import batch_graphs, round_up_to_bucket
from ..utils.weights import coo_state_dict
from .pipeline import infer_in_channels, resolve_device

logger = logging.getLogger(__name__)

DEFAULT_ROUTE_NOT_PORTED = (
    "native VR inference with graph.knn_k == 0 (slabs through the dense "
    "grid model, grid-connectivity graphs for large grids) is not ported "
    "to the PyTorch port yet (ROADMAP.md, next slices: 'default VR "
    "route'); pass --knn-k 8")


class NativeVRProcessor:
    """Batches refinement grids into single sparse forward passes.

    ``state_dict``: the port's (grid-named) weights; the model's widths
    come from ``config.model``. ``device=None`` means the card and raises
    without one; ``"cpu"`` runs the plain versions of the kernels.
    """

    def __init__(
        self,
        state_dict: Dict[str, torch.Tensor],
        config: Optional[Config] = None,
        node_budget: int = 50000,
        node_buckets: Tuple[int, ...] = (1024, 4096, 16384, 65536, 131072),
        device=None,
    ):
        self.config = cfg = config or Config()
        self.knn_k = int(cfg.graph.knn_k)
        if self.knn_k <= 0:
            raise NotImplementedError(DEFAULT_ROUTE_NOT_PORTED)
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        sk = cfg.model.sparse_kernel
        if sk == "auto":
            sk = "banded_pallas" if cfg.model.gnn_type == "GAT" else "xla"
        self.sparse_kernel = sk
        self.in_channels = infer_in_channels(state_dict)
        self.model = make_ell_model(cfg.model, self.in_channels, edge_dim=3,
                                    sparse_kernel=sk)
        self.model.load_state_dict(coo_state_dict(state_dict))
        self.model.to(self.device).eval()
        # graphs are built on the host, featurization included: on the
        # card each small grid's copy back would wait for the in-flight
        # forward and undo the overlap of host and device work
        self.builder = GraphBuilder(cfg.graph, cfg.bucket)
        self.node_budget = node_budget
        self.node_buckets = node_buckets
        self.pending: List[Dict] = []
        self.pending_nodes = 0
        # launched-but-unresolved flush generations: per chunk (indices,
        # entries, host tensor, copy-done event)
        self._inflight: List[List[tuple]] = []
        self.inflight_window = 1

    # -- batching ----------------------------------------------------------

    def add_to_batch(self, depth: np.ndarray, uncertainty: np.ndarray,
                     resolution: Tuple[float, float], context=None) -> None:
        valid = np.isfinite(depth) & (np.abs(depth) < 1.0e5)
        bg = self.builder.build_graph(
            np.where(valid, depth, np.nan), valid,
            uncertainty if self.in_channels >= 8 else None, resolution)
        g = bg.graph
        n = bg.num_nodes
        self.pending.append({
            "x": g.x[:n],
            "edge_index": np.stack([g.edge_src, g.edge_dst])[:, g.edge_mask],
            "edge_attr": g.edge_attr[g.edge_mask],
            "local_std": g.local_std[:n],
            "rows": bg.rows[:n], "cols": bg.cols[:n],
            "shape": depth.shape, "context": context,
        })
        self.pending_nodes += n

    def batch_ready(self) -> bool:
        return self.pending_nodes >= self.node_budget

    def flush_batch(self) -> List[Dict]:
        """Launch one forward generation over all pending graphs; returns
        the per-grid results of finished generations (one generation stays
        in flight; :meth:`drain` resolves the rest)."""
        if self.pending:
            gen: List[tuple] = []
            self._launch_graphs(list(range(len(self.pending))), gen)
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
        for idxs, entries, host, done in gen:
            if done is not None:
                done.synchronize()
            out = self._unpack_forward(host.numpy())
            offset = 0
            for i, p in zip(idxs, entries):
                n = len(p["rows"])
                per_idx[i] = self._to_grids(
                    p, out, slice(offset, offset + n), p["rows"], p["cols"])
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

    def _launch_graphs(self, idx: List[int], gen: List) -> None:
        """Pending graphs in chunks of at most the largest node bucket."""
        cap = self.node_buckets[-1]
        chunk, chunk_nodes = [], 0
        for i in idx:
            n = len(self.pending[i]["rows"])
            if chunk and chunk_nodes + n > cap:
                gen.append(self._launch_graphs_chunk(chunk))
                chunk, chunk_nodes = [], 0
            chunk.append(i)
            chunk_nodes += n
        if chunk:
            gen.append(self._launch_graphs_chunk(chunk))

    @torch.no_grad()
    def _launch_graphs_chunk(self, idx: List[int]):
        """Host concat + ELL pack, one copy to the device, one forward, and
        a non-blocking copy of the packed outputs back."""
        entries = [self.pending[i] for i in idx]
        n_total = sum(len(p["rows"]) for p in entries)
        if n_total > self.node_buckets[-1]:
            # a single oversized graph: one-off power-of-two bucket
            n_pad = 1 << (n_total - 1).bit_length()
        else:
            n_pad = round_up_to_bucket(n_total, self.node_buckets)
        graph, _ = batch_graphs(
            [(p["x"], p["edge_index"], p["edge_attr"]) for p in entries],
            n_pad=n_pad, e_pad=n_pad * self.knn_k,
            local_std_list=[p["local_std"] for p in entries])
        ell = coo_to_ell(graph, max_degree=self.knn_k)
        banded = (band_ell(ell, band_rows=128).to(self.device)
                  if self.sparse_kernel == "banded" else None)
        g = ell.to(self.device)
        out = self.model(g, banded=banded)
        corr = out.get("correction")
        if corr is None:
            corr = torch.zeros_like(out["confidence"])
        else:
            corr = corr * g.local_std.clamp_min(CORRECTION_NORM_FLOOR)
        # one packed f16 copy per chunk: classes {0, 1, 2} are exact in
        # f16; confidence and correction round to f16, as in the JAX path
        packed = torch.stack([out["predicted_class"].to(torch.float16),
                              out["confidence"].to(torch.float16),
                              corr.to(torch.float16)], dim=-1)[:n_total]
        done = None
        if packed.is_cuda:
            host = torch.empty(packed.shape, dtype=packed.dtype,
                               pin_memory=True)
            host.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host = packed
        logger.debug("launched %d graphs (%d nodes, bucket %d)",
                     len(entries), n_total, n_pad)
        return idx, entries, host, done

    def process_grid(self, depth, uncertainty, resolution) -> Dict:
        """Single-grid convenience path."""
        self.add_to_batch(depth, uncertainty, resolution)
        return self.drain()[-1]
