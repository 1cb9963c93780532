"""Throughput and metrics logging (port of ``ThroughputMeter`` and
``MetricsLogger`` from ``bathymetric_gnn_tpu/utils/prof.py``).

The trainer counts edges, nodes and tiles per epoch and appends one JSON
line per epoch to ``metrics.jsonl``; wandb attaches only when it is
installed and a project is named.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class ThroughputMeter:
    """Tracks edges/s, nodes/s and tiles/s over a run."""

    def __init__(self):
        self.edges = 0
        self.nodes = 0
        self.tiles = 0
        self.t0 = time.perf_counter()

    def add(self, edges: int = 0, nodes: int = 0, tiles: int = 0):
        self.edges += edges
        self.nodes += nodes
        self.tiles += tiles

    def rates(self) -> Dict[str, float]:
        dt = max(time.perf_counter() - self.t0, 1e-9)
        return {
            "edges_per_s": round(self.edges / dt, 1),
            "nodes_per_s": round(self.nodes / dt, 1),
            "tiles_per_s": round(self.tiles / dt, 3),
            "elapsed_s": round(dt, 2),
        }


class MetricsLogger:
    """JSONL metrics stream (+ wandb when installed and a project is
    given)."""

    def __init__(self, path: Optional[str] = None,
                 wandb_project: Optional[str] = None):
        self.path = Path(path) if path else None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
        self._wandb = None
        if wandb_project:
            try:
                import wandb  # type: ignore

                self._wandb = wandb.init(project=wandb_project)
            except Exception:
                logger.info("wandb unavailable; JSONL metrics only")

    def log(self, step: int, metrics: Dict):
        rec = {"step": step, "time": time.time(), **metrics}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def close(self):
        if self._wandb is not None:
            self._wandb.finish()
