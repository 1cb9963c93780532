"""Profiling and throughput instrumentation (port of
``bathymetric_gnn_tpu/utils/prof.py``).

``device_trace`` captures a torch.profiler trace (host ops, and the
card's kernels when CUDA is available) as a Chrome trace; ``Stopwatch``
accumulates named wall-clock spans. The trainer counts edges, nodes and
tiles per epoch (``ThroughputMeter``) and appends one JSON line per epoch
to ``metrics.jsonl`` (``MetricsLogger``); wandb attaches only when it is
installed and a project is named.
"""

from __future__ import annotations

import contextlib
import json
import logging
import time
from pathlib import Path
from typing import Dict, Iterator, Optional

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace of the block into
    ``trace_dir/trace.json`` (Chrome trace format: Perfetto or
    chrome://tracing); a no-op when ``trace_dir`` is empty. The card's
    kernels are recorded when CUDA is available, the host ops always."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(str(out / TRACE_FILE))
    logger.info("profiler trace written to %s", out / TRACE_FILE)


class Stopwatch:
    """Accumulating named stopwatch."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def time(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"total_s": round(v, 4), "count": self.counts[k],
                "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3)}
            for k, v in self.totals.items()
        }


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
