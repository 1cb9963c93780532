"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, loading them, the host-side spans, and the checks a
run makes on its own process.

A cell names a configuration (``configs/<config>.json``) and a traffic
mix (``traffic/<traffic>.json``); the mix names the driver that runs it
(``drivers/<driver>.py``: set-up, the measured window, the comparison
with the reference); each per-layer metric is read by
``metrics/<metric>.py``. A later change adds a cell, a mix or a metric as
new files and entries, without editing these.
"""

from __future__ import annotations

import importlib.util
import json
import sys
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# Top-level module names that may not be loaded in a run's process: JAX,
# its libraries and the JAX package the port was made from. Compared
# whole: the port's own name only begins with the last one.
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax",
                     "bathymetric_gnn_tpu")


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names among ``modules`` (default: what
    ``sys.modules`` holds now)."""
    names = sys.modules if modules is None else modules
    tops = {str(n).split(".", 1)[0] for n in names}
    return sorted(t for t in tops if t in FORBIDDEN_MODULES)


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: Optional[str] = None):
    """Import the Python file ``path`` (its name may hold dots)."""
    name = name or "portbench_" + path.stem.replace(".", "_").replace(
        "-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with its configuration, its traffic mix
    and the metrics ``BENCHMARK.json`` asks of it."""

    def __init__(self, name: str, bench: Dict, base: Path = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        self.base = base
        cfg_entry = {c["name"]: c for c in bench["configs"]}[
            self.entry["config"]]
        self.config = load_json(base.parent / cfg_entry["file"])
        self.traffic = load_json(base / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in reported]

    def driver(self):
        return load_module(self.base / "drivers"
                           / f"{self.traffic['driver']}.py")

    def metric_reader(self, metric: str):
        return load_module(self.base / "metrics" / f"{metric}.py")


class Spans:
    """Host-clock spans of the harness around its calls into the
    program, by name, kept in memory; each also marks the profiler's
    timeline (``record_function``) when a trace is taken."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}
        self._record = None

    def tracing(self, on: bool):
        if on:
            from torch.profiler import record_function
            self._record = record_function
        else:
            self._record = None

    @contextmanager
    def span(self, name: str):
        rec = self._record(f"pb:{name}") if self._record else None
        if rec is not None:
            rec.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times.setdefault(name, []).append(time.perf_counter() - t0)
            if rec is not None:
                rec.__exit__(None, None, None)


def port_config(cfg: Dict, seed: int = 0):
    """The program's ``Config`` holding a configuration file's model,
    graph, tile and training settings, its training seed ``seed``."""
    from bathymetric_gnn_tpu_torch.config.config import Config

    c = Config()
    for k, v in cfg["model"].items():
        setattr(c.model, k, v)
    for k in ("connectivity", "include_self_loops", "knn_k",
              "local_stats_window"):
        setattr(c.graph, k, cfg["graph"][k])
    for k, v in cfg["tile"].items():
        setattr(c.tile, k, v)
    for k, v in cfg["training"].items():
        setattr(c.training, k, v)
    c.training.seed = int(seed)
    return c


def reservoir(rng, keep: int):
    """A seeded reservoir sampler of ``keep`` items from a stream of
    unknown length: ``offer(make)`` calls ``make()`` only for the items it
    keeps; ``items`` holds them in the stream's order."""

    class _R:
        def __init__(self):
            self.slots: Dict[int, object] = {}
            self.seen = 0

        def offer(self, make):
            i = self.seen
            self.seen += 1
            if len(self.slots) < keep:
                self.slots[i] = make()
                return
            j = int(rng.integers(0, i + 1))
            if j < keep:
                drop = sorted(self.slots)[j]
                del self.slots[drop]
                self.slots[i] = make()

        @property
        def items(self):
            return [self.slots[i] for i in sorted(self.slots)]

    return _R()
