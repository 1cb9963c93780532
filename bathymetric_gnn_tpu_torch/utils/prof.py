"""Profiling and throughput instrumentation (port of
``bathymetric_gnn_tpu/utils/prof.py``).

``Stopwatch`` accumulates named wall-clock totals (``time``, ``summary``)
and is the program's span recorder: ``TRACER``, the module's one
instance, keeps the spans the program opens at its layer boundaries
(``TRACER.root``, ``TRACER.span``) while a ``torch.profiler`` session
runs, and nothing otherwise. ``device_trace`` is its exporter: a
torch.profiler trace of a block (host ops, and the card's kernels when
CUDA is available) as ``trace.json``, and beside it the block's program
spans on the trace's clock as ``spans.json``. The trainer counts edges,
nodes and tiles per epoch (``ThroughputMeter``) and appends one JSON
line per epoch to ``metrics.jsonl`` (``MetricsLogger``); wandb attaches
only when it is installed and a project is named.

The spans, by where the program opens them (parent in brackets):

- ``pipeline.forward_tiles`` (a root): ``BathymetricPipeline.
  forward_tiles``, one batch of tiles; work: ``tiles``, valid ``cells``;
- ``pipeline.upload``, ``pipeline.featurize``, ``model.layers``,
  ``pipeline.heads`` (``pipeline.forward_tiles``): the batch's three
  host->device copies; ``build_grid_inputs``; the MLP extractor and the
  GAT layers (``GridBathymetricGNN.trunk``); the three heads, the
  correction's scaling and the f16 packing. The last three also time the
  stream between their first and last launch with a pair of CUDA events
  (``Span.device_ms``; any idle inside the stage counts in it);
- ``pipeline.stack``, ``pipeline.to_host``, ``pipeline.merge``:
  ``process``'s stacking of a batch, its packed result's copy to the host
  and its stitching;
- ``train.step`` (a root): ``GridTrainer.train_step`` and
  ``Trainer.train_step``; work: ``tiles`` (grid) or node ``slots`` (COO);
- ``train.forward``, ``train.backward``, ``train.optimizer``
  (``train.step``): the loss function (inputs to the card, featurization
  on the grid path, the model, the losses); ``backward()``; clipping and
  AdamW;
- ``train.collate`` (the grid trainer's prefetch thread): the batch's
  tiles read and stacked; work: ``tiles``;
- ``train.merge``, ``train.from_padded`` (the graph trainer's prefetch
  thread): ``merge_stacked`` and ``CooGraph.from_padded``; work:
  ``tiles``, live ``edges``.

A root span looks once whether a profiler session runs
(``torch.autograd._profiler_enabled``) and nested spans follow what the
last root saw; spans on other threads (the prefetch thread) follow it
too, while the session still runs. A span on the root's thread also
opens a ``record_function`` of its name, so it sits on the profiler's
timeline. No span synchronizes the card or reads a tensor. The store
keeps at most ``cap`` spans a session and counts the rest
(``counters["spans_dropped"]``). The program adds its own counts to
``counters`` (``count``) while spans are recorded:
``optim.multi_tensor_leaves`` and ``optim.per_leaf_leaves``, the leaves
each AdamW step updated by multi-tensor launches and alone
(``training/optim``).
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import threading
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple

import torch

logger = logging.getLogger(__name__)

TRACE_FILE = "trace.json"
SPANS_FILE = "spans.json"
CLOCK_MARK = "prof.clock"


class Span:
    """One recorded span: its name, host start and end
    (``time.perf_counter_ns``), its id, its parent's id (None for a
    span opened outside any other on its thread), its thread, its work
    counts and, for a stage timed on the card, its pair of CUDA events."""

    __slots__ = ("name", "start_ns", "end_ns", "id", "parent", "thread",
                 "work", "events")

    def __init__(self, name: str, sid: int, parent: Optional[int],
                 thread: int, work: Optional[Dict[str, int]]):
        self.name, self.id, self.parent = name, sid, parent
        self.thread, self.work = thread, work
        self.start_ns = self.end_ns = 0
        self.events = None

    def device_ms(self) -> Optional[float]:
        """Stream time from the span's first launch to its last, in ms
        (None when it was not timed on the card). Read only after the
        card has finished the span's work (``torch.cuda.synchronize``)."""
        if self.events is None:
            return None
        return self.events[0].elapsed_time(self.events[1])


class _Open:
    """The context of one recorded span."""

    __slots__ = ("sw", "span", "stream", "rf")

    def __init__(self, sw: "Stopwatch", span: Span, stream):
        self.sw, self.span, self.stream, self.rf = sw, span, stream, None

    def __enter__(self) -> Span:
        s = self.span
        self.sw._stack().append(s)
        if self.stream is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
            s.events = (ev, None)
        s.start_ns = time.perf_counter_ns()
        if s.thread == self.sw._root_thread:
            # the profiler stamps the range's start halfway through
            # __enter__ (the host stamp is taken there too), its end
            # at the end of __exit__
            self.rf = torch.profiler.record_function(s.name)
            self.rf.__enter__()
            s.start_ns = (s.start_ns + time.perf_counter_ns()) // 2
        return s

    def __exit__(self, *exc) -> bool:
        s = self.span
        if s.events is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(self.stream)
            s.events = (s.events[0], ev)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        s.end_ns = time.perf_counter_ns()
        self.sw._stack().pop()
        self.sw._keep(s)
        return False


_OFF = contextlib.nullcontext()


def _session_running() -> bool:
    """Whether a profiler session runs, as any thread sees it (the
    profiler's own process-wide flag; ``_profiler_enabled`` answers only
    for the threads that the session saw)."""
    return getattr(torch.autograd.profiler, "_is_profiler_enabled", True)


class Stopwatch:
    """Accumulating named stopwatch (``time``, ``summary``), and the
    program's span recorder (``root``, ``span``, ``spans``,
    ``counters``): see the module's docstring."""

    def __init__(self, cap: int = 100_000):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self.cap = cap
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {"spans_dropped": 0}
        self.on = False
        self._root_thread: Optional[int] = None
        self._ids = itertools.count()
        self._local = threading.local()
        self._lock = threading.Lock()

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

    # -- spans -------------------------------------------------------------

    def begin(self) -> None:
        """Start a session on this thread: the store is emptied and spans
        are recorded until a root span finds no profiler (or ``end``)."""
        self.spans = []
        self.counters = {"spans_dropped": 0}
        self._root_thread = threading.get_ident()
        self.on = True

    def end(self) -> None:
        """End the session: nothing is recorded until a root span sees a
        profiler again."""
        self.on = False

    def root(self, name: str, work: Optional[Dict[str, int]] = None,
             stream=None):
        """A span that first looks whether a profiler session runs; a
        session newly seen begins a new store."""
        on = torch.autograd._profiler_enabled()
        if on and (not self.on
                   or self._root_thread != threading.get_ident()):
            self.begin()
        self.on = on
        return self.span(name, work, stream) if on else _OFF

    def span(self, name: str, work: Optional[Dict[str, int]] = None,
             stream=None):
        """A span recorded when the last root span saw a profiler session
        (on another thread than the root's, only while it still runs).
        ``work``: its counts (the recorded ``Span`` that ``with`` gives
        can take more). ``stream``: the device whose current stream the
        span's CUDA events time (only a CUDA device is timed). Off, it is
        the shared null context and gives None."""
        if not self.on:
            return _OFF
        tid = threading.get_ident()
        if tid != self._root_thread and not _session_running():
            return _OFF
        stack = self._stack()
        parent = stack[-1].id if stack else None
        s = Span(name, next(self._ids), parent, tid, work)
        if stream is not None and torch.device(stream).type == "cuda":
            stream = torch.cuda.current_stream(stream)
        else:
            stream = None
        return _Open(self, s, stream)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to ``counters[name]`` while spans are recorded (the
        last root span saw a profiler session)."""
        if self.on:
            with self._lock:
                self.counters[name] = self.counters.get(name, 0) + n

    def _stack(self) -> List[Span]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _keep(self, s: Span) -> None:
        with self._lock:     # the prefetch thread keeps spans too
            if len(self.spans) < self.cap:
                self.spans.append(s)
            else:
                self.counters["spans_dropped"] += 1


TRACER = Stopwatch()


def _clock_marks(n: int = 5) -> List[Tuple[int, int]]:
    """Open and close ``n`` ``record_function`` ranges named
    ``CLOCK_MARK`` (after one to warm the path); for each, how long its
    ``__enter__`` took and the perf-counter time halfway through it,
    where the profiler stamps its start (ns)."""
    with torch.profiler.record_function(CLOCK_MARK):
        pass
    marks = []
    for _ in range(n):
        rf = torch.profiler.record_function(CLOCK_MARK)
        a = time.perf_counter_ns()
        rf.__enter__()
        b = time.perf_counter_ns()
        rf.__exit__(None, None, None)
        marks.append((b - a, (a + b) // 2))
    return marks


def _clock_offset_us(marks: List[Tuple[int, int]],
                     events: List[Dict]) -> float:
    """The trace's clock minus the perf counter's, in us, from the mark
    whose ``__enter__`` took least."""
    ts = sorted(float(e["ts"]) for e in events
                if e.get("name") == CLOCK_MARK and e.get("ph") == "X")
    ts = ts[-len(marks):]
    i = min(range(len(marks)), key=lambda k: marks[k][0])
    return ts[i] - marks[i][1] / 1e3


def export_spans(spans: List[Span], counters: Dict[str, int],
                 offset_us: float, path: Path) -> None:
    """``spans`` as JSON: each with ``ts`` and ``dur`` in us on the clock
    whose time is the perf counter's (in us) plus ``offset_us``, and its
    ``device_ms`` (resolved here: the card must have finished)."""
    out = [{"name": s.name, "ts": s.start_ns / 1e3 + offset_us,
            "dur": (s.end_ns - s.start_ns) / 1e3, "id": s.id,
            "parent": s.parent, "tid": s.thread, "work": s.work,
            "device_ms": s.device_ms()} for s in spans]
    with open(path, "w") as f:
        json.dump({"spans": out, "counters": counters}, f)


@contextlib.contextmanager
def device_trace(trace_dir: Optional[str]) -> Iterator[None]:
    """Capture a torch.profiler trace of the block into
    ``trace_dir/trace.json`` (Chrome trace format: Perfetto or
    chrome://tracing), and the program's spans of the block into
    ``trace_dir/spans.json`` on the same clock; a no-op when
    ``trace_dir`` is empty. The card's kernels are recorded when CUDA is
    available, the host ops always."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    out = Path(trace_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        TRACER.begin()
        marks = _clock_marks()
        try:
            yield
        finally:
            TRACER.end()
    if cuda:
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / TRACE_FILE))
    with open(out / TRACE_FILE) as f:
        events = json.load(f).get("traceEvents", [])
    export_spans(TRACER.spans, TRACER.counters,
                 _clock_offset_us(marks, events), out / SPANS_FILE)
    logger.info("profiler trace and spans written to %s", out)


class ThroughputMeter:
    """Tracks edges/s, nodes/s and tiles/s over a run. The clock starts
    at the first ``add``, which opens the run: its own counts fall before
    the clock and are not in the rates, so that set-up and the first
    step's warm-up count in neither."""

    def __init__(self):
        self.edges = 0
        self.nodes = 0
        self.tiles = 0
        self.t0: Optional[float] = None

    def add(self, edges: int = 0, nodes: int = 0, tiles: int = 0):
        if self.t0 is None:
            self.t0 = time.perf_counter()
            return
        self.edges += edges
        self.nodes += nodes
        self.tiles += tiles

    def rates(self) -> Dict[str, float]:
        t0 = time.perf_counter() if self.t0 is None else self.t0
        dt = max(time.perf_counter() - t0, 1e-9)
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
