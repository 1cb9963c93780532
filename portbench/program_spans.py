"""The program's own spans in a traced window.

While a profiler session runs, the program records spans at its layer
boundaries (``bathymetric_gnn_tpu_torch/utils/prof.py``: ``TRACER``, its
host times on ``time.perf_counter_ns``, each with its parent, its thread,
its work counts and, for the survey's stages, a pair of CUDA events). The
trace that ``trace.TraceData`` reads keeps only the harness's spans, so
the readers here take the program's spans from the tracer in memory and
put them on the trace's clock. Each root span (``pipeline.forward_tiles``,
``train.step``) lies inside the harness span around it
(``pb:forward_tiles``, ``pb:train_step``; the two are paired in order of
their ends), so the offset between the clocks lies between the two
spans' start gap and their end gap. The host stamps of a pair lie a few
to a few hundred microseconds apart (the host's own delays between
them), so the offset is the least end gap over the window, the pair
that closed tightest, and every span shifts by it. A reading raises, and
the metric is not printed, when the window's root spans are not as many
as its result counts (``counts``), or when under that offset a root
starts before its harness span by more than ``MAX_RESIDUAL_US`` (the
clocks drifted apart, or the pairs do not match).

A program without the tracer (an older tree) gives None: the metric is
left out of the line.
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from portbench import trace

MAX_RESIDUAL_US = 200.0

# (program root span, harness span around it, the result's count of them)
SURVEY = ("pipeline.forward_tiles", "forward_tiles", "batches")
TRAIN = ("train.step", "train_step", "steps")


def tracer():
    """The program's span recorder, or None where the program has none."""
    try:
        from bathymetric_gnn_tpu_torch.utils import prof
    except ImportError:
        return None
    t = getattr(prof, "TRACER", None)
    return t if hasattr(t, "spans") and hasattr(t, "counters") else None


class Rec:
    """One program span on the trace's clock (us)."""

    __slots__ = ("name", "ts", "end", "id", "parent", "tid", "work", "span",
                 "children")

    def __init__(self, s, offset_us: float):
        self.name, self.id, self.parent = s.name, s.id, s.parent
        self.tid, self.work, self.span = s.thread, s.work, s
        self.ts = s.start_ns / 1e3 + offset_us
        self.end = s.end_ns / 1e3 + offset_us
        self.children: List["Rec"] = []

    @property
    def dur_ms(self) -> float:
        return (self.end - self.ts) * 1e-3


class Aligned:
    """The session's spans on the trace's clock: ``roots`` (in order),
    ``recs`` (every span), ``offset_us`` (the trace's clock minus the
    perf counter's), ``end_gaps_us`` (each root's end to its harness
    span's end, under that offset) and ``residual_us`` (the most a root
    starts before its harness span)."""

    def __init__(self, roots: List[Rec], recs: List[Rec], offset_us: float,
                 end_gaps_us: List[float], residual_us: float,
                 window: Tuple[float, float]):
        self.roots, self.recs, self.offset_us = roots, recs, offset_us
        self.end_gaps_us, self.residual_us = end_gaps_us, residual_us
        self.window = window

    def _children(self, name: str) -> List[Rec]:
        return [c for r in self.roots for c in _descendants(r)
                if c.name == name]

    def mean_ms(self, name: str) -> Optional[float]:
        """Host ms in the spans ``name`` under the roots, a root."""
        got = self._children(name)
        if not got:
            return None
        return sum(c.dur_ms for c in got) / len(self.roots)

    def mean_device_ms(self, name: str) -> Optional[float]:
        """Stream ms between the first and the last launch of the spans
        ``name`` under the roots (their CUDA events), a root. Where a span
        has no events (the program ran on the CPU, whose ops finish before
        the host goes on) its host time stands in."""
        got = self._children(name)
        if not got:
            return None
        total = 0.0
        for c in got:
            dev = c.span.device_ms()
            total += c.dur_ms if dev is None else dev
        return total / len(self.roots)

    def builds_ms(self, first: str, names: Sequence[str]
                  ) -> Optional[float]:
        """Host ms a batch build off the roots' thread: each build is a
        span ``first`` with the spans ``names`` that follow it on its
        thread before the next ``first``; the mean of their summed times
        over the builds that start and end in the window (a build still
        open when the window closes runs on beside whatever follows the
        window). None where no build lies in the window."""
        lo, hi = self.window[0], self.window[0] + self.window[1]
        tid = self.roots[0].tid
        mine = sorted((r for r in self.recs if r.tid != tid
                       and (r.name == first or r.name in names)),
                      key=lambda r: (r.tid, r.ts))
        builds: List[List[Rec]] = []
        for r in mine:
            if r.name == first:
                builds.append([r])
            elif builds:
                builds[-1].append(r)
        got = [sum(r.dur_ms for r in b) for b in builds
               if lo <= b[0].ts and max(r.end for r in b) <= hi]
        return sum(got) / len(got) if got else None


def _descendants(r: Rec):
    for c in r.children:
        yield c
        yield from _descendants(c)


def aligned(ctx, root: str, harness_span: str,
            count_key: str) -> Optional[Aligned]:
    """The program's spans of the traced window aligned to the trace (see
    the module's docstring); None where the program has no tracer."""
    key = ("program_spans", root)
    if key in ctx:
        return ctx[key]
    t = tracer()
    if t is None:
        return None
    if t.counters.get("spans_dropped", 0):
        raise RuntimeError(f"the program's tracer dropped "
                           f"{t.counters['spans_dropped']} spans")
    spans = list(t.spans)
    want = ctx["result"]["counts"].get(count_key, 0)
    roots = sorted((s for s in spans if s.name == root and s.parent is None),
                   key=lambda s: s.end_ns)
    outer = sorted(((ts, dur) for n, ts, dur in ctx["trace"].spans
                    if n == harness_span), key=lambda x: x[0] + x[1])
    if len(roots) != want or len(outer) != want or not want:
        raise RuntimeError(
            f"the window holds {len(roots)} program spans {root!r} and "
            f"{len(outer)} harness spans {harness_span!r}; the window "
            f"counted {want} {count_key}")
    ends = [ts + dur - s.end_ns / 1e3 for s, (ts, dur) in zip(roots, outer)]
    starts = [ts - s.start_ns / 1e3 for s, (ts, dur) in zip(roots, outer)]
    offset = min(ends)
    residual = max(0.0, max(starts) - offset)
    recs = [Rec(s, offset) for s in spans]
    rec_by_id = {r.id: r for r in recs}
    for r in recs:
        if r.parent is not None and r.parent in rec_by_id:
            rec_by_id[r.parent].children.append(r)
    for r in recs:
        r.children.sort(key=lambda c: c.ts)
    out = Aligned([rec_by_id[s.id] for s in roots], recs, offset,
                  [e - offset for e in ends], residual, ctx["trace"].window)
    if residual > MAX_RESIDUAL_US:
        raise RuntimeError(
            f"under the clocks' offset a root span starts {residual:.1f} us "
            f"before the harness span around it (limit {MAX_RESIDUAL_US})")
    ctx[key] = out
    return out


def _cover(r: Rec, a: float, b: float) -> float:
    return max(0.0, min(b, r.end) - max(a, r.ts))


def gap_paths(tdata: trace.TraceData, al: Aligned
              ) -> Dict[Tuple[str, ...], float]:
    """Idle seconds of the window by the program span the host was in:
    each gap with no kernel, copy or set on the card goes to the deepest
    span on the roots' thread that covers most of it (a span's children
    win over it where one of them covers more of the gap than the span's
    own time outside them does). Keyed by the span's path of names from
    its top span; () where no program span covers the gap."""
    tid = al.roots[0].tid
    ids = {r.id for r in al.recs}
    tops = sorted((r for r in al.recs if r.tid == tid and (
        r.parent is None or r.parent not in ids)), key=lambda r: r.ts)
    starts = [r.ts for r in tops]
    lo, hi = tdata.window[0], tdata.window[0] + tdata.window[1]
    out: Dict[Tuple[str, ...], float] = {}
    for a, b in trace.gaps(tdata._in_window(), lo, hi):
        best, cover = None, 0.0
        j = bisect.bisect_left(starts, b) - 1
        while j >= 0:
            r = tops[j]
            c = _cover(r, a, b)
            if c > cover:
                best, cover = r, c
            if r.end <= a:
                break
            j -= 1
        path: Tuple[str, ...] = ()
        node = best
        while node is not None:
            path += (node.name,)
            own = cover - sum(_cover(c, a, b) for c in node.children)
            nxt, ncov = None, 0.0
            for c in node.children:
                cc = _cover(c, a, b)
                if cc > ncov:
                    nxt, ncov = c, cc
            if nxt is None or ncov <= own:
                break
            node, cover = nxt, ncov
        out[path] = out.get(path, 0.0) + (b - a) * 1e-6
    return out


def idle_share(ctx, stage: str) -> Optional[float]:
    """The share of the traced window, in %, idle while the host was in
    the training step's ``stage`` (or a span inside it)."""
    al = aligned(ctx, *TRAIN)
    if al is None:
        return None
    key = ("program_spans", "gaps")
    if key not in ctx:
        ctx[key] = gap_paths(ctx["trace"], al)
    idle = sum(v for p, v in ctx[key].items() if stage in p)
    return 100.0 * idle / ctx["trace"].window_s


def batch_build_ms(ctx) -> Optional[float]:
    """Host ms a training batch is built in the prefetch thread:
    ``train.collate`` (the grid trainer) or ``train.merge`` with the
    ``train.from_padded`` after it (the graph trainer)."""
    al = aligned(ctx, *TRAIN)
    if al is None:
        return None
    got = al.builds_ms("train.collate", ())
    if got is None:
        got = al.builds_ms("train.merge", ("train.from_padded",))
    return got
