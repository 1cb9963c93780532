"""The device trace of a measured window (``--trace 1``).

``torch.profiler`` records the window (host and CUDA activity); its
timeline is exported and read back for the device's kernels, copies and
sets, and for the harness's own spans (``pb:<name>``, from
``harness.Spans``). The busy time is the union of the device intervals,
so kernels that overlap on streams count once.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Dict, List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union_length(intervals: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def gaps(intervals: List[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The stretches of [lo, hi) that no interval covers."""
    out, cur = [], lo
    for a, b in sorted(intervals):
        if a > cur:
            out.append((cur, min(a, hi)))
        cur = max(cur, b)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


class TraceData:
    """What a window's trace holds: ``device`` [(name, start us, dur us)],
    ``spans`` [(name, start us, dur us)] of the harness, and the window's
    own span."""

    def __init__(self, events: List[Dict]):
        self.device: List[Tuple[str, float, float]] = []
        self.spans: List[Tuple[str, float, float]] = []
        self.window = None
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            if cat in DEVICE_CATS:
                self.device.append((e["name"], ts, dur))
            elif e.get("name", "").startswith("pb:") and cat in (
                    "user_annotation", "cpu_op"):
                name = e["name"][3:]
                if name == "window":
                    self.window = (ts, dur)
                else:
                    self.spans.append((name, ts, dur))
        if self.window is None:
            raise RuntimeError("the trace holds no window span")

    @property
    def window_s(self) -> float:
        return self.window[1] * 1e-6

    def _in_window(self):
        lo, hi = self.window[0], self.window[0] + self.window[1]
        return [(max(t, lo), min(t + d, hi)) for _n, t, d in self.device
                if t + d > lo and t < hi]

    @property
    def busy_s(self) -> float:
        return union_length(self._in_window()) * 1e-6

    def kernels(self, patterns) -> List[Tuple[str, float, float]]:
        """Device kernels whose name holds any of ``patterns``."""
        return [e for e in self.device if any(p in e[0] for p in patterns)]

    def breakdown(self, top: int = 10) -> Dict:
        """The device operations that took most time, and the idle gaps
        summed by the harness span the host was in (the span covering
        most of each gap; ``host:other`` where none does)."""
        by_op: Dict[str, float] = {}
        for n, _t, d in self.device:
            by_op[n] = by_op.get(n, 0.0) + d * 1e-6
        lo, hi = self.window[0], self.window[0] + self.window[1]
        idle: Dict[str, float] = {}
        # the harness's spans follow one another: walk back from the last
        # one that starts before a gap ends to the first that ends before
        # the gap starts
        spans = sorted(self.spans, key=lambda s: s[1])
        starts = [t for _n, t, _d in spans]
        for a, b in gaps(self._in_window(), lo, hi):
            best, cover = "host:other", 0.0
            j = bisect.bisect_left(starts, b) - 1
            while j >= 0:
                n, t, d = spans[j]
                if t + d <= a:
                    break
                c = min(b, t + d) - max(a, t)
                if c > cover:
                    best, cover = f"host:{n}", c
                j -= 1
            idle[best] = idle.get(best, 0.0) + (b - a) * 1e-6
        return {
            "device_ops": [[n, v] for n, v in sorted(
                by_op.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, v] for n, v in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]],
        }


class Profile:
    """A profiler session around the window; ``data`` after it ends."""

    def __init__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._torch = torch
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self.data = None

    def __enter__(self):
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        self._torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.data = TraceData(events)
        return False
