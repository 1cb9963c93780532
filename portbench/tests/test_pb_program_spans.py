"""The program's spans read against a window's trace: alignment by the
root spans' ends, the idle gaps given to the program span the host was
in, the builds off the step's thread, the raises; and each new reader on
a CPU run of its cell."""

import pytest
import torch

from portbench import harness, program_spans as ps, trace
from portbench.tests.cpu_cells import TINY
from portbench.tests.test_pb_contract import BENCH

NEW = {"upload_ms.survey", "featurize_device_ms.survey",
       "layers_device_ms.survey", "heads_device_ms.survey",
       "idle_forward.train", "idle_backward.train", "idle_optimizer.train",
       "batch_build_ms.train"}
OFFSET_US = 5000.0     # the trace's clock minus the perf counter's


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


class _Tracer:
    def __init__(self, spans, dropped=0):
        self.spans = spans
        self.counters = {"spans_dropped": dropped}


def _span(name, sid, parent, tid, ts, end, work=None):
    """A program span at [ts, end) on the trace's clock (us)."""
    from bathymetric_gnn_tpu_torch.utils.prof import Span

    s = Span(name, sid, parent, tid, work)
    s.start_ns = int((ts - OFFSET_US) * 1e3)
    s.end_ns = int((end - OFFSET_US) * 1e3)
    return s


def _steps(ends=((100, 398), (500, 798))):
    """Two train steps: forward, backward, optimizer; builds on thread
    2 before the window, inside it, and open when it closes."""
    spans, sid = [], 0
    for a, e in ends:
        root = sid
        for name, x, y in (("train.forward", a + 10, a + 100),
                           ("train.backward", a + 100, a + 200),
                           ("train.optimizer", a + 200, e)):
            sid += 1
            spans.append(_span(name, sid, root, 1, x, y))
        spans.append(_span("train.step", root, None, 1, a + 5, e,
                           {"tiles": 4}))
        sid += 1
    spans.append(_span("train.collate", 100, None, 2, 450, 480))
    spans.append(_span("train.collate", 101, None, 2, -50, -10))
    spans.append(_span("train.collate", 102, None, 2, 990, 1400))
    return spans


def _trace():
    return trace.TraceData([
        _ev("pb:window", 0, 1000, "user_annotation"),
        _ev("pb:train_step", 100, 300, "user_annotation"),
        _ev("pb:train_step", 500, 300, "user_annotation"),
        _ev("k", 100, 50), _ev("k", 210, 50), _ev("k", 320, 10),
        _ev("k", 400, 150), _ev("k", 560, 200),
    ])


def _ctx(steps=2):
    return {"trace": _trace(), "result": {"counts": {"steps": steps}}}


@pytest.fixture
def fake(monkeypatch):
    def use(spans, dropped=0):
        monkeypatch.setattr(ps, "tracer", lambda: _Tracer(spans, dropped))
    return use


def test_alignment_and_idle_by_stage(fake):
    fake(_steps())
    ctx = _ctx()
    al = ps.aligned(ctx, *ps.TRAIN)
    # each step ends 2 us before its harness span, starts 5 us after it
    assert al.offset_us == pytest.approx(OFFSET_US + 2)
    assert al.end_gaps_us == pytest.approx([0.0, 0.0])
    assert al.residual_us == 0.0
    # each step's spans moved 2 us later: they end where the harness's do
    assert [r.end for r in al.roots] == pytest.approx([400, 800])
    gaps = ps.gap_paths(ctx["trace"], al)
    # [0, 100): no program span; [150, 210): the step's, forward 52 us
    # of it, backward 8, the step's own time 0: forward; [260, 320):
    # backward; [330, 400): optimizer; [550, 560): the second forward;
    # [760, 1000): the second optimizer covers 40 us of it, the most
    us = {k: v * 1e6 for k, v in gaps.items()}
    step = "train.step"
    assert us == pytest.approx({
        (): 100.0,
        (step, "train.forward"): 60.0 + 10.0,
        (step, "train.backward"): 60.0,
        (step, "train.optimizer"): 70.0 + 240.0})
    idle = {k: ps.idle_share(ctx, k) for k in
            ("train.forward", "train.backward", "train.optimizer")}
    assert idle == pytest.approx({"train.forward": 7.0,
                                  "train.backward": 6.0,
                                  "train.optimizer": 31.0})
    assert sum(idle.values()) <= 100.0 * (1 - ctx["trace"].busy_s
                                          / ctx["trace"].window_s)
    # the build inside the window, not the one before it nor the one
    # still open when it closes
    assert ps.batch_build_ms(ctx) == pytest.approx(0.030)
    # the graph trainer's builds: a merge and the from_padded after it
    coo = [s for s in _steps() if s.name != "train.collate"] + [
        _span("train.merge", 200, None, 3, 600, 610),
        _span("train.from_padded", 201, None, 3, 612, 650),
        _span("train.merge", 202, None, 3, 980, 990),
        _span("train.from_padded", 203, None, 3, 990, 1300)]
    fake(coo)
    assert ps.batch_build_ms(_ctx()) == pytest.approx(0.048)


def test_count_mismatch_and_stray_offset_raise(fake):
    fake(_steps())
    with pytest.raises(RuntimeError, match="window counted 3 steps"):
        ps.aligned(_ctx(steps=3), *ps.TRAIN)
    # a harness span that starts 400 us after its step's root would under
    # the clocks' offset: the pairs do not fit one offset
    fake(_steps())
    t = trace.TraceData([
        _ev("pb:window", 0, 2000, "user_annotation"),
        _ev("pb:train_step", 100, 300, "user_annotation"),
        _ev("pb:train_step", 900, 300, "user_annotation")])
    with pytest.raises(RuntimeError, match="393.0 us before"):
        ps.aligned({"trace": t, "result": {"counts": {"steps": 2}}},
                   *ps.TRAIN)
    # the end gaps differ (a delayed stamp): the tightest pair sets the
    # offset, and nothing raises
    t = trace.TraceData([
        _ev("pb:window", 0, 2000, "user_annotation"),
        _ev("pb:train_step", 100, 300, "user_annotation"),
        _ev("pb:train_step", 500, 450, "user_annotation")])
    al = ps.aligned({"trace": t, "result": {"counts": {"steps": 2}}},
                    *ps.TRAIN)
    assert al.offset_us == pytest.approx(OFFSET_US + 2)
    assert al.end_gaps_us == pytest.approx([0.0, 150.0])
    fake(_steps(), dropped=1)
    with pytest.raises(RuntimeError, match="dropped 1"):
        ps.aligned(_ctx(), *ps.TRAIN)


def test_no_tracer_reads_nothing(monkeypatch):
    monkeypatch.setattr(ps, "tracer", lambda: None)
    ctx = _ctx()
    for name in sorted(NEW):
        mod = harness.load_module(harness.HERE / "metrics" / f"{name}.py")
        assert mod.read(ctx) is None


@pytest.mark.parametrize("cell", sorted(TINY))
def test_new_readers_on_a_cpu_run(cell, monkeypatch):
    """The cell's window traced on the CPU at a tiny size (the trace has
    no device events there: the window reads all idle) gives every new
    metric of the cell a number."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    c = harness.Cell(cell, BENCH)
    drv = c.driver()
    spans = harness.Spans()
    over = dict(TINY[cell])
    if cell != "survey-f32":
        # epochs of 5 batches (the prefetch thread runs 3 ahead): it
        # builds inside the window once the window's first step has begun
        # the session
        over["tiles_per_side"] = 5 if cell == "grid-train-f32" else [5, 5]
    s = drv.setup(c, 2 ** 33 + 9, "cpu", spans, over)
    try:
        spans.times.clear()
        spans.tracing(True)
        with trace.Profile() as prof:
            with spans.span("window"):
                result = drv.window(s, 0.5 if cell == "survey-f32" else 8.0,
                                    spans)
        spans.tracing(False)
    finally:
        drv.release(s)
    ctx = {"cell": c, "result": result, "spans": spans, "trace": prof.data}
    mine = [m["name"] for m in c.per_layer if m["name"] in NEW]
    assert len(mine) == 4
    got = {n: c.metric_reader(n).read(ctx) for n in mine}
    assert all(isinstance(v, float) and v >= 0 for v in got.values()), got
    key = ("program_spans", ps.SURVEY[0] if cell == "survey-f32"
           else ps.TRAIN[0])
    assert ctx[key].residual_us < ps.MAX_RESIDUAL_US
    if cell != "survey-f32":
        assert got["batch_build_ms.train"] > 0
        idle = c.metric_reader("idle_share.train").read(ctx)
        assert sum(got[f"idle_{k}.train"] for k in (
            "forward", "backward", "optimizer")) <= idle * (1 + 1e-9)
