"""Reading a window's trace: busy time as a union, idle gaps by the
host's span, and the launch-count cross-check of the roofline shares."""

import json
import os

import pytest

from portbench import trace
from portbench.roofline import h100, readers

DATA = os.path.join(os.path.dirname(__file__), "data")


def _ev(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _synthetic():
    return trace.TraceData([
        _ev("pb:window", 0, 100, "user_annotation"),
        _ev("pb:stack", 0, 10, "user_annotation"),
        _ev("pb:forward_tiles", 10, 5, "user_annotation"),
        _ev("pb:to_host", 60, 30, "user_annotation"),
        _ev("void grid_gat_fwd_kernel<float, 4>", 12, 20),
        _ev("void grid_gat_fwd_kernel<float, 4>", 30, 10),   # overlaps
        _ev("Memcpy DtoH", 70, 10, "gpu_memcpy"),
        _ev("elementwise", 95, 20),                        # past the end
    ])


def test_busy_is_a_union():
    t = _synthetic()
    assert t.window_s == pytest.approx(100e-6)
    # [12, 40) + [70, 80) + [95, 100): 28 + 10 + 5
    assert t.busy_s == pytest.approx(43e-6)


def test_idle_gaps_by_host_span():
    b = _synthetic().breakdown()
    idle = dict(b["idle_gaps"])
    # a gap goes whole to the span that covers most of it: [0, 12) to the
    # stack (10 of its 12 us), [40, 70) and [80, 95) to the copy
    assert idle == pytest.approx({"host:stack": 12e-6,
                                  "host:to_host": 45e-6})
    ops = dict(b["device_ops"])
    assert ops["void grid_gat_fwd_kernel<float, 4>"] == pytest.approx(30e-6)


def _ctx(t, calls):
    return {"trace": t, "result": {"kernel_calls": {"k": calls}}}


def test_roofline_checks_the_launch_count():
    t = _synthetic()
    d = dict(b=1, h=8, w=8, f=4, hc=8, heads=2, k=8, dtype="float32")
    key = json.dumps(d, sort_keys=True)
    share = readers.kernel_roofline(
        _ctx(t, {key: 2}), "k", ("grid_gat_fwd_kernel",), 1,
        lambda x: h100.gat_infer_bound(x)[0])
    assert share == pytest.approx(
        100 * 2 * h100.gat_infer_bound(d)[0] / 0.030)
    with pytest.raises(RuntimeError, match="lost or added"):
        readers.kernel_roofline(
            _ctx(t, {key: 3}), "k", ("grid_gat_fwd_kernel",), 1,
            lambda x: h100.gat_infer_bound(x)[0])
    assert readers.kernel_roofline(_ctx(t, {}), "k", ("x",), 1,
                                   lambda x: 1.0) is None


@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(DATA) if f.endswith(".json")) if os.path.isdir(
        DATA) else [])
def test_recorded_trace(name):
    """A window recorded on the card (its kernels, copies and the
    harness's spans, ``data/<cell>.json`` with the calls the window
    made): every expected launch is there, the shares stay within
    100 %."""
    with open(os.path.join(DATA, name)) as f:
        rec = json.load(f)
    t = trace.TraceData(rec["events"])
    assert 0 < t.busy_s <= t.window_s
    b = t.breakdown()
    assert b["device_ops"] and len(b["device_ops"]) <= 10
    for metric in rec["rooflines"]:
        from portbench import harness

        mod = harness.load_module(harness.HERE / "metrics"
                                  / f"{metric}.py")
        share = mod.read({"trace": t, "result": rec["result"]})
        assert 0 < share <= 100
