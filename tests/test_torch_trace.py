"""The port's span recorder (``utils/prof``): spans are recorded exactly
while a torch.profiler session runs, at the layer boundaries of the
survey batch, the two train steps and the prefetch thread, with their
parents, threads and work counts; ``device_trace`` writes them beside
its trace on the trace's clock; the store's cap counts what it drops;
``ThroughputMeter``'s clock starts at its first ``add``."""

import json
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bathymetric_gnn_tpu_torch.config.config import Config
from bathymetric_gnn_tpu_torch.inference.pipeline import BathymetricPipeline
from bathymetric_gnn_tpu_torch.models.grid_gat import GridBathymetricGNN
from bathymetric_gnn_tpu_torch.training import datasets as tds
from bathymetric_gnn_tpu_torch.training import grid_trainer as tgt
from bathymetric_gnn_tpu_torch.training import trainer as ttr
from bathymetric_gnn_tpu_torch.utils import prof
from bathymetric_gnn_tpu_torch.utils.prefetch import prefetch_iterator

from conftest import make_ramp_surface

torch.set_num_threads(2)

MODEL = dict(hidden_channels=16, num_layers=2, heads=2)
SURVEY_CHILDREN = ["pipeline.upload", "pipeline.featurize", "model.layers",
                   "pipeline.heads"]
STEP_CHILDREN = ["train.forward", "train.backward", "train.optimizer"]


@pytest.fixture(autouse=True)
def _tracer_off():
    """Each test starts as a process does: no root span has seen a
    session (a root that finds one begins a new store)."""
    prof.TRACER.end()
    yield


def _config():
    c = Config()
    for k, v in MODEL.items():
        setattr(c.model, k, v)
    c.model.dropout = 0.0
    c.training.batch_size = 2
    c.training.class_weights = (1.2, 0.8, 1.5)
    return c


def _pipeline():
    pipe = BathymetricPipeline(config=_config(), device="cpu")
    pipe.use_state_dict(GridBathymetricGNN(
        7, MODEL["hidden_channels"], MODEL["num_layers"], MODEL["heads"],
        generator=torch.Generator().manual_seed(0)).state_dict())
    return pipe


def _batch():
    d = np.stack([make_ramp_surface(64, 64, seed=s) for s in (1, 2)])
    v = np.ones(d.shape, bool)
    v[0, 10:20, 5:40] = False
    return d, v


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _coo_trainer(tmp_path):
    cfg = _config()
    cfg.bucket.node_buckets = (1024,)
    ds = tds.SyntheticTileDataset([make_ramp_surface(64, 64, seed=3)], cfg,
                                  tile_size=32, overlap=8, seed=5)
    samples = [ds[i] for i in range(len(ds))]

    class Fixed:
        def __len__(self):
            return len(samples)

        def __getitem__(self, i):
            return samples[i]

        def class_counts(self):
            return ds.class_counts()

        def sample_normalized_corrections(self):
            return ds.sample_normalized_corrections()

    tr = ttr.Trainer(cfg, Fixed(), output_dir=str(tmp_path), device="cpu")
    return tr, tr.init_state(samples[0].graph), Fixed()


def _grid_trainer(tmp_path):
    cfg = _config()
    ds = tgt.SyntheticGridDataset([make_ramp_surface(64, 64, seed=4)], cfg,
                                  tile_size=32, overlap=8, seed=1)
    tr = tgt.GridTrainer(cfg, ds, output_dir=str(tmp_path), device="cpu")
    return tr, tr.init_state(), ds


def _by_name(spans):
    out = {}
    for s in spans:
        out.setdefault(s.name, []).append(s)
    return out


def test_nothing_is_recorded_without_a_profiler(tmp_path):
    pipe = _pipeline()
    tr, state, ds = _grid_trainer(tmp_path)
    with _cpu_profile():
        pipe.forward_tiles(*_batch(), None, (1.0, 1.0))
    kept = prof.TRACER.spans
    n = len(kept)
    assert n > 0
    pipe.forward_tiles(*_batch(), None, (1.0, 1.0))
    tr.train_step(state, tgt.collate_grids([ds[0], ds[1]]), 1e-3)
    assert not prof.TRACER.on
    assert prof.TRACER.spans is kept and len(kept) == n
    # off, a span is the shared null context: one branch, nothing kept
    assert prof.TRACER.span("x") is prof.TRACER.span("y")
    with prof.TRACER.span("x") as s:
        assert s is None


def test_forward_tiles_spans_under_a_cpu_profiler():
    pipe = _pipeline()
    d, v = _batch()
    with _cpu_profile():
        pipe.forward_tiles(d, v, None, (1.0, 1.0))
    spans = prof.TRACER.spans
    assert [s.name for s in spans] == SURVEY_CHILDREN + [
        "pipeline.forward_tiles"]
    root = spans[-1]
    assert root.parent is None
    assert root.work == {"tiles": 2, "cells": int(v.sum())}
    me = threading.get_ident()
    for s in spans[:-1]:
        assert s.parent == root.id and s.work == {"tiles": 2}
    for s in spans:
        assert s.thread == me
        assert s.events is None and s.device_ms() is None
    starts = [s.start_ns for s in spans[:-1]]
    assert starts == sorted(starts)
    assert root.start_ns <= starts[0] and spans[-2].end_ns <= root.end_ns


@pytest.mark.parametrize("path", ["grid", "coo"])
def test_train_step_spans(path, tmp_path):
    if path == "grid":
        tr, state, ds = _grid_trainer(tmp_path)
        args = (tgt.collate_grids([ds[0], ds[1]]),)
        work = {"tiles": 2}
    else:
        tr, state, ds = _coo_trainer(tmp_path)
        g, targets, *_ = next(tr._host_batches(ds, shuffle=True))
        args = (g.to("cpu"), ttr._to_device_targets(targets, "cpu"))
        work = {"slots": int(g.node_mask.shape[0])}
    with _cpu_profile():
        tr.train_step(state, *args, 1e-3)
    by = _by_name(prof.TRACER.spans)
    (root,) = by["train.step"]
    assert root.parent is None and root.work == work
    kids = sorted((s for s in prof.TRACER.spans if s.parent == root.id),
                  key=lambda s: s.start_ns)
    assert [s.name for s in kids] == STEP_CHILDREN
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns
    if path == "grid":
        # the grid model's trunk nests in the forward
        (layers,) = by["model.layers"]
        assert layers.parent == kids[0].id


def test_prefetch_thread_spans_follow_the_session(tmp_path):
    tr, state, ds = _coo_trainer(tmp_path)
    seen = {}

    def batches():
        for item in tr._host_batches(ds, shuffle=True):
            seen.setdefault("tid", threading.get_ident())
            yield item

    with prof.device_trace(str(tmp_path / "trace")):
        n = sum(1 for _ in prefetch_iterator(batches()))
    by = _by_name(prof.TRACER.spans)
    assert n >= 2
    assert len(by["train.merge"]) == len(by["train.from_padded"]) == n
    for s in by["train.merge"] + by["train.from_padded"]:
        assert s.thread == seen["tid"] != threading.get_ident()
        assert s.parent is None and s.work["tiles"] == 2
    assert all(s.work["edges"] > 0 for s in by["train.from_padded"])
    kept = len(prof.TRACER.spans)
    assert sum(1 for _ in prefetch_iterator(batches())) == n
    assert len(prof.TRACER.spans) == kept


def test_store_cap_counts_what_it_drops():
    sw = prof.Stopwatch(cap=3)
    sw.begin()
    for i in range(5):
        with sw.span(f"s{i}"):
            pass
    sw.end()
    assert [s.name for s in sw.spans] == ["s0", "s1", "s2"]
    assert sw.counters == {"spans_dropped": 2}
    with sw.span("late"):
        pass
    assert len(sw.spans) == 3 and sw.counters["spans_dropped"] == 2
    sw.begin()
    assert sw.spans == [] and sw.counters["spans_dropped"] == 0


def test_store_counts_every_span_of_many_threads():
    """Threads recording at once into a capped store: every span is kept
    or counted as dropped, and the store holds exactly its cap."""
    import sys

    sw = prof.Stopwatch(cap=500)
    sw.begin()
    n_threads, each = 16, 100
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _cpu_profile():
            def work():
                for _ in range(each):
                    with sw.span("t"):
                        pass

            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(sw.spans) == 500
    assert len(sw.spans) + sw.counters["spans_dropped"] == n_threads * each


def test_nested_spans_follow_the_last_root():
    sw = prof.Stopwatch()
    with _cpu_profile():
        with sw.root("r") as r:
            with sw.span("a") as a:
                pass
    assert a.parent == r.id and sw.on
    with sw.root("r2"):
        with sw.span("b"):
            pass
    assert not sw.on and [s.name for s in sw.spans] == ["a", "r"]


def test_device_trace_writes_spans_on_the_traces_clock(tmp_path):
    pipe = _pipeline()
    out = tmp_path / "trace"
    with prof.device_trace(str(out)):
        for _ in range(3):
            pipe.forward_tiles(*_batch(), None, (1.0, 1.0))
    rec = json.loads((out / prof.SPANS_FILE).read_text())
    events = json.loads((out / prof.TRACE_FILE).read_text())["traceEvents"]
    assert rec["counters"] == {"spans_dropped": 0}
    assert len(rec["spans"]) == 3 * 5
    me = threading.get_ident()
    marks = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            marks.setdefault(e["name"], []).append(e)
    seen, off = {}, []
    for s in rec["spans"]:
        assert s["tid"] == me and s["device_ms"] is None
        i = seen[s["name"]] = seen.get(s["name"], -1) + 1
        e = sorted(marks[s["name"]], key=lambda e: e["ts"])[i]
        off.append(max(abs(s["ts"] - e["ts"]),
                       abs(s["ts"] + s["dur"] - e["ts"] - e["dur"])))
    # a span's host stamps and the profiler's are a few us apart; a
    # thread descheduled between the two (a loaded test machine) moves
    # one span, a wrong clock offset would move them all
    off.sort()
    assert off[len(off) // 2] < 25 and off[-2] < 50, off


def test_throughput_meter_clock_starts_at_the_first_add():
    m = prof.ThroughputMeter()
    time.sleep(0.2)           # set-up: not in the rates
    m.add(edges=100, nodes=10, tiles=1)
    assert m.rates()["tiles_per_s"] == 0.0
    time.sleep(0.05)
    m.add(edges=100, nodes=10, tiles=2)
    r = m.rates()
    assert 0.05 <= r["elapsed_s"] < 0.2 + 0.05
    assert r["tiles_per_s"] == pytest.approx(2 / r["elapsed_s"], rel=0.2)
    assert r["tiles_per_s"] > 2 / 0.25
