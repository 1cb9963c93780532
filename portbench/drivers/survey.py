"""Survey inference: tiles through ``BathymetricPipeline.forward_tiles``
to packed results on the host, driven as ``process`` drives it.

Set-up makes the survey from the seed, cuts it with the port's
``TileManager``, builds kernel A's library, wires the seeded weights and
warms every batch shape the plan uses. The window cycles the survey: per
pass the full tiles in batches of ``tile_batch`` and any other tile
alone, each batch stacked on the host, handed to ``forward_tiles`` and,
once ``inflight`` later batches are queued, copied to the host in one
piece (closed loop). The window closes at the first dispatch past its
length, after the queue has drained. A seeded sample of the finished
batches is kept for the comparison with the reference.

Traffic parameters (``traffic/<mix>.json``): ``survey`` [h, w],
``tile_batch``, ``inflight``, ``sample_batches``, ``limits``.
"""

from __future__ import annotations

import statistics
import time
import types
from typing import Dict, List

import numpy as np
import torch

from portbench import compare, harness, surface, weights
from portbench.roofline import model_flops
from portbench.reference import gat_grid8 as ref


def setup(cell, seed: int, device, spans: harness.Spans, overrides=None):
    from bathymetric_gnn_tpu_torch.inference.pipeline import \
        BathymetricPipeline

    tr = dict(cell.traffic, **(overrides or {}))
    cfg = dict(cell.config)
    if "tile" in tr:
        cfg["tile"] = dict(cfg["tile"], **tr["tile"])
    s = types.SimpleNamespace()
    s.cfg, s.tr, s.seed, s.device = cfg, tr, seed, torch.device(device)
    s.compile_s = 0.0
    if s.device.type == "cuda":
        from bathymetric_gnn_tpu_torch.ops.cuda import _build

        t0 = time.perf_counter()
        _build.library("grid_gat_fwd")
        s.compile_s = time.perf_counter() - t0
    pipe = BathymetricPipeline(config=harness.port_config(cfg),
                               tile_batch=tr["tile_batch"], device=device)
    h, w = tr["survey"]
    depth = surface.synthetic_survey(h, w, seed, s.device)
    valid = np.isfinite(depth)
    tiles = list(pipe.tm.iterate_tiles(depth, None, valid))
    first = tiles[0]
    s.weights = weights.with_batch_statistics(
        weights.seeded_state_dict(cfg, seed, s.device), cfg,
        torch.from_numpy(np.nan_to_num(first.data)[None]).to(s.device),
        torch.from_numpy(first.valid_mask[None]).to(s.device))
    pipe.use_state_dict({k: v.cpu() for k, v in s.weights.items()})
    s.pipe = pipe
    full = (pipe.tm.tile_size, pipe.tm.tile_size)
    plan: List[List] = []
    pending: List = []
    for t in tiles:
        if pipe.tile_batch > 1 and t.shape == full:
            pending.append(t)
            if len(pending) == pipe.tile_batch:
                plan.append(pending)
                pending = []
        else:
            plan.append([t])
    plan += [[t] for t in pending]
    s.plan = plan
    s.resolution = (1.0, 1.0)
    # warm every shape the plan uses, twice
    shapes = {}
    for i, b in enumerate(plan):
        shapes.setdefault((len(b),) + b[0].shape, i)
    for _ in range(2):
        for i in shapes.values():
            d, v = _stack(plan[i])
            pipe.forward_tiles(d, v, None, s.resolution).cpu()
    if s.device.type == "cuda":
        torch.cuda.synchronize()
    return s


def _stack(batch):
    return (np.stack([np.nan_to_num(t.data) for t in batch]),
            np.stack([t.valid_mask for t in batch]))


def window(s, seconds: float, spans: harness.Spans) -> Dict:
    pipe, plan = s.pipe, s.plan
    rng = np.random.default_rng([s.seed, 1])
    sample = harness.reservoir(rng, s.tr["sample_batches"])
    inflight: list = []
    lat: List[float] = []
    cells = 0
    calls: Dict[str, int] = {}

    def finish():
        nonlocal cells
        i, t_in, res = inflight.pop(0)
        with spans.span("to_host"):
            arr = res.cpu().numpy()
        lat.append(time.perf_counter() - t_in)
        b = plan[i]
        cells += len(b) * b[0].shape[0] * b[0].shape[1]
        sample.offer(lambda: (i, arr))

    n = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        i = n % len(plan)
        n += 1
        batch = plan[i]
        t_in = time.perf_counter()
        with spans.span("stack"):
            d, v = _stack(batch)
        with spans.span("forward_tiles"):
            res = pipe.forward_tiles(d, v, None, s.resolution)
        for dims in model_flops.gat_layer_dims(s.cfg, len(batch),
                                               *batch[0].shape):
            key = compare.dims_key(dims)
            calls[key] = calls.get(key, 0) + 1
        inflight.append((i, t_in, res))
        while len(inflight) > s.tr["inflight"]:
            finish()
    while inflight:
        finish()
    window_s = time.perf_counter() - t0
    s.sample = sample.items
    p90 = statistics.quantiles(lat, n=10)[8] if len(lat) > 1 else lat[0]
    return {
        "window_s": window_s,
        "attempted": n, "failed": 0,
        "metrics": {
            "survey_mcells_per_s": (cells / window_s / 1e6, "Mcells/s"),
            "survey_batch_p90_ms": (p90 * 1e3, "ms"),
        },
        "counts": {"batches": n, "cells": cells},
        "flops": model_flops.forward_flops(s.cfg, cells),
        "kernel_calls": {"grid_gat_fwd.infer": calls},
    }


def release(s):
    """Free the program's state before the reference runs."""
    s.pipe.model = None
    s.pipe = None
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def _reference_outputs(s, mode: str):
    outs = []
    for i, _arr in s.sample:
        d, v = _stack(s.plan[i])
        got = ref.survey_tiles(s.weights, s.cfg, torch.from_numpy(d).to(
            s.device), torch.from_numpy(v).to(s.device), mode)
        outs.append((v, got.cpu().numpy()))
    return outs


def check(s, result) -> List[tuple]:
    """(name, reading, limit) of the comparison with the reference over
    the sampled batches."""
    ref_out = _reference_outputs(s, "float32")
    prog = [arr for _i, arr in s.sample]
    return compare.survey_readings(prog, ref_out, s.tr["limits"])


def control(s) -> List[tuple]:
    """The readings of the reference in TF32 put in the program's place."""
    ref_out = _reference_outputs(s, "float32")
    low = [o for _v, o in _reference_outputs(s, "tf32")]
    return compare.survey_readings(low, ref_out, s.tr["limits"])
