"""The port's multi-tensor clip and AdamW (``training/optim``) against the
per-leaf versions they replaced, kept here as the plain versions: the
same roundings leaf for leaf over mixed shapes (a 0-d leaf among them),
f32 and f32 + bf16 parameters, a gradient laid out unlike its parameter;
clipped and unclipped steps, a zero gradient and a learning rate set per
step; a ``state_dict`` round trip mid-run; the leaf counters a traced
grid step exports in ``spans.json``. On the card (marker ``cuda``): one
step of the grid model at the benchmark's widths makes no host sync,
launches a few dozen kernels, and equals the plain version's."""

import json
import math

import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu_torch.config.config import Config
from bathymetric_gnn_tpu_torch.training import grid_trainer as tgt
from bathymetric_gnn_tpu_torch.training.optim import (AdamW,
                                                      clip_by_global_norm_)
from bathymetric_gnn_tpu_torch.utils import prof

F32, BF16 = torch.float32, torch.bfloat16
MAX_NORM = 1.0
SHAPES = [(64, 7), (256,), (), (3, 2, 4), (1,), (512, 64), (5, 1)]
# (gradient scale, learning rate) a step: clipped, unclipped, a zero
# gradient (norm 0), clipped
STEPS = ((3.0, 1e-3), (0.002, 5e-4), (0.0, 2e-3), (10.0, 1e-3))


def plain_clip(grads, max_norm, norm=None):
    """The per-leaf clip the port had: each leaf's squares summed in f32,
    the sums added leaf by leaf. ``norm``: clip by this norm instead."""
    if norm is None:
        norm = torch.sqrt(sum(g.to(F32).square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


class PlainAdamW(AdamW):
    """The per-leaf AdamW step the port had (its bias corrections copied
    to the device once a leaf)."""

    @torch.no_grad()
    def step(self, grads, lr):
        self.count += 1
        bc1 = 1 - torch.tensor(self.b1, dtype=F32) ** self.count
        bc2 = 1 - torch.tensor(self.b2, dtype=F32) ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g.to(F32)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g.square() + self.b2 * nu)
            u = (mu / bc1.to(mu.device)) / (
                torch.sqrt(nu / bc2.to(nu.device) + self.eps_root)
                + self.eps)
            u = u + self.weight_decay * p
            p.add_((u * -lr).to(p.dtype))


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between ``a`` and ``b``, element by element,
    in units in the last place of their dtype (the count of values of
    the dtype between them)."""
    assert a.dtype == b.dtype and a.shape == b.shape
    bits = {F32: (torch.int32, 0x7FFFFFFF), BF16: (torch.int16, 0x7FFF)}
    ints, mag = bits[a.dtype]

    def ordered(t):
        i = t.detach().cpu().contiguous().view(ints).to(torch.int64)
        return torch.where(i < 0, -(i & mag), i)

    if a.numel() == 0:
        return 0
    return int((ordered(a) - ordered(b)).abs().max())


def exact_norm(grads) -> float:
    return math.sqrt(sum(float(g.detach().cpu().double().square().sum())
                         for g in grads))


def f32_ulp(x: float) -> float:
    return float(np.spacing(np.float32(x)))


LEAVES = {
    "f32": (F32,) * len(SHAPES),
    "f32_bf16": tuple(BF16 if i % 2 else F32 for i in range(len(SHAPES))),
    # the first leaf's gradient comes column-major: it goes alone
    "strided_grad": (F32,) * len(SHAPES),
}


def _params(leaves, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(s, generator=gen).to(dt)
            for s, dt in zip(SHAPES, LEAVES[leaves])]


def _grads(leaves, params, gen, scale):
    out = [(torch.randn(p.shape, generator=gen) * scale).to(p.dtype)
           for p in params]
    if leaves == "strided_grad":
        out[0] = out[0].t().contiguous().t()
        assert out[0].stride() != params[0].stride()
    return out


def _clone(ts):
    return [t.clone() for t in ts]    # keeps each tensor's strides


@pytest.fixture
def session():
    """A span session of ``prof.TRACER`` (its counters), ended after."""
    prof.TRACER.begin()
    yield prof.TRACER
    prof.TRACER.end()


@pytest.mark.parametrize("leaves", sorted(LEAVES))
def test_clip_and_adamw_match_the_plain_versions(leaves, session):
    """Four steps, each clip then AdamW on both versions. The clip's norm
    sums each leaf's squares in f64, so it is within half an ulp of the
    exact norm; the plain version's f32 sums round it up to an ulp
    further, so each step's clipped gradients are held bit for bit to the
    plain formula at the new norm, and to the plain clip itself wherever
    the two norms are equal. AdamW then takes those gradients in both
    versions: parameters and moments within 1 ulp of their dtype."""
    params = _params(leaves)
    new_p, old_p = _clone(params), _clone(params)
    new, old = AdamW(new_p), PlainAdamW(old_p)
    gen = torch.Generator().manual_seed(1)
    for scale, lr in STEPS:
        grads = _grads(leaves, params, gen, scale)
        g = _clone(grads)
        norm = clip_by_global_norm_(g, MAX_NORM)
        plain_norm = plain_clip(_clone(grads), MAX_NORM)
        exact = exact_norm(grads)
        assert norm.dtype == F32 and norm.shape == ()
        assert abs(float(norm) - exact) <= 0.51 * f32_ulp(exact), scale
        assert ulps(norm, plain_norm) <= 1
        assert bool(norm >= MAX_NORM) == (scale > 1.0)
        ref = _clone(grads)
        plain_clip(ref, MAX_NORM, norm=norm)
        if ulps(norm, plain_norm) == 0:
            plain_clip(grads, MAX_NORM)
            assert all(ulps(a, b) == 0 for a, b in zip(ref, grads))
        for a, b in zip(g, ref):
            assert a.stride() == b.stride() and ulps(a, b) == 0
        new.step(g, lr)
        old.step(_clone(g), lr)
        for name, a_s, b_s in (("param", new_p, old_p), ("mu", new.mu, old.mu),
                               ("nu", new.nu, old.nu)):
            for i, (a, b) in enumerate(zip(a_s, b_s)):
                assert a.dtype == b.dtype and ulps(a, b) <= 1, (name, i, lr)
        assert all(bool(torch.isfinite(p.float()).all()) for p in new_p)
    alone = 1 if leaves == "strided_grad" else 0
    assert session.counters["optim.multi_tensor_leaves"] == \
        len(STEPS) * (len(SHAPES) - alone)
    assert session.counters["optim.per_leaf_leaves"] == len(STEPS) * alone


@pytest.mark.parametrize("leaves", sorted(LEAVES))
def test_state_dict_round_trip_mid_run(leaves):
    """Two steps, the optimizer's state saved and loaded into a new one
    over copies of the parameters, two more steps on each: the resumed
    run equals the uninterrupted one bit for bit."""
    params = _params(leaves, seed=2)
    opt = AdamW(params)
    gen = torch.Generator().manual_seed(3)
    steps = [(_grads(leaves, params, gen, s), lr) for s, lr in STEPS]
    for g, lr in steps[:2]:
        clip_by_global_norm_(g, MAX_NORM)
        opt.step(g, lr)
    state = opt.state_dict()
    assert state["count"] == 2 and len(state["mu"]) == len(SHAPES)
    assert all(t.device.type == "cpu" and t.dtype == F32
               for t in state["mu"] + state["nu"])
    resumed_p = _clone(params)
    resumed = AdamW(resumed_p)
    resumed.load_state_dict(state)
    for g, lr in steps[2:]:
        for o in (opt, resumed):
            gg = _clone(g)
            clip_by_global_norm_(gg, MAX_NORM)
            o.step(gg, lr)
    assert resumed.count == opt.count == 4
    for a, b in zip(resumed_p + resumed.mu + resumed.nu,
                    params + opt.mu + opt.nu):
        assert torch.equal(a, b)


def _surface(side, seed=0):
    """A smooth seafloor ramp with a little roughness."""
    rg = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32)
    return (30.0 + 0.05 * xx + 0.02 * yy + 0.5 * np.sin(xx / 7.0)
            + 0.3 * np.cos(yy / 9.0)
            + rg.normal(0, 0.02, (side, side))).astype(np.float32)


def _grid_trainer(tmp_path, device, side, tile, overlap):
    """A grid trainer with the published default model (hidden 64, 4
    layers, 4 heads: the benchmark's widths) over tiles of one survey."""
    cfg = Config()
    cfg.training.batch_size = 4
    cfg.training.class_weights = (1.2, 0.8, 1.5)
    ds = tgt.SyntheticGridDataset([_surface(side)], cfg, tile_size=tile,
                                  overlap=overlap, seed=1)
    tr = tgt.GridTrainer(cfg, ds, output_dir=str(tmp_path), device=device)
    return tr, tr.init_state(), ds


def test_traced_grid_step_exports_leaf_counters(tmp_path):
    """A traced step of the grid model (48 leaves) writes the optimizer's
    counts into ``spans.json``: every leaf stepped by the multi-tensor
    path, none alone; untraced steps count nothing."""
    tr, state, ds = _grid_trainer(tmp_path, "cpu", 64, 32, 8)
    assert len(list(state.model.parameters())) == 48
    batch = tgt.collate_grids([ds[0], ds[1]])
    out = tmp_path / "trace"
    with prof.device_trace(str(out)):
        tr.train_step(state, batch, 1e-3)
    tr.train_step(state, batch, 1e-3)
    rec = json.loads((out / prof.SPANS_FILE).read_text())
    assert rec["counters"] == {"spans_dropped": 0,
                               "optim.multi_tensor_leaves": 48,
                               "optim.per_leaf_leaves": 0}
    assert prof.TRACER.counters["optim.multi_tensor_leaves"] == 48


def _card_launches(fn, path) -> list:
    """The kernels, copies and fills ``fn`` puts on the card, by name,
    from a profiler trace written to ``path``."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    p.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


@pytest.mark.cuda
def test_grid_step_optimizer_on_the_card(tmp_path):
    """After one backward of the grid model at the benchmark's widths
    (4 tiles of 256^2): clip + AdamW make no host sync (sync debug mode
    "error"), launch at most 64 kernels, copies and fills together (the
    per-leaf versions ~1,300), and give the plain versions' parameters
    and moments, given the same clipped gradients, to 1 ulp; the clipped
    gradients are the plain formula's at the new norm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tr, state, ds = _grid_trainer(tmp_path, "cuda", 480, 256, 32)
    batch = tgt.collate_grids([ds[i] for i in range(4)])
    model = state.model
    params = list(model.parameters())
    assert len(params) == 48
    losses, _ = tr.loss_fn(model, batch, train=True)
    losses["total"].backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    raw = _clone(grads)
    old_p = [p.detach().clone() for p in params]
    old = PlainAdamW(old_p)
    out = {}

    def step():
        torch.cuda.set_sync_debug_mode("error")
        try:
            out["norm"] = clip_by_global_norm_(grads, MAX_NORM)
            state.optimizer.step(grads, 1e-3)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    launched = _card_launches(step, tmp_path / "new.json")
    norm = out["norm"]
    exact = exact_norm(raw)
    assert abs(float(norm) - exact) <= 0.51 * f32_ulp(exact)
    ref, plain_g = _clone(raw), _clone(raw)
    plain_clip(ref, MAX_NORM, norm=norm)

    def plain_step():
        plain_clip(plain_g, MAX_NORM)
        old.step(ref, 1e-3)

    before = _card_launches(plain_step, tmp_path / "plain.json")
    print(f"clip + AdamW on the card: {len(launched)} launches; the "
          f"per-leaf versions {len(before)}")
    assert 0 < len(launched) <= 64, launched
    for a, b in zip(grads, ref):
        assert ulps(a, b) == 0
    for name, a_s, b_s in (("mu", state.optimizer.mu, old.mu),
                           ("nu", state.optimizer.nu, old.nu),
                           ("param", params, old_p)):
        for i, (a, b) in enumerate(zip(a_s, b_s)):
            assert ulps(a, b) <= 1, (name, i, int((a != b).sum()))
