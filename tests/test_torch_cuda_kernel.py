"""The CUDA kernels vs their plain PyTorch versions, on the card: kernel A
in its inference and training forms, kernel B against autograd of the
plain forward, and the in-kernel Philox dropout draw; kernel C (the GAT
layer on ELL graphs) in its inference and dropout forms, kernel C'
against autograd of the plain forward, and kernel F (the sorted-segment
reduction) against ``index_add_``; kernels E (the banded band part), D
(the fused banded layer) and D' (its backward, with F's mode (a) behind
its spill gathers) against their plain versions and autograd of them; and
the COO path (``-k coo``): F as the COO segment sum and gather backward at
widths 1, 3, 4 and 256 against its plain version, the COO model's forward
and train step of each type bit for bit over two runs, and the GCN / SAGE
/ GIN ELL layers on the card against the CPU; and F's mode (a) in every
row form (``-k segment_narrow``: widths 1 to 260, f32 and bf16 rows, 16-byte
chunks and scalar columns) bit for bit against the in-order sum; and (``-k
"guard or repeats"``) kernels A and B with every input and output flush
against unmapped address space (``ops/cuda/guard.py``), and kernel A's
launches repeated bit for bit.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (the CPU test runs). On a machine with an H100 and nvcc:
``python -m pytest --noconftest tests/test_torch_cuda_kernel.py``
(``--noconftest``: ``tests/conftest.py`` imports jax, which this file does
not need). The kernel is built from ``bathymetric_gnn_tpu_torch/csrc`` on
first use.
"""

from unittest import mock

import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu_torch.data.graph_build import build_grid_inputs
from bathymetric_gnn_tpu_torch.models.grid_gat import (GridBathymetricGNN,
                                                       GridGATConv)
from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as gf

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _layer_inputs(dev, b, h, w, f_in, heads, c, conn=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    depth = 30 + torch.randn(b, h, w, generator=g).cumsum(1) * 0.05
    valid = torch.rand(b, h, w, generator=g) > 0.05
    feats, v, nbr, ea, _ = build_grid_inputs(depth.to(dev), valid.to(dev),
                                             connectivity=conn)
    conv = GridGATConv(f_in, c, heads=heads, concat=heads > 1,
                       connectivity=conn, generator=g).to(dev)
    x = torch.randn(b, h, w, f_in, generator=g).to(dev) * v[..., None]
    wl, a_s, a_d, me, bias = gf.gat_param_matrices(
        {n: p.detach() for n, p in conv.named_parameters()}, heads, c, 3)
    bias = bias + torch.randn(bias.shape, generator=g).to(dev) * 0.1
    sc = (torch.rand(heads * c, generator=g) + 0.5).to(dev)
    sh = (torch.randn(heads * c, generator=g) * 0.1).to(dev)
    return ((x, wl, a_s, a_d, me, ea, nbr.float(), v.float(), bias, conn,
             0.2, True), sc, sh)


# Tolerances, as stated in chip_smoke.py: f32 |err| <= 1e-4 (1 + |ref|)
# (same f32 products, other summation order); bf16 <= 1.6e-2 (1 + |ref|)
# (one or two bf16 rounding steps of the output).
TOL = {torch.float32: 1e-4, torch.bfloat16: 1.6e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 37, 53, 16, 2, 8, 8),     # ragged, batched
    (1, 1, 1, 7, 1, 64, 8),       # a single cell
    (1, 30, 100, 16, 4, 16, 4),   # 4-connected
    (1, 64, 96, 64, 4, 64, 8),    # the model's widths: 64 -> 4 x 64
    (1, 40, 33, 256, 1, 64, 8),   # last layer: 256 -> 64, heads 1
    (2, 31, 65, 40, 4, 16, 4),    # H, W across the 14 x 14 tile; F 40
    (2, 29, 33, 40, 8, 8, 8),     # 8 heads: one 16-warp block an SM
])
@pytest.mark.parametrize("relu", [False, True])
def test_kernel_matches_plain(dev, dtype, shape, relu):
    b, h, w, f_in, heads, c, conn = shape
    args, sc, sh = _layer_inputs(dev, b, h, w, f_in, heads, c, conn)
    kw = dict(bn_scale=sc, bn_bias=sh, fuse_relu=relu, compute_dtype=dtype)
    with torch.no_grad():
        n0 = gf.launches
        out = gf.fused_grid_gat_infer(*args, **kw)
        torch.cuda.synchronize()
        assert gf.launches == n0 + 1
        ref = gf.grid_gat_reference(*args, **kw)
    assert out.dtype == dtype and out.shape == (b, h, w, heads * c)
    err = (out.float() - ref.float()).abs() / (1 + ref.float().abs())
    assert err.max().item() <= TOL[dtype], err.max().item()


def test_kernel_rejects_what_it_does_not_take(dev):
    args, sc, sh = _layer_inputs(dev, 1, 8, 8, 16, 3, 4)   # heads 3
    with pytest.raises(ValueError, match="heads"):
        gf.fused_grid_gat_infer(*args)
    args, _, _ = _layer_inputs(dev, 1, 8, 8, 16, 2, 4)
    with pytest.raises(ValueError, match="compute_dtype"):
        gf.fused_grid_gat_infer(*args, compute_dtype=torch.float16)


def test_model_on_card_matches_cpu(dev):
    """The whole model (kernel layers on the card) vs the same weights on
    the CPU (plain layers): classes agree, confidence within 1e-3."""
    g = torch.Generator().manual_seed(1)
    model = GridBathymetricGNN(7, 16, 2, 2, generator=g).eval()
    depth = 30 + torch.randn(2, 48, 70, generator=g).cumsum(2) * 0.05
    valid = torch.rand(2, 48, 70, generator=g) > 0.05
    with torch.no_grad():
        cpu = model(*build_grid_inputs(depth, valid)[:4])
        model.to(dev)
        gpu = model(*build_grid_inputs(depth.to(dev), valid.to(dev))[:4])
    agree = (cpu["predicted_class"] == gpu["predicted_class"].cpu()).float()
    assert agree.mean().item() > 0.999
    np.testing.assert_allclose(gpu["confidence"].cpu().numpy(),
                               cpu["confidence"].numpy(), atol=1e-3)


# Training form. Forward: the f32 / bf16 tolerances above. Gradients, per
# leaf against its largest |entry|: f32 2e-4 (sums over all cells taken in
# another order), bf16 3e-2 (kernel B rounds dxh and d_ad to bf16 before
# its products where autograd of the plain version rounds after them; the
# tolerance of the JAX bf16 backward tests).
GRAD_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
LEAVES = ("x", "w_lin", "a_src", "a_dst", "m_edge", "bias")


def _train_run(fn, args, dmask, dtype, g=None, **kw):
    leaves = [t.detach().clone().requires_grad_() for t in
              (args[0], args[1], args[2], args[3], args[4], args[8])]
    x, wl, a_s, a_d, me, bias = leaves
    out = fn(x, wl, a_s, a_d, me, args[5], args[6], args[7], bias,
             *args[9:], dmask=dmask, compute_dtype=dtype, **kw)
    if g is None:
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(9)
                        ).to(out.device, dtype)
    grads = torch.autograd.grad(out, leaves, g)
    return out.detach(), grads, g


def _dmask(args, heads, seed=3, keep=0.9):
    x, nbr = args[0], args[6]
    b, k, h, w = nbr.shape
    g = torch.Generator().manual_seed(seed)
    m = (torch.rand(b, k + 1, heads, h, w, generator=g) < keep).float() / keep
    return m.to(x.device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 37, 53, 16, 2, 8, 8),     # ragged, batched
    (1, 30, 100, 16, 4, 16, 4),   # 4-connected
    (1, 64, 96, 64, 4, 64, 8),    # the model's widths: 64 -> 4 x 64
    (1, 40, 33, 256, 1, 64, 8),   # last layer: 256 -> 64, heads 1
    (2, 23, 61, 40, 4, 16, 4),    # across B's 8 x 28 tile; F 40, conn 4
    (2, 27, 31, 40, 8, 8, 8),     # 8 heads: B's 12 x 12 tile
])
@pytest.mark.parametrize("drop", [False, True])
def test_train_kernels_match_plain(dev, dtype, shape, drop):
    """Kernel A (training form, streamed dmask) and kernel B vs the plain
    forward and autograd of it, on the same inputs and mask."""
    b, h, w, f_in, heads, c, conn = shape
    args, _, _ = _layer_inputs(dev, b, h, w, f_in, heads, c, conn)
    dmask = _dmask(args, heads) if drop else None
    n0, b0 = gf.train_launches, gf.bwd_launches
    out, grads, g = _train_run(gf.fused_grid_gat, args, dmask, dtype)
    torch.cuda.synchronize()
    assert (gf.train_launches, gf.bwd_launches) == (n0 + 1, b0 + 1)
    ref, rgrads, _ = _train_run(gf.grid_gat_reference, args, dmask, dtype, g)
    assert out.dtype == dtype and out.shape == (b, h, w, heads * c)
    err = (out.float() - ref.float()).abs() / (1 + ref.float().abs())
    assert err.max().item() <= TOL[dtype], err.max().item()
    for name, a, r in zip(LEAVES, grads, rgrads):
        scale = r.float().abs().max().item() + 1e-6
        d = (a.float() - r.float()).abs().max().item()
        assert d <= GRAD_TOL[dtype] * scale, (name, d, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [
    (2, 23, 61, 40, 4, 16, 4),
    (2, 27, 31, 40, 8, 8, 8),
    (1, 40, 33, 256, 1, 64, 8),
])
def test_train_kernels_philox_match_plain(dev, dtype, shape):
    """Dropout mode 2 (the Philox draw in kernels A and B) vs the plain
    forward and autograd of it given the same draw as a mask."""
    b, h, w, f_in, heads, c, conn = shape
    args, _, _ = _layer_inputs(dev, b, h, w, f_in, heads, c, conn)
    seed = torch.tensor([20241017], dtype=torch.int64, device=dev)
    mask = gf.drop_mask(seed, 0.9, b, conn, heads, h, w)
    out, grads, g = _train_run(gf.fused_grid_gat, args, None, dtype,
                               drop_seed=seed, keep_prob=0.9)
    ref, rgrads, _ = _train_run(gf.grid_gat_reference, args, mask, dtype, g)
    err = (out.float() - ref.float()).abs() / (1 + ref.float().abs())
    assert err.max().item() <= TOL[dtype], err.max().item()
    for name, a, r in zip(LEAVES, grads, rgrads):
        scale = r.float().abs().max().item() + 1e-6
        d = (a.float() - r.float()).abs().max().item()
        assert d <= GRAD_TOL[dtype] * scale, (name, d, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [4, 8])
def test_bwd_gradients_repeat_bit_for_bit(dev, dtype, heads):
    """Kernel B's partials carry no atomics: two calls on the same inputs
    give the same gradients bit for bit."""
    args, _, _ = _layer_inputs(dev, 2, 45, 70, 64, heads, 64 // heads, 8)
    dmask = _dmask(args, heads)
    _, first, g = _train_run(gf.fused_grid_gat, args, dmask, dtype)
    _, again, _ = _train_run(gf.fused_grid_gat, args, dmask, dtype, g)
    for name, a, r in zip(LEAVES, first, again):
        assert torch.equal(a, r), name


def test_philox_rate_and_fwd_bwd_agree(dev):
    """The in-kernel draw drops 0.1 +- 0.002 of the weights, and kernels A
    and B with the draw equal (bit for bit) kernels A and B given the
    same draw as a streamed mask."""
    args, _, _ = _layer_inputs(dev, 2, 64, 96, 64, 4, 64, 8)
    seed = torch.tensor([1234567891011], dtype=torch.int64, device=dev)
    mask = gf.drop_mask(seed, 0.9, 2, 8, 4, 64, 96)
    rate = (mask == 0).float().mean().item()
    assert abs(rate - 0.1) <= 0.002, rate
    inv = torch.tensor(1.0 / 0.9, dtype=torch.float32, device=dev)
    assert ((mask == 0) | (mask == inv)).all()
    out_s, gr_s, g = _train_run(gf.fused_grid_gat, args, None,
                                torch.float32, drop_seed=seed,
                                keep_prob=0.9)
    out_m, gr_m, _ = _train_run(gf.fused_grid_gat, args, mask,
                                torch.float32, g)
    assert torch.equal(out_s, out_m)
    for name, a, m in zip(LEAVES, gr_s, gr_m):
        assert torch.equal(a, m), name
    other = gf.drop_mask(seed + 1, 0.9, 2, 8, 4, 64, 96)
    assert not torch.equal(other, mask)


# Guard pages (ops/cuda/guard.py): every input and output of kernels A and
# B flush against unmapped address space, at the end and then at the start
# of its mapping, so that a read or write just outside a buffer faults
# every time. Shapes: F not a multiple of the 16-byte vector (7, 13), HC
# not a multiple of 4 (6, 5, 1), C not a multiple of 4, H and W below one
# 14 x 14 block, heads 1, 2 and 8, and the model's widths.
GUARD_SHAPES = [
    (2, 37, 53, 7, 2, 3, 8),
    (1, 29, 31, 13, 1, 5, 4),
    (3, 5, 9, 13, 8, 2, 8),
    (1, 13, 11, 7, 2, 6, 4),
    (2, 17, 15, 40, 8, 8, 8),
    (1, 1, 1, 7, 1, 1, 8),
    (1, 64, 96, 64, 4, 64, 8),
]


def _same_bits(a, b):
    ints = {2: torch.int16, 4: torch.int32}
    it = ints[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(it), b.view(it))


@pytest.mark.parametrize("at", ["end", "start"])
def test_guard_pages_fault_just_outside_a_tensor(dev, at):
    """The guard works: a kernel's 8-byte read just past the end (or
    before the start) of a guard-placed tensor ends its process with a
    fault (``guard.overrun``)."""
    from bathymetric_gnn_tpu_torch.ops.cuda import guard

    hit, line = guard.faults(at)
    assert hit, line


@pytest.mark.parametrize("at", ["end", "start"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GUARD_SHAPES)
def test_kernel_under_guard_pages_matches_plain(dev, at, dtype, shape):
    """Kernel A (inference form, BatchNorm + ReLU epilogue) on guard-page
    copies of its inputs, its output guard-placed: no fault, bit for bit
    the ordinary call, within TOL of the plain version."""
    from bathymetric_gnn_tpu_torch.ops.cuda import guard

    args, sc, sh = _layer_inputs(dev, *shape)
    kw = dict(bn_scale=sc, bn_bias=sh, fuse_relu=True, compute_dtype=dtype)
    with torch.no_grad():
        kargs = gf.kernel_args(*args, **kw)
        base = gf.call_kernel(**kargs)
        out = guard.guarded_call(gf.call_kernel, kargs, at)
        ref = gf.grid_gat_reference(*args, **kw)
    assert _same_bits(out, base)
    err = (out.float() - ref.float()).abs() / (1 + ref.float().abs())
    assert err.max().item() <= TOL[dtype], err.max().item()


@pytest.mark.parametrize("at", ["end", "start"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", GUARD_SHAPES)
@pytest.mark.parametrize("drop", ["mask", "philox"])
def test_train_kernels_under_guard_pages_match_plain(dev, at, dtype, shape,
                                                     drop):
    """Kernel A's training form and kernel B on guard-page copies of their
    inputs, their outputs and B's scratch guard-placed: no fault, bit for
    bit the ordinary calls, within TOL / GRAD_TOL of the plain forward and
    autograd of it (streamed mask, or the Philox draw given to the plain
    version as its mask)."""
    from bathymetric_gnn_tpu_torch.ops.cuda import guard

    b, h, w, f_in, heads, c, conn = shape
    args, _, _ = _layer_inputs(dev, *shape)
    seed = torch.tensor([20241017], dtype=torch.int64, device=dev)
    if drop == "philox":
        mask = gf.drop_mask(seed, 0.9, b, conn, heads, h, w)
        dkw = dict(drop_seed=seed, keep_prob=0.9)
    else:
        mask = _dmask(args, heads)
        dkw = dict(dmask=mask)
    ref, rgrads, g = _train_run(gf.grid_gat_reference, args, mask, dtype)
    x, wl, a_s, a_d, me, ea, nbr, v, bias = args[:9]
    with torch.no_grad():
        kargs = gf.kernel_args(*args, bn_scale=None, bn_bias=None,
                               fuse_relu=False, compute_dtype=dtype,
                               train=True, **dkw)
        eattr, mattr = gf.edge_attr_terms(ea, nbr, True, dtype)
        bkw = {k: kargs[k] for k in (
            "x", "w", "wa", "el", "el_self", "valid", "heads",
            "connectivity", "negative_slope", "drop_mode", "dmask", "seed",
            "thresh", "keep_inv")}
        bkw.update(g=g.to(dtype).contiguous(), eattr=eattr, mattr=mattr)
        base = gf.call_kernel(**kargs)
        base_b = gf.call_bwd_kernel(**bkw)
        out = guard.guarded_call(gf.call_kernel, kargs, at)
        parts = guard.guarded_call(gf.call_bwd_kernel, bkw, at)
    assert _same_bits(out, base)
    assert all(_same_bits(p, q) for p, q in zip(parts, base_b))
    err = (out.float() - ref.float()).abs() / (1 + ref.float().abs())
    assert err.max().item() <= TOL[dtype], err.max().item()
    grads = gf.bwd_gradients(*parts, wl, a_s, a_d)
    for name, a, r in zip(LEAVES, grads, rgrads):
        scale = r.float().abs().max().item() + 1e-6
        d = (a.float() - r.float()).abs().max().item()
        assert d <= GRAD_TOL[dtype] * scale, (name, d, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [GUARD_SHAPES[0], GUARD_SHAPES[2],
                                   (2, 64, 96, 64, 4, 64, 8)])
def test_kernel_repeats_bit_for_bit(dev, dtype, shape):
    """Kernel A is deterministic: 50 launches on the same prepared inputs,
    each synchronized, give the first launch's bits."""
    args, sc, sh = _layer_inputs(dev, *shape)
    kw = dict(bn_scale=sc, bn_bias=sh, fuse_relu=True, compute_dtype=dtype)
    with torch.no_grad():
        kargs = gf.kernel_args(*args, **kw)
        first = gf.call_kernel(**kargs)
        torch.cuda.synchronize()
        for _ in range(50):
            out = gf.call_kernel(**kargs)
            torch.cuda.synchronize()
            assert _same_bits(out, first)


# The halo model's strip shape: the row-sharded grid model finishes each
# shard's two boundary rows with 3-row convs ([B, 3, W, F]), which cut
# kernels A and B's 14-row (A) and 8- / 12-row (B) cell tiles to 3 rows.
STRIP_SHAPES = [
    (1, 3, 48, 16, 2, 16, 8),       # the CPU tests' widths
    (2, 3, 48, 64, 4, 64, 8),       # the model's first layer, batched
    (1, 3, 2048, 256, 4, 64, 8),    # a mid layer on a 2048-wide survey
    (3, 3, 2048, 256, 1, 64, 8),    # the last layer, batched
]


@pytest.mark.parametrize("shape", STRIP_SHAPES)
@pytest.mark.parametrize("fold", [False, True])
def test_kernel_at_strip_shape_matches_plain(dev, shape, fold):
    """Kernel A's inference form at H = 3, with and without the folded
    BatchNorm epilogue, against its plain version."""
    b, h, w, f_in, heads, c, conn = shape
    args, sc, sh = _layer_inputs(dev, b, h, w, f_in, heads, c, conn)
    kw = (dict(bn_scale=sc, bn_bias=sh, fuse_relu=True) if fold else {})
    with torch.no_grad():
        n0 = gf.launches
        out = gf.fused_grid_gat_infer(*args, **kw)
        torch.cuda.synchronize()
        assert gf.launches == n0 + 1
        ref = gf.grid_gat_reference(*args, **kw)
    assert out.shape == (b, h, w, heads * c)
    err = (out - ref).abs() / (1 + ref.abs())
    assert err.max().item() <= TOL[torch.float32], err.max().item()


@pytest.mark.parametrize("shape", STRIP_SHAPES)
@pytest.mark.parametrize("drop", [False, True])
def test_train_kernels_at_strip_shape_match_plain(dev, shape, drop):
    """Kernel A's training form and kernel B at H = 3 against the plain
    forward and autograd of it."""
    b, h, w, f_in, heads, c, conn = shape
    args, _, _ = _layer_inputs(dev, b, h, w, f_in, heads, c, conn)
    dmask = _dmask(args, heads) if drop else None
    n0, b0 = gf.train_launches, gf.bwd_launches
    out, grads, g = _train_run(gf.fused_grid_gat, args, dmask,
                               torch.float32)
    torch.cuda.synchronize()
    assert (gf.train_launches, gf.bwd_launches) == (n0 + 1, b0 + 1)
    ref, rgrads, _ = _train_run(gf.grid_gat_reference, args, dmask,
                                torch.float32, g)
    err = (out - ref).abs() / (1 + ref.abs())
    assert err.max().item() <= TOL[torch.float32], err.max().item()
    for name, a, r in zip(LEAVES, grads, rgrads):
        scale = r.abs().max().item() + 1e-6
        d = (a - r).abs().max().item()
        assert d <= GRAD_TOL[torch.float32] * scale, (name, d, scale)


def test_infer_entry_raises_under_grad(dev):
    args, _, _ = _layer_inputs(dev, 1, 8, 16, 16, 2, 4)
    x = args[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        gf.fused_grid_gat_infer(x, *args[1:])


def test_model_train_step_grads_on_card(dev):
    """One training step of the model (dropout 0) on the card, through
    kernels A and B, vs the same step with every GAT layer on its plain
    version on the card: every parameter gets a gradient, and they agree
    within 1e-3 of each leaf's scale (the conv bias before a batch-stats
    BatchNorm has a true gradient of ~0, held to 1e-3 of the largest
    gradient instead)."""
    from unittest import mock

    from bathymetric_gnn_tpu_torch.models.grid_batched import BatchedGridGNN

    g = torch.Generator().manual_seed(2)
    model = BatchedGridGNN(7, 16, 2, 2, dropout=0.0, generator=g).to(dev)
    depth = 30 + torch.randn(2, 40, 56, generator=g).cumsum(2) * 0.05
    valid = torch.rand(2, 40, 56, generator=g) > 0.05
    inputs = build_grid_inputs(depth.to(dev), valid.to(dev))[:4]

    def step():
        model.zero_grad()
        out = model.train()(*inputs)
        loss = out["class_logits"].square().sum() + out["confidence"].sum() \
            + out["correction"].square().sum()
        loss.backward()
        return {n: p.grad.clone() for n, p in model.named_parameters()}

    state = {k: v.clone() for k, v in model.state_dict().items()}
    n0 = gf.bwd_launches
    gk = step()
    assert gf.bwd_launches == n0 + 2
    model.load_state_dict(state)

    def plain(*a, dmask=None, drop_seed=None, keep_prob=1.0, **kw):
        return gf.grid_gat_reference(*a, dmask=dmask, **kw)

    with mock.patch.object(gf, "fused_grid_gat", plain):
        gp = step()
    big = max(r.abs().max().item() for r in gp.values())
    for name, a in gk.items():
        r = gp[name]
        scale = (big if "GridGATConv" in name and name.endswith(".bias")
                 else r.abs().max().item() + 1e-6)
        assert (a - r).abs().max().item() <= 1e-3 * scale, name


# -- kernel C: the GAT layer on ELL graphs -------------------------------------

def _ell_inputs(dev, n, k, heads, c, seed=0, n_live=None, edge=True):
    """A k-NN ELL graph over n_live random points padded to n nodes, with
    the first 5 live nodes isolated and the next 5 keeping 3 live slots;
    xh, attention vectors, edge-logit terms and bias from ``seed``."""
    from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
    from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell

    n_live = n_live or n - n // 16
    rg = np.random.default_rng(seed)
    pos = (rg.random((n_live, 2)) * 100).astype(np.float32)
    x = rg.normal(size=(n_live, 3)).astype(np.float32)
    gb = GraphBuilder()
    gb.buckets.node_buckets = (n,)
    g = coo_to_ell(gb.build_knn_graph(x, pos, k).graph, max_degree=k)
    g.nbr_mask[:5] = False
    g.nbr_mask[5:10, 3:] = False
    g = g.to(dev)
    gen = torch.Generator().manual_seed(seed)
    hc = heads * c

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(dev)

    return dict(xh=rnd(n, hc), att_src=rnd(1, heads, c, s=0.3),
                att_dst=rnd(1, heads, c, s=0.3), nbr_src=g.nbr_src,
                nbr_mask=g.nbr_mask, el=rnd(n, k, heads) if edge else None,
                el_self=rnd(n, heads) if edge else None, bias=rnd(hc, s=0.1),
                node_mask=g.node_mask)


@pytest.mark.parametrize("shape", [
    (65536 // 16, 8, 4, 64),     # HC 256, 4 heads (layers 0-2)
    (65536 // 16, 8, 1, 64),     # HC 64, 1 head (last layer)
    (3000, 16, 4, 64),           # K = 16
    (1000, 8, 2, 6),             # C % 4 != 0: scalar columns
])
@pytest.mark.parametrize("self_loop,edge", [(True, True), (False, True),
                                            (True, False)])
def test_ell_kernel_matches_plain(dev, shape, self_loop, edge):
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    n, k, heads, c = shape
    kw = _ell_inputs(dev, n, k, heads, c, edge=edge)
    with torch.no_grad():
        n0 = ef.launches
        out = ef.ell_gat_fused(**kw, self_loop=self_loop)
        torch.cuda.synchronize()
        assert ef.launches == n0 + 1
        ref = ef.ell_gat_reference(**kw, self_loop=self_loop)
    err = (out - ref).abs() / (1 + ref.abs())
    assert err.max().item() <= TOL[torch.float32], err.max().item()
    assert torch.isfinite(out).all()
    dead = ~kw["node_mask"]
    assert dead.any() and not out[dead].any()      # padded nodes: 0
    if not self_loop:                              # isolated: bias only
        torch.testing.assert_close(out[:5], kw["bias"].expand(5, -1))


def test_ell_kernel_raises_under_grad_and_on_what_it_does_not_take(dev):
    """The serving entry still has no backward (the training entry,
    ``ell_gat_fused_train``, is held against autograd of the plain version
    in ``test_ell_train_kernels_match_plain``); both entries raise on what
    the kernels do not take."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    kw = _ell_inputs(dev, 512, 8, 4, 16)
    kw["xh"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        ef.ell_gat_fused(**kw)
    kw["xh"] = kw["xh"].detach()
    wide = {**kw, "att_src": kw["att_src"].reshape(1, 16, 4),
            "att_dst": kw["att_dst"].reshape(1, 16, 4), "el": None,
            "el_self": None}
    for fn in (ef.ell_gat_fused, ef.ell_gat_fused_train):
        with torch.no_grad():
            # float32 and bfloat16 are taken (test_ell_kernel_bf16_*)
            with pytest.raises(ValueError, match="float32 or bfloat16"):
                fn(**{**kw, "xh": kw["xh"].half()})
            with pytest.raises(ValueError, match="heads"):
                fn(**wide)
    with pytest.raises(ValueError, match="dmask"):
        ef.ell_gat_fused_train(**kw, dmask=torch.ones(512, 8, 4,
                                                      device=dev))


@pytest.mark.parametrize("heads,concat", [(4, True), (1, False)])
def test_gat_conv_ell_launches_kernel_c(dev, heads, concat):
    """GATConvELL (the "xla" route of the default VR route's large grids)
    on the card runs kernel C, one launch a call, and matches the same
    layer on the CPU (the plain version) at TOL."""
    from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
    from bathymetric_gnn_tpu_torch.models.conv_ell import GATConvELL
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell

    rg = np.random.default_rng(4)
    pos = (rg.random((3000, 2)) * 100).astype(np.float32)
    gb = GraphBuilder()
    gb.buckets.node_buckets = (4096,)
    bg = gb.build_knn_graph(rg.normal(size=(3000, 3)).astype(np.float32),
                            pos, 8, depth=rg.normal(size=3000))
    g = coo_to_ell(bg.graph, max_degree=8)
    x = torch.from_numpy(rg.normal(size=(4096, 16)).astype(np.float32))
    layer = GATConvELL(16, 64, heads=heads, concat=concat, edge_dim=3,
                       generator=torch.Generator().manual_seed(2)).eval()
    with torch.no_grad():
        layer.bias.normal_(0.0, 0.1, generator=torch.Generator()
                           .manual_seed(3))
        want = layer(g.to("cpu"), x)
        card = layer.to(dev)
        gd, xd = g.to(dev), x.to(dev)
        n0 = ef.launches
        got = card(gd, xd)
        got2 = card(gd, xd)
        torch.cuda.synchronize()
    assert ef.launches == n0 + 2
    assert torch.equal(got, got2)
    err = ((got.cpu() - want).abs() / (1 + want.abs())).max().item()
    assert err <= TOL[torch.float32], err


def _ell_train_graph(dev, n=3000, bucket=4096, seed=4):
    from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
    from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell

    rg = np.random.default_rng(seed)
    pos = (rg.random((n, 2)) * 100).astype(np.float32)
    gb = GraphBuilder()
    gb.buckets.node_buckets = (bucket,)
    bg = gb.build_knn_graph(rg.normal(size=(n, 3)).astype(np.float32),
                            pos, 8, depth=rg.normal(size=n))
    g = coo_to_ell(bg.graph, max_degree=8).with_src_sorted_slots()
    x = torch.from_numpy(rg.normal(size=(bucket, 16)).astype(np.float32))
    return g, x


@pytest.mark.parametrize("concat", [True, False])
def test_gat_conv_ell_dropout_runs_kernels_c_and_c_prime(dev, concat):
    """GATConvELL in training mode with attention dropout (the form the
    port used to refuse) on the card: kernel C's dropout form and C', one
    launch each a step; one generator seed gives the same output and
    gradients bit for bit, another seed other ones; in training mode at
    dropout 0 the card matches the CPU (the plain version) at TOL."""
    from bathymetric_gnn_tpu_torch.models.conv_ell import GATConvELL
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    g, x = _ell_train_graph(dev)
    gd, xd = g.to(dev), x.to(dev)

    def run(layer, gg, xx, seed):
        xx = xx.clone().requires_grad_()
        out = layer(gg, xx, torch.Generator(xx.device).manual_seed(seed))
        out.square().sum().backward()
        return out.detach(), xx.grad

    layer = GATConvELL(16, 64, heads=4, concat=concat, edge_dim=3,
                       dropout=0.3, generator=torch.Generator().manual_seed(2)
                       ).to(dev).train()
    n0, b0 = ef.train_launches, ef.bwd_launches
    a = run(layer, gd, xd, 1)
    torch.cuda.synchronize()
    assert (ef.train_launches, ef.bwd_launches) == (n0 + 1, b0 + 1)
    b = run(layer, gd, xd, 1)
    c = run(layer, gd, xd, 2)
    assert torch.isfinite(a[0]).all()
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    layer.dropout = 0.0
    got = run(layer, gd, xd, 1)
    want = run(layer.cpu(), g.to("cpu"), x, 1)
    for gv, wv in zip(got, want):
        err = ((gv.cpu() - wv).abs() / (1 + wv.abs())).max().item()
        assert err <= GRAD_TOL[torch.float32], err


@pytest.mark.parametrize("relu", [False, True])
def test_grid_head_mean_on_card_matches_cpu(dev, relu):
    """GridGATConv with concat=False and 4 heads (the head mean, which the
    port used to refuse) on the card: kernel A's inference form, the head
    mean, the bias and the folded BatchNorm against the same layer on the
    CPU, one launch; and its training form (A, then B in the backward)
    against autograd of the plain version."""
    args, sc, sh = _layer_inputs(dev, 2, 31, 45, 40, 4, 16)
    x, _, _, _, _, ea, nbr, v = args[:8]
    layer = GridGATConv(40, 16, heads=4, concat=False,
                        generator=torch.Generator().manual_seed(5)).to(dev)
    with torch.no_grad():
        layer.bias.normal_(0.0, 0.1)
    cpu = GridGATConv(40, 16, heads=4, concat=False)
    cpu.load_state_dict({k: t.cpu() for k, t in layer.state_dict().items()})
    sc, sh = sc[:16], sh[:16]
    with torch.no_grad():
        n0 = gf.launches
        got = layer.eval()(x, v > 0, nbr, ea, bn_scale=sc, bn_bias=sh,
                           fuse_relu=relu)
        torch.cuda.synchronize()
        assert gf.launches == n0 + 1
        want = cpu.eval()(x.cpu(), (v > 0).cpu(), nbr.cpu(), ea.cpu(),
                          bn_scale=sc.cpu(), bn_bias=sh.cpu(),
                          fuse_relu=relu)
    assert got.shape == (2, 31, 45, 16)
    err = ((got.cpu() - want).abs() / (1 + want.abs())).max().item()
    assert err <= TOL[torch.float32], err
    n0, b0 = gf.train_launches, gf.bwd_launches
    xg = x.clone().requires_grad_()
    layer.train()(xg, v > 0, nbr, ea).square().sum().backward()
    torch.cuda.synchronize()
    assert (gf.train_launches, gf.bwd_launches) == (n0 + 1, b0 + 1)
    xc = x.cpu().clone().requires_grad_()
    cpu.train()(xc, (v > 0).cpu(), nbr.cpu(), ea.cpu()).square().sum(
        ).backward()
    for (name, p), q in zip(layer.named_parameters(), cpu.parameters()):
        scale = q.grad.abs().max().item() + 1e-6
        assert (p.grad.cpu() - q.grad).abs().max().item() <= (
            GRAD_TOL[torch.float32] * scale), name
    scale = xc.grad.abs().max().item()
    assert (xg.grad.cpu() - xc.grad).abs().max().item() <= (
        GRAD_TOL[torch.float32] * scale)


def test_ell_model_on_card_matches_cpu(dev):
    """EllBathymetricGNN at full width (hidden 64, 4 heads, 4 layers)
    through kernel C on the card vs the same weights on the CPU."""
    from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
    from bathymetric_gnn_tpu_torch.models.gnn_ell import EllBathymetricGNN
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell

    rg = np.random.default_rng(1)
    pos = (rg.random((3500, 2)) * 60).astype(np.float32)
    x = rg.normal(size=(3500, 8)).astype(np.float32)
    gb = GraphBuilder()
    gb.buckets.node_buckets = (4096,)
    g = coo_to_ell(gb.build_knn_graph(x, pos, 8, depth=x[:, 0]).graph, 8)
    model = EllBathymetricGNN(8, sparse_kernel="banded_pallas",
                              generator=torch.Generator().manual_seed(0))
    model.eval()
    with torch.no_grad():
        cpu = model(g.to("cpu"))
        n0 = ef.launches
        gpu = model.to(dev)(g.to(dev))
        torch.cuda.synchronize()
    assert ef.launches == n0 + 4
    live = torch.from_numpy(g.node_mask)
    agree = (gpu["predicted_class"].cpu() == cpu["predicted_class"])[live]
    assert agree.float().mean().item() >= 0.999
    for key in ("confidence", "correction"):
        d = (gpu[key].cpu() - cpu[key]).abs()[live].max().item()
        assert d <= 1e-3, (key, d)


# -- kernel C's dropout form, kernel C' and kernel F ----------------------------

# Gradients of the ELL layer, per leaf against its largest |entry|: f32 2e-4
# (sums over all slots taken in another order), as for kernel B.
ELL_LEAVES = ("xh", "att_src", "att_dst", "el", "el_self", "bias")


def _ell_train_run(fn, kw, g=None, **extra):
    """fn(**kw) and the gradients of <out, g> with respect to xh, att_src,
    att_dst, el, el_self and bias (those given); g drawn when not given."""
    leaves = {n: kw[n].detach().clone().requires_grad_()
              for n in ELL_LEAVES if kw.get(n) is not None}
    out = fn(**{**kw, **leaves}, **extra)
    if g is None:
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(9)
                        ).to(out.device, out.dtype)
    # allow_unused: without a self loop the plain version never reads
    # el_self (its true gradient is 0)
    grads = torch.autograd.grad(out, list(leaves.values()), g,
                                allow_unused=True)
    return out.detach(), {n: torch.zeros_like(t) if d is None else d
                          for (n, t), d in zip(leaves.items(), grads)}, g


def _ell_dmask(kw, heads, seed=3, keep=0.9):
    n, k = kw["nbr_src"].shape
    gen = torch.Generator().manual_seed(seed)
    m = (torch.rand(n, k + 1, heads, generator=gen) < keep).float() / keep
    return m.to(kw["xh"].device)


@pytest.mark.parametrize("shape", [
    (65536 // 16, 8, 4, 64),     # HC 256, 4 heads (layers 0-2)
    (65536 // 16, 8, 1, 64),     # HC 64, 1 head (last layer)
    (3000, 16, 4, 64),           # K = 16
    (1000, 8, 2, 6),             # C % 4 != 0: scalar columns
])
@pytest.mark.parametrize("self_loop,edge", [(True, True), (False, True),
                                            (True, False)])
@pytest.mark.parametrize("drop", [False, True])
def test_ell_train_kernels_match_plain(dev, shape, self_loop, edge, drop):
    """Kernel C (training form, streamed dmask) and kernel C' (+ F's mode
    (b)) vs the plain forward and autograd of it, on the same inputs and
    mask; padded nodes get zero gradients."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    n, k, heads, c = shape
    kw = _ell_inputs(dev, n, k, heads, c, edge=edge)
    dmask = _ell_dmask(kw, heads) if drop else None
    counts = (ef.train_launches, ef.bwd_launches, sr.launches)
    out, grads, g = _ell_train_run(ef.ell_gat_fused_train, kw,
                                   self_loop=self_loop, dmask=dmask)
    torch.cuda.synchronize()
    assert (ef.train_launches, ef.bwd_launches, sr.launches) == tuple(
        x + 1 for x in counts)
    ref, rgrads, _ = _ell_train_run(ef.ell_gat_reference, kw, g,
                                    self_loop=self_loop, dmask=dmask)
    err = (out - ref).abs() / (1 + ref.abs())
    assert err.max().item() <= TOL[torch.float32], err.max().item()
    for name, a in grads.items():
        r = rgrads[name]
        assert torch.isfinite(a).all(), name
        scale = r.abs().max().item() + 1e-6
        d = (a - r).abs().max().item()
        assert d <= GRAD_TOL[torch.float32] * scale, (name, d, scale)
    dead = ~kw["node_mask"]
    assert not grads["xh"][dead].any()


def test_ell_philox_rate_and_fwd_bwd_agree(dev):
    """The in-kernel draw drops 0.1 +- 1e-3 of the weights (2.4 M draws),
    and kernels C and C' with the draw equal (bit for bit) kernels C and C'
    given the same draw as a streamed mask."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    seed = torch.tensor([1234567891011], dtype=torch.int64, device=dev)
    big = ef.drop_mask(seed, 0.9, 65536, 8, 4)
    rate = (big == 0).float().mean().item()
    assert abs(rate - 0.1) <= 1e-3, rate
    inv = torch.tensor(1.0 / 0.9, dtype=torch.float32, device=dev)
    assert ((big == 0) | (big == inv)).all()
    kw = _ell_inputs(dev, 4096, 8, 4, 64)
    mask = ef.drop_mask(seed, 0.9, 4096, 8, 4)
    torch.testing.assert_close(mask, big[:4096], rtol=0, atol=0)
    out_s, gr_s, g = _ell_train_run(ef.ell_gat_fused_train, kw,
                                    drop_seed=seed, keep_prob=0.9)
    out_m, gr_m, _ = _ell_train_run(ef.ell_gat_fused_train, kw, g,
                                    dmask=mask)
    assert torch.equal(out_s, out_m)
    for name in gr_s:
        assert torch.equal(gr_s[name], gr_m[name]), name
    assert not torch.equal(ef.drop_mask(seed + 1, 0.9, 4096, 8, 4), mask)


@pytest.mark.parametrize("n,k,f", [(4096, 8, 256), (3000, 16, 64),
                                   (777, 5, 6)])
def test_segment_reduce_matches_index_add(dev, n, k, f):
    """Kernel F, mode (a), over a k-NN graph's source-sorted slot tables
    (isolated and padded nodes included) vs ``index_add_`` of the live
    slots' rows; and bit-stable from run to run."""
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr
    from bathymetric_gnn_tpu_torch.ops.ell import src_sorted_slots

    kw = _ell_inputs(dev, n, k, 1, 8)
    src, live = kw["nbr_src"], kw["nbr_mask"] & kw["node_mask"][:, None]
    perm, row_ptr = (torch.from_numpy(t).to(dev) for t in src_sorted_slots(
        src.cpu().numpy(), live.cpu().numpy()))
    ct = torch.randn(n * k, f, generator=torch.Generator().manual_seed(4)
                     ).to(dev)
    n0 = sr.launches
    out = sr.segment_reduce_sorted(ct, perm, row_ptr, n)
    torch.cuda.synchronize()
    assert sr.launches == n0 + 1
    flat = live.reshape(-1)
    ref = torch.zeros(n, f, device=dev).index_add_(
        0, src.reshape(-1)[flat].long(), ct[flat])
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(
        out, sr.segment_reduce_reference(ct, perm, row_ptr, n),
        rtol=1e-5, atol=1e-5)
    assert torch.equal(out, sr.segment_reduce_sorted(ct, perm, row_ptr, n))


@pytest.mark.parametrize("shape", [(65536 // 16, 8, 4, 64),
                                   (65536 // 16, 8, 1, 64),
                                   (3000, 16, 4, 64), (1000, 8, 2, 6)])
def test_segment_reduce_gat_rows_matches_plain(dev, shape):
    """Kernel F's mode (b) on its own vs its plain version, on C''s own
    coefficients; and C' without F (its destination pass, which writes the
    destination side of dxh as three scalars per node and head) plus F
    equals C' with F: the destination-side rows formed from those scalars
    plus the source side equal dxh (the sums start from another value, so
    within f32 rounding), the per-slot outputs bit for bit."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr
    from bathymetric_gnn_tpu_torch.ops.ell import src_sorted_slots

    n, k, heads, c = shape
    kw = _ell_inputs(dev, n, k, heads, c)
    perm, row_ptr = (torch.from_numpy(t).to(dev) for t in src_sorted_slots(
        kw["nbr_src"].cpu().numpy(), kw["nbr_mask"].cpu().numpy(),
        kw["node_mask"].cpu().numpy()))
    args = ef.kernel_args(**kw, train=True)
    bkw = {name: args[name] for name in (
        "xh", "att", "nbr", "nmask", "el", "el_self", "node_mask", "dmask",
        "seed", "n", "k", "heads", "c", "negative_slope", "has_self",
        "drop_mode", "thresh", "keep_inv", "dtype")}
    g = torch.randn(n, heads * c, generator=torch.Generator().manual_seed(5)
                    ).to(dev)
    full = ef.call_bwd_kernel(**bkw, perm=perm.int(), row_ptr=row_ptr.int(),
                              g=g)
    n0 = sr.launches
    dst = ef.call_bwd_kernel(**bkw, perm=perm.int(), row_ptr=row_ptr.int(),
                             g=g, source_side=False)
    assert sr.launches == n0
    src = sr.gat_rows(full[1], full[2], g, kw["att_src"], perm, row_ptr, n,
                      k)
    torch.cuda.synchronize()
    assert sr.launches == n0 + 1
    ref = sr.gat_rows_reference(full[1], full[2], g, kw["att_src"], perm,
                                row_ptr, n, k)
    torch.testing.assert_close(src, ref, rtol=1e-5, atol=1e-5)
    assert tuple(dst[0].shape) == (n, 3, heads)
    from test_torch_ell_bwd_design import dst_side_rows

    rows = dst_side_rows(dst[0], g, args["att"])
    torch.testing.assert_close(rows + src, full[0], rtol=1e-5, atol=1e-5)
    for a, b in zip(dst[1:], full[1:]):
        assert torch.equal(a, b)


def test_ell_model_train_step_on_card_matches_cpu(dev):
    """One training step (dropout 0) of EllBathymetricGNN at full width
    (hidden 64, 4 heads, 4 layers) through kernels C, C' and F on the card
    vs the same step on the CPU (plain layers): every parameter gets a
    gradient, within 1e-3 of each leaf's scale (the conv biases before a
    batch-stats BatchNorm, whose true gradient is ~0: of the largest
    gradient); the running statistics agree."""
    from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
    from bathymetric_gnn_tpu_torch.models.gnn_ell import EllBathymetricGNN
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell

    rg = np.random.default_rng(2)
    pos = (rg.random((3500, 2)) * 60).astype(np.float32)
    x = rg.normal(size=(3500, 8)).astype(np.float32)
    gb = GraphBuilder()
    gb.buckets.node_buckets = (4096,)
    g = coo_to_ell(gb.build_knn_graph(x, pos, 8, depth=x[:, 0]).graph, 8
                   ).with_src_sorted_slots()
    model = EllBathymetricGNN(8, sparse_kernel="banded_pallas",
                              generator=torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def step(device):
        model.load_state_dict(state)
        model.to(device).train().zero_grad()
        out = model(g.to(device))
        loss = out["class_logits"].square().sum() + out["confidence"].sum() \
            + out["correction"].square().sum()
        loss.backward()
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        return grads, {k: v.detach().cpu() for k, v in
                       model.state_dict().items()}

    n0 = ef.bwd_launches
    gk, sk = step(dev)
    torch.cuda.synchronize()
    assert ef.bwd_launches == n0 + 4
    gc, sc = step("cpu")
    big = max(r.abs().max().item() for r in gc.values())
    for name, r in gc.items():
        scale = (big if "GATConv" in name and name.endswith(".bias")
                 else r.abs().max().item() + 1e-6)
        assert (gk[name] - r).abs().max().item() <= 1e-3 * scale, name
    for name, v in sc.items():
        torch.testing.assert_close(sk[name], v, rtol=1e-4, atol=1e-5)


# -- kernels E, D and D': the banded-ELL layer ----------------------------------

def _banded_inputs(dev, n, k, heads, c, r, seed=0, self_loop=True,
                   edge=True, drop=False, full_band=False):
    """A k-NN graph over n - n / 16 random points padded to n nodes, split
    by band_ell into r-row bands on the card, with the layer inputs of
    ``ell_gat_fused_v2`` from ``seed`` (el_t carrying the NEG_BIG mask) and
    streamed dropout masks (keep 0.9) when ``drop``. ``full_band``: the
    spill tables exactly as wide as the fullest band's spills."""
    from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
    from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell
    from bathymetric_gnn_tpu_torch.ops.ell_banded import band_ell

    n_live = n - n // 16
    rg = np.random.default_rng(seed)
    pos = (rg.random((n_live, 2)) * 100).astype(np.float32)
    x = rg.normal(size=(n_live, 3)).astype(np.float32)
    gb = GraphBuilder()
    gb.buckets.node_buckets = (n,)
    g = coo_to_ell(gb.build_knn_graph(x, pos, k).graph, max_degree=k)
    s_max = None
    if full_band:
        dl = band_ell(g, band_rows=r, heads=heads).spill_dst_local_b
        s_max = int((dl >= 0).sum(-1).max())
    banded = band_ell(g, band_rows=r, heads=heads, s_max=s_max).to(dev)
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(dev)

    xh = rnd(n, heads, c)
    att = rnd(2, heads, c, s=0.3)
    hc = heads * c
    diag = (torch.arange(hc, device=dev)[:, None] // c
            == torch.arange(heads, device=dev)[None]).float()
    el_t = banded.negmask_t + (rnd(k * heads, n) if edge else 0.0)
    masks = None
    if drop:
        t_count, _, s_max = banded.spill_dst_local_b.shape
        masks = tuple((torch.rand(*shape, generator=gen) < 0.9).float().to(dev)
                      / 0.9 for shape in (((k + 1) * heads, n),
                                          (t_count, heads, s_max)))
    return dict(xh=xh, a_src=(xh * att[0]).sum(-1),
                a_dst=(xh * att[1]).sum(-1),
                a_cat_mat=torch.cat([diag * att[0].reshape(hc, 1),
                                     diag * att[1].reshape(hc, 1)], 1),
                el_t=el_t, el_self_t=rnd(heads, n) if self_loop else None,
                m_edge=rnd(3, heads, s=0.3) if edge else None,
                banded=banded, dropout_masks=masks)


BANDED_SHAPES = [
    (4096, 8, 4, 64, 128),       # HC 256, 4 heads (layers 0-2), R 128
    (4096, 8, 1, 64, 128),       # HC 64, 1 head (last layer)
    (2048, 16, 4, 64, 256),      # K = 16, R 256
    (1024, 8, 2, 6, 128),        # C % 4 != 0: scalar columns
]


@pytest.mark.parametrize("shape", BANDED_SHAPES)
@pytest.mark.parametrize("self_loop,edge", [(True, True), (False, True),
                                            (True, False)])
def test_band_kernel_matches_plain(dev, shape, self_loop, edge):
    """Kernel E vs its plain version: y, m and denom within the f32
    tolerance of (1 + |ref|)."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb

    n, k, heads, c, r = shape
    kw = _banded_inputs(dev, n, k, heads, c, r, self_loop=self_loop,
                        edge=edge)
    args = (kw["xh"], kw["a_cat_mat"], kw["el_t"], kw["el_self_t"],
            kw["banded"])
    with torch.no_grad():
        n0 = eb.band_launches
        got = eb.ell_gat_band_part(*args)
        torch.cuda.synchronize()
        assert eb.band_launches == n0 + 1
        want = eb.band_part_reference(*args)
    for name, a, b in zip(("y", "m", "denom"), got, want):
        err = ((a - b).abs() / (1 + b.abs())).max().item()
        assert err <= TOL[torch.float32], (name, err)
        assert torch.isfinite(a).all(), name


V2_LEAVES = ("xh", "a_src", "a_dst", "a_cat_mat", "el_t", "el_self_t",
             "m_edge")


def _v2_run(fn, kw, g=None):
    leaves = {n: kw[n].detach().clone().requires_grad_()
              for n in V2_LEAVES if kw.get(n) is not None}
    out = fn(**{**kw, **leaves})
    if g is None:
        g = torch.randn(out.shape, generator=torch.Generator().manual_seed(9)
                        ).to(out.device, out.dtype)
    grads = torch.autograd.grad(out, list(leaves.values()), g)
    return out.detach(), dict(zip(leaves, grads)), g


@pytest.mark.parametrize("shape", BANDED_SHAPES)
@pytest.mark.parametrize("self_loop,edge", [(True, True), (False, True),
                                            (True, False)])
@pytest.mark.parametrize("drop", [False, True])
def test_v2_kernels_match_plain(dev, shape, self_loop, edge, drop):
    """Kernel D and kernel D' (with F's mode (a) behind the three spill
    gathers) vs the plain forward and autograd of it, on the same inputs
    and masks; and D' repeats bit for bit."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    n, k, heads, c, r = shape
    kw = _banded_inputs(dev, n, k, heads, c, r, self_loop=self_loop,
                        edge=edge, drop=drop)
    counts = (eb.v2_launches, eb.v2_bwd_launches, sr.launches)
    out, grads, g = _v2_run(eb.ell_gat_fused_v2, kw)
    torch.cuda.synchronize()
    assert (eb.v2_launches, eb.v2_bwd_launches, sr.launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 3)
    ref, rgrads, _ = _v2_run(eb.fused_v2_reference, kw, g)
    err = ((out - ref).abs() / (1 + ref.abs())).max().item()
    assert err <= TOL[torch.float32], err
    for name, a in grads.items():
        rr = rgrads[name]
        assert torch.isfinite(a).all(), name
        scale = rr.abs().max().item() + 1e-6
        d = (a - rr).abs().max().item()
        assert d <= GRAD_TOL[torch.float32] * scale, (name, d, scale)
    out2, grads2, _ = _v2_run(eb.ell_gat_fused_v2, kw, g)
    assert torch.equal(out, out2)
    assert all(torch.equal(grads[nm], grads2[nm]) for nm in grads)


def test_banded_kernels_raise_on_what_they_do_not_take(dev):
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb

    kw = _banded_inputs(dev, 1024, 8, 4, 16, 128)
    xh = kw["xh"].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        eb.ell_gat_band_part(xh, kw["a_cat_mat"], kw["el_t"], None,
                             kw["banded"])
    wide = torch.zeros(64, 18, device=dev)            # 9 heads
    with torch.no_grad():
        for bad, match in (({"xh": kw["xh"].double()}, "float32"),
                           ({"a_cat_mat": wide}, "heads"),
                           ({"el_t": kw["el_t"][:-1]}, "el_t")):
            args = {**kw, **bad}
            with pytest.raises(ValueError, match=match):
                eb.ell_gat_band_part(args["xh"], args["a_cat_mat"],
                                     args["el_t"], None, kw["banded"])
            with pytest.raises(ValueError, match=match):
                eb.ell_gat_fused_v2(**args)
        t_count = kw["banded"].spill_dst_local_b.shape[0]
        with pytest.raises(ValueError, match="dropout masks"):
            eb.ell_gat_fused_v2(**{**kw, "dropout_masks": (
                torch.ones(9 * 4, 1024, device=dev),
                torch.ones(t_count, 4, 1, device=dev))})


def test_route_d_model_train_step_on_card_matches_cpu(dev):
    """One training step (dropout 0) of EllBathymetricGNN at full width
    with every layer on route D (``wide_kernel=False``), through kernels D,
    D' and F on the card vs the same step on the CPU: every gradient within
    1e-3 of its leaf's scale (the conv biases: of the largest gradient),
    as for route C."""
    from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
    from bathymetric_gnn_tpu_torch.models.gnn_ell import EllBathymetricGNN
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
    from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell
    from bathymetric_gnn_tpu_torch.ops.ell_banded import band_ell

    rg = np.random.default_rng(2)
    pos = (rg.random((3500, 2)) * 60).astype(np.float32)
    x = rg.normal(size=(3500, 8)).astype(np.float32)
    gb = GraphBuilder()
    gb.buckets.node_buckets = (4096,)
    g = coo_to_ell(gb.build_knn_graph(x, pos, 8, depth=x[:, 0]).graph, 8)
    banded = band_ell(g, band_rows=128)
    model = EllBathymetricGNN(8, sparse_kernel="banded_pallas",
                              generator=torch.Generator().manual_seed(0))
    for i in range(4):
        getattr(model.GNNBackbone_0, f"GATConv_{i}").wide_kernel = False
    state = {k: v.clone() for k, v in model.state_dict().items()}

    def step(device):
        model.load_state_dict(state)
        model.to(device).train().zero_grad()
        out = model(g.to(device), banded=banded.to(device))
        loss = out["class_logits"].square().sum() + out["confidence"].sum() \
            + out["correction"].square().sum()
        loss.backward()
        return {n: p.grad.detach().cpu() for n, p in model.named_parameters()}

    n0 = (eb.v2_launches, eb.v2_bwd_launches)
    gk = step(dev)
    torch.cuda.synchronize()
    assert (eb.v2_launches, eb.v2_bwd_launches) == (n0[0] + 4, n0[1] + 4)
    gc = step("cpu")
    big = max(r.abs().max().item() for r in gc.values())
    for name, r in gc.items():
        scale = (big if "GATConv" in name and name.endswith(".bias")
                 else r.abs().max().item() + 1e-6)
        assert (gk[name] - r).abs().max().item() <= 1e-3 * scale, name


# -- the bf16 forms of kernels C, C', D, D', E and F ------------------------------
#
# Each against its plain version on the same bf16 inputs: outputs within
# TOL[bf16] of (1 + |ref|) (one or two bf16 roundings of the output apart),
# gradients within GRAD_TOL[bf16] of each leaf's largest |entry| (the
# kernels round dy to bf16 where the JAX kernels' interpret mode does;
# autograd of the plain version does not). Kernel E's outputs are f32 from
# the same bf16 inputs: the f32 tolerance.

ELL_SHAPES = [(65536 // 16, 8, 4, 64), (65536 // 16, 8, 1, 64),
              (3000, 16, 4, 64), (1000, 8, 2, 6)]


def _bf16(kw):
    return {**kw, "xh": kw["xh"].bfloat16()}


@pytest.mark.parametrize("shape", ELL_SHAPES)
@pytest.mark.parametrize("self_loop,edge", [(True, True), (False, True),
                                            (True, False)])
def test_ell_kernel_bf16_matches_plain(dev, shape, self_loop, edge):
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    n, k, heads, c = shape
    kw = _bf16(_ell_inputs(dev, n, k, heads, c, edge=edge))
    with torch.no_grad():
        n0 = ef.launches
        out = ef.ell_gat_fused(**kw, self_loop=self_loop)
        torch.cuda.synchronize()
        assert ef.launches == n0 + 1
        ref = ef.ell_gat_reference(**kw, self_loop=self_loop)
    assert out.dtype == ref.dtype == torch.bfloat16
    err = (out.float() - ref.float()).abs() / (1 + ref.float().abs())
    assert err.max().item() <= TOL[torch.bfloat16], err.max().item()
    assert torch.isfinite(out).all()
    assert not out[~kw["node_mask"]].float().any()


@pytest.mark.parametrize("shape", ELL_SHAPES)
@pytest.mark.parametrize("drop", [False, True])
def test_ell_train_kernels_bf16_match_plain(dev, shape, drop):
    """Kernel C's bf16 training form and C' (+ F (b)) vs the plain bf16
    forward and autograd of it; d xh comes back in bf16."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    n, k, heads, c = shape
    kw = _bf16(_ell_inputs(dev, n, k, heads, c))
    dmask = _ell_dmask(kw, heads) if drop else None
    counts = (ef.train_launches, ef.bwd_launches, sr.launches)
    out, grads, g = _ell_train_run(ef.ell_gat_fused_train, kw, dmask=dmask)
    torch.cuda.synchronize()
    assert (ef.train_launches, ef.bwd_launches, sr.launches) == tuple(
        x + 1 for x in counts)
    ref, rgrads, _ = _ell_train_run(ef.ell_gat_reference, kw, g,
                                    dmask=dmask)
    assert out.dtype == torch.bfloat16 and grads["xh"].dtype == torch.bfloat16
    err = (out.float() - ref.float()).abs() / (1 + ref.float().abs())
    assert err.max().item() <= TOL[torch.bfloat16], err.max().item()
    for name, a in grads.items():
        r = rgrads[name].float()
        assert torch.isfinite(a).all(), name
        scale = r.abs().max().item() + 1e-6
        d = (a.float() - r).abs().max().item()
        assert d <= GRAD_TOL[torch.bfloat16] * scale, (name, d, scale)
    assert not grads["xh"][~kw["node_mask"]].float().any()


def test_ell_philox_bf16_fwd_bwd_agree(dev):
    """Kernels C and C' in bf16 with the in-kernel draw equal (bit for bit)
    the same kernels given the draw as a streamed mask."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    seed = torch.tensor([987654321], dtype=torch.int64, device=dev)
    kw = _bf16(_ell_inputs(dev, 4096, 8, 4, 64))
    mask = ef.drop_mask(seed, 0.9, 4096, 8, 4)
    out_s, gr_s, g = _ell_train_run(ef.ell_gat_fused_train, kw,
                                    drop_seed=seed, keep_prob=0.9)
    out_m, gr_m, _ = _ell_train_run(ef.ell_gat_fused_train, kw, g,
                                    dmask=mask)
    assert torch.equal(out_s, out_m)
    for name in gr_s:
        assert torch.equal(gr_s[name], gr_m[name]), name


@pytest.mark.parametrize("n,k,f", [(4096, 8, 256), (777, 5, 6)])
def test_segment_reduce_bf16_matches_plain(dev, n, k, f):
    """Kernel F mode (a) on a bf16 cotangent: f32 sums of the bf16 rows."""
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr
    from bathymetric_gnn_tpu_torch.ops.ell import src_sorted_slots

    kw = _ell_inputs(dev, n, k, 1, 8)
    src, live = kw["nbr_src"], kw["nbr_mask"] & kw["node_mask"][:, None]
    perm, row_ptr = (torch.from_numpy(t).to(dev) for t in src_sorted_slots(
        src.cpu().numpy(), live.cpu().numpy()))
    ct = torch.randn(n * k, f, generator=torch.Generator().manual_seed(4)
                     ).to(dev).bfloat16()
    n0 = sr.launches
    out = sr.segment_reduce_sorted(ct, perm, row_ptr, n)
    torch.cuda.synchronize()
    assert sr.launches == n0 + 1 and out.dtype == torch.float32
    torch.testing.assert_close(
        out, sr.segment_reduce_reference(ct, perm, row_ptr, n),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape", BANDED_SHAPES)
@pytest.mark.parametrize("self_loop,edge", [(True, True), (False, True)])
def test_band_kernel_bf16_matches_plain(dev, shape, self_loop, edge):
    """Kernel E's bf16 form: bf16 xh and a_cat_mat, f32 y, m and denom."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb

    n, k, heads, c, r = shape
    kw = _banded_inputs(dev, n, k, heads, c, r, self_loop=self_loop,
                        edge=edge)
    args = (kw["xh"].bfloat16(), kw["a_cat_mat"], kw["el_t"],
            kw["el_self_t"], kw["banded"])
    with torch.no_grad():
        n0 = eb.band_launches
        got = eb.ell_gat_band_part(*args)
        torch.cuda.synchronize()
        assert eb.band_launches == n0 + 1
        want = eb.band_part_reference(*args)
    for name, a, b in zip(("y", "m", "denom"), got, want):
        assert a.dtype == torch.float32
        err = ((a - b).abs() / (1 + b.abs())).max().item()
        assert err <= TOL[torch.float32], (name, err)


def _m_edge_terms(kw, g):
    """sum_s |eattr_s| |d l_s| [edge_dim, heads] over the spill entries of
    the plain version: the absolute terms of m_edge's gradient."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb

    b, xh = kw["banded"], kw["xh"]
    n, heads, c = xh.shape
    xf = xh.reshape(n, heads * c)
    l_s, xs = eb._spill_inputs(xf, kw["a_src"], kw["a_dst"], kw["m_edge"],
                               b, 0.2, eb._plain_gather)
    l_s = l_s.detach().requires_grad_()
    dm, dsp = kw["dropout_masks"] or (None, None)
    out = eb._v2_plain(xf, kw["a_cat_mat"], b.loc_t, kw["el_t"],
                       kw["el_self_t"], l_s, xs, b.spill_dst_local_b,
                       band_rows=b.band_rows, dmask_t=dm, dmask_sp_b=dsp)
    (dl,) = torch.autograd.grad(out, l_s, g)
    dl = dl.permute(0, 2, 1).reshape(-1, heads).float()
    ea = b.spill_eattr_b.reshape(-1, b.spill_eattr_b.shape[-1]).float()
    return ea.abs().T @ dl.abs()


@pytest.mark.parametrize("shape", BANDED_SHAPES)
@pytest.mark.parametrize("drop", [False, True])
def test_v2_kernels_bf16_match_plain(dev, shape, drop):
    """Kernels D and D' in bf16 (F's mode (a) on the bf16 spill-row
    cotangent) vs the plain bf16 forward and autograd of it.

    m_edge's gradient is the sum over the spill entries of eattr_s d l_s,
    whose terms cancel (a row's logit cotangents sum to ~0): on the one-head
    graph it is 0.4 % of the sum of their absolute values. D' rounds dy to
    bf16 in the spill part of d denom, as JAX's kernel does, where autograd
    of the plain version does not, so m_edge is also allowed one bf16 step
    (2^-8) of that absolute sum: the error bound of a sum whose terms are
    each within one rounding."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    n, k, heads, c, r = shape
    kw = _bf16(_banded_inputs(dev, n, k, heads, c, r, drop=drop))
    counts = (eb.v2_launches, eb.v2_bwd_launches, sr.launches)
    out, grads, g = _v2_run(eb.ell_gat_fused_v2, kw)
    torch.cuda.synchronize()
    assert (eb.v2_launches, eb.v2_bwd_launches, sr.launches) == (
        counts[0] + 1, counts[1] + 1, counts[2] + 3)
    ref, rgrads, _ = _v2_run(eb.fused_v2_reference, kw, g)
    assert out.dtype == torch.bfloat16 and grads["xh"].dtype == torch.bfloat16
    err = ((out.float() - ref.float()).abs()
           / (1 + ref.float().abs())).max().item()
    assert err <= TOL[torch.bfloat16], err
    for name, a in grads.items():
        rr = rgrads[name].float()
        assert torch.isfinite(a).all(), name
        scale = rr.abs().max().item() + 1e-6
        d = (a.float() - rr).abs()
        allowed = GRAD_TOL[torch.bfloat16] * scale
        if name == "m_edge":
            allowed = allowed + 2.0 ** -8 * _m_edge_terms(kw, g)
        assert bool((d <= allowed).all()), (name, d.max().item(), scale)


@pytest.mark.parametrize("route", ["C", "D", "E"])
def test_bf16_ell_model_on_card_matches_cpu(dev, route):
    """EllBathymetricGNN(compute_dtype="bfloat16") at full width through
    the bf16 kernels of one route on the card vs the same weights on the
    CPU: classes agree on >= 99 % of the live nodes, confidence within
    1e-2; in training mode (dropout 0, routes C and D) every gradient
    within 2e-2 of its norm plus twice the distance between the CPU's bf16
    and f32 gradients (rounding noise, as tests/test_torch_ell_bf16_model.py
    measures it against JAX)."""
    from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
    from bathymetric_gnn_tpu_torch.models.gnn_ell import EllBathymetricGNN
    from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell
    from bathymetric_gnn_tpu_torch.ops.ell_banded import band_ell

    rg = np.random.default_rng(3)
    pos = (rg.random((3500, 2)) * 60).astype(np.float32)
    x = rg.normal(size=(3500, 8)).astype(np.float32)
    gb = GraphBuilder()
    gb.buckets.node_buckets = (4096,)
    g = coo_to_ell(gb.build_knn_graph(x, pos, 8, depth=x[:, 0]).graph, 8)
    banded = band_ell(g, band_rows=128)
    live = torch.from_numpy(g.node_mask)

    def build(dtype):
        m = EllBathymetricGNN(
            8, sparse_kernel="banded" if route == "E" else "banded_pallas",
            generator=torch.Generator().manual_seed(0), compute_dtype=dtype)
        for i in range(4):
            getattr(m.GNNBackbone_0, f"GATConv_{i}").wide_kernel = \
                route != "D"
        return m

    model = build("bfloat16")
    with torch.no_grad():
        cpu = model.eval()(g.to("cpu"), banded=banded.to("cpu"))
        gpu = model.to(dev)(g.to(dev), banded=banded.to(dev))
    agree = (gpu["predicted_class"].cpu() == cpu["predicted_class"])[live]
    assert agree.float().mean().item() >= 0.99
    d = (gpu["confidence"].cpu() - cpu["confidence"]).abs()[live].max()
    assert d.item() <= 1e-2
    if route == "E":
        return

    def grads(m, device):
        m.to(device).train().zero_grad()
        out = m(g.to(device), banded=banded.to(device))
        (out["class_logits"].square().sum() + out["confidence"].sum()
         + out["correction"].square().sum()).backward()
        return {n: p.grad.detach().cpu().double()
                for n, p in m.named_parameters()}

    state = {k: v.clone() for k, v in model.state_dict().items()}
    gk = grads(model, dev)
    model.load_state_dict(state)
    gc = grads(model.to("cpu"), "cpu")
    m32 = build("float32")
    m32.load_state_dict(state)
    g32 = grads(m32, "cpu")
    for name, r in gc.items():
        err = (gk[name] - r).norm()
        noise = (r - g32[name]).norm()
        assert err <= 2e-2 * r.norm() + 2 * noise, (name, err, noise)


# -- kernels C' and D' as redesigned: forms, determinism, spill tables --------
#
# The destination passes hold each row in 16-byte chunks (4 floats, 8 bf16;
# single columns where C is not a multiple) and reduce each head's dot
# products among that head's lanes (a xor tree where C / chunk is a power
# of two, else one warp sum a head): heads 1 / 2 / 4 / 8 and C % 4 != 0
# reach every form. The last four are rows wider than 8 chunks a lane in
# one dtype or both (16 or 32 single columns, 16 float4; they spill to
# local memory): (4, 100) and (2, 300) in bf16 (C % 8 == 4) take 16 and 32
# single columns, (1, 257) 16 in both dtypes, (8, 160) in f32 16 float4.
# Tolerances are TOL / GRAD_TOL of the other tests.

BWD_FORMS = [(4, 64), (1, 64), (2, 32), (8, 32), (1, 256), (2, 12), (8, 6),
             (4, 100), (2, 300), (1, 257), (8, 160)]


def _grads_close(grads, rgrads, dtype, extra=None):
    for name, a in grads.items():
        r = rgrads[name].float()
        assert torch.isfinite(a).all(), name
        scale = r.abs().max().item() + 1e-6
        d = (a.float() - r).abs()
        allowed = GRAD_TOL[dtype] * scale
        if extra is not None and name in extra:
            allowed = allowed + extra[name]
        assert bool((d <= allowed).all()), (name, d.max().item(), scale)


def _v2_extra(kw, g, dtype):
    """m_edge's allowance in bf16 (see test_v2_kernels_bf16_match_plain)."""
    if dtype != torch.bfloat16 or kw.get("m_edge") is None:
        return None
    return {"m_edge": 2.0 ** -8 * _m_edge_terms(kw, g)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,c", BWD_FORMS)
def test_ell_bwd_forms_match_plain(dev, dtype, heads, c):
    """Kernel C' (+ F (b)) in every row form vs autograd of the plain
    version, with streamed dropout, padded nodes (zero gradients) and live
    nodes with no live slot."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    kw = _ell_inputs(dev, 2048, 8, heads, c)
    kw = _bf16(kw) if dtype == torch.bfloat16 else kw
    assert not kw["nbr_mask"][:5].any() and kw["node_mask"][:5].all()
    dmask = _ell_dmask(kw, heads)
    out, grads, g = _ell_train_run(ef.ell_gat_fused_train, kw, dmask=dmask)
    ref, rgrads, _ = _ell_train_run(ef.ell_gat_reference, kw, g,
                                    dmask=dmask)
    err = (out.float() - ref.float()).abs() / (1 + ref.float().abs())
    assert err.max().item() <= TOL[dtype], err.max().item()
    _grads_close(grads, rgrads, dtype)
    assert not grads["xh"][~kw["node_mask"]].float().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,c", BWD_FORMS)
def test_v2_bwd_forms_match_plain(dev, dtype, heads, c):
    """Kernel D' in every row form vs autograd of the plain version, with
    streamed dropout masks."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb

    kw = _banded_inputs(dev, 2048, 8, heads, c, 128, drop=True)
    kw = _bf16(kw) if dtype == torch.bfloat16 else kw
    out, grads, g = _v2_run(eb.ell_gat_fused_v2, kw)
    ref, rgrads, _ = _v2_run(eb.fused_v2_reference, kw, g)
    err = ((out.float() - ref.float()).abs()
           / (1 + ref.float().abs())).max().item()
    assert err <= TOL[dtype], err
    _grads_close(grads, rgrads, dtype, _v2_extra(kw, g, dtype))


# Rows past the untiled instances, which C', D' and F (b) take in column
# tiles: HC 1026 (2 heads x 513, single columns past 32 a lane), HC 2056
# (2 x 1028, f32 float4 past 16 a lane) and HC 4112 (2 x 2056, bf16 8-wide
# chunks past 16 a lane).
WIDE_ROWS = [(torch.float32, 2, 513), (torch.bfloat16, 2, 513),
             (torch.float32, 2, 1028), (torch.bfloat16, 2, 2056)]


@pytest.mark.parametrize("kernel", ["C'", "D'"])
@pytest.mark.parametrize("dtype,heads,c", WIDE_ROWS)
def test_ell_bwd_wide_rows_match_plain(dev, kernel, dtype, heads, c):
    """C' (+ F (b)) and D' on rows wider than the untiled instances hold
    (column tiles) vs autograd of the plain version, at TOL / GRAD_TOL,
    each launched once (no plain version behind the CUDA entry)."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    if kernel == "C'":
        kw = _ell_inputs(dev, 1024, 8, heads, c)
        kw = _bf16(kw) if dtype == torch.bfloat16 else kw
        dmask = _ell_dmask(kw, heads)
        n0 = ef.bwd_launches
        out, grads, g = _ell_train_run(ef.ell_gat_fused_train, kw,
                                       dmask=dmask)
        assert ef.bwd_launches == n0 + 1
        ref, rgrads, _ = _ell_train_run(ef.ell_gat_reference, kw, g,
                                        dmask=dmask)
        extra = None
    else:
        kw = _banded_inputs(dev, 1024, 8, heads, c, 128, drop=True)
        kw = _bf16(kw) if dtype == torch.bfloat16 else kw
        n0 = eb.v2_bwd_launches
        out, grads, g = _v2_run(eb.ell_gat_fused_v2, kw)
        assert eb.v2_bwd_launches == n0 + 1
        ref, rgrads, _ = _v2_run(eb.fused_v2_reference, kw, g)
        extra = _v2_extra(kw, g, dtype)
    err = ((out.float() - ref.float()).abs()
           / (1 + ref.float().abs())).max().item()
    assert err <= TOL[dtype], err
    _grads_close(grads, rgrads, dtype, extra)


@pytest.mark.parametrize("kernel", ["C'", "D'"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_bwd_gradients_repeat_bit_for_bit(dev, kernel, dtype):
    """No atomics: two calls of C' (with F (b)) or D' on the same inputs
    give every gradient bit for bit, at the model's shapes."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    if kernel == "C'":
        kw = _ell_inputs(dev, 8192, 8, 4, 64)
        kw = _bf16(kw) if dtype == torch.bfloat16 else kw
        dmask = _ell_dmask(kw, 4)
        runs = [_ell_train_run(ef.ell_gat_fused_train, kw, dmask=dmask)]
        runs.append(_ell_train_run(ef.ell_gat_fused_train, kw, runs[0][2],
                                   dmask=dmask))
    else:
        kw = _banded_inputs(dev, 8192, 8, 4, 64, 128, drop=True)
        kw = _bf16(kw) if dtype == torch.bfloat16 else kw
        runs = [_v2_run(eb.ell_gat_fused_v2, kw)]
        runs.append(_v2_run(eb.ell_gat_fused_v2, kw, runs[0][2]))
    (_, g1, _), (_, g2, _) = runs
    for name in g1:
        assert torch.equal(g1[name], g2[name]), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["no spills", "full band"])
def test_v2_bwd_spill_tables(dev, dtype, case):
    """Kernel D' on a graph with no spilled edge (one band: every source
    in its window) and with the spill tables exactly as wide as the
    fullest band's spills: the gradients vs autograd of the plain version,
    and D''s spill cotangents written in full, 0 at every dead entry."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb

    n = 2048
    r = n if case == "no spills" else 128
    kw = _banded_inputs(dev, n, 8, 4, 16, r, drop=True,
                        full_band=case == "full band")
    kw = _bf16(kw) if dtype == torch.bfloat16 else kw
    b = kw["banded"]
    live = b.spill_dst_local_b.reshape(-1) >= 0
    if case == "no spills":
        assert not live.any()
    else:
        assert bool((b.spill_dst_local_b >= 0).all(-1).any())
    out, grads, g = _v2_run(eb.ell_gat_fused_v2, kw)
    ref, rgrads, _ = _v2_run(eb.fused_v2_reference, kw, g)
    err = ((out.float() - ref.float()).abs()
           / (1 + ref.float().abs())).max().item()
    assert err <= TOL[dtype], err
    _grads_close(grads, rgrads, dtype, _v2_extra(kw, g, dtype))

    xh = kw["xh"].reshape(n, -1)
    l_s, xs = eb._spill_inputs(xh, kw["a_src"], kw["a_dst"], kw["m_edge"],
                               b, 0.2, eb._plain_gather)
    args = eb.kernel_args(xh, kw["a_cat_mat"], b.loc_t, kw["el_t"],
                          kw["el_self_t"], l_s.detach(), xs.detach(),
                          b.spill_dst_local_b, *kw["dropout_masks"],
                          band_rows=r)
    del args["vec"]
    # every float buffer the wrapper allocates starts as NaN: an entry the
    # kernel leaves unwritten shows
    empty = torch.empty

    def nan_empty(*size, **kw):
        t = empty(*size, **kw)
        return t.fill_(float("nan")) if t.is_floating_point() else t

    with mock.patch.object(torch, "empty", nan_empty):
        _, _, _, _, dl_sp, dxh_sp = eb.call_v2_bwd_kernel(
            **args, dout=g.contiguous(), perm=b.band_perm.int(),
            row_ptr=b.band_row_ptr.int(), sp_perm=b.spill_perm_d.int(),
            sp_row_ptr=b.spill_row_ptr_d.int())
    t_count, heads, s_max = dl_sp.shape
    assert torch.isfinite(dl_sp).all() and torch.isfinite(dxh_sp).all()
    dead = ~live.reshape(t_count, s_max)
    assert not dl_sp.permute(0, 2, 1)[dead].any()
    assert not dxh_sp[dead].any()


# -- the redesigned forwards: kernels C and E at the edges of what they take --
# Kernel C takes every K its first version took (ell_gat_fwd_warps_per_block
# >= 1: up to 1364 slots at 8 heads, 6143 at 1 head), heads 1-8 (3 and 5
# are not powers of two), C % 4 != 0 (single columns) and any HC (rows past
# a column tile: HC 1030 in single columns, 1200 and 4096 in 16-byte
# chunks); kernel E K up to 64 (the wrapper's limit) and the same heads and
# widths. Dead slots name padded nodes whose rows are NaN: a row no live
# slot names is never read. Tolerances are TOL of the other tests.

C_EDGES = [
    (300, 1, 1, 64),      # K 1
    (300, 5, 3, 8),       # K 5, 3 heads (pairs of stride 4)
    (200, 16, 5, 12),     # 5 heads (stride 8): 128 pairs, 4 pair tiles
    (300, 33, 8, 4),      # K 33: two ballots, 264 pairs
    (64, 1364, 8, 4),     # the first version's largest K at 8 heads
    (32, 6143, 1, 4),     # ... and at 1 head
    (500, 8, 2, 6),       # C % 4 != 0: single columns
    (300, 8, 1, 1030),    # C % 4 != 0, HC > 1024: 17 column tiles
    (300, 8, 2, 600),     # HC 1200 in 16-byte chunks: several tiles
    (200, 8, 4, 1024),    # HC 4096
]


def _edge_ell_inputs(dev, n, k, heads, c, seed=0, dtype=torch.float32):
    """A random ELL graph of n nodes (the last n / 16 padded, the first 3
    with no live slot, ~70 % of the other slots live) whose dead slots name
    padded nodes with NaN rows; layer inputs from ``seed``."""
    rg = np.random.default_rng(seed)
    n_pad = max(1, n // 16)
    n_live = n - n_pad
    nbr = rg.integers(0, n_live, (n, k))
    mask = rg.random((n, k)) < 0.7
    mask[:3] = False
    mask[n_live:] = False
    nbr = np.where(mask, nbr, n_live + rg.integers(0, n_pad, (n, k)))
    gen = torch.Generator().manual_seed(seed)
    hc = heads * c

    def rnd(*shape, s=1.0):
        return (torch.randn(*shape, generator=gen) * s).to(dev)

    xh = rnd(n, hc)
    xh[n_live:] = float("nan")
    return dict(xh=xh.to(dtype), att_src=rnd(1, heads, c, s=0.3),
                att_dst=rnd(1, heads, c, s=0.3),
                nbr_src=torch.from_numpy(nbr).int().to(dev),
                nbr_mask=torch.from_numpy(mask).to(dev),
                el=rnd(n, k, heads), el_self=rnd(n, heads),
                bias=rnd(hc, s=0.1),
                node_mask=(torch.arange(n) < n_live).to(dev))


def _close_to_plain(out, ref, dtype, live):
    out, ref = out.float()[live], ref.float()[live]
    assert torch.isfinite(out).all()
    err = ((out - ref).abs() / (1 + ref.abs())).max().item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", C_EDGES)
def test_ell_kernel_edges_match_plain(dev, shape, dtype):
    """Kernel C (inference form) vs its plain version at the edge shapes,
    with and without a self loop; padded nodes 0, nodes with no live slot
    and no self loop the bias alone."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    n, k, heads, c = shape
    kw = _edge_ell_inputs(dev, n, k, heads, c, dtype=dtype)
    live = kw["node_mask"]
    for self_loop in (True, False):
        with torch.no_grad():
            n0 = ef.launches
            out = ef.ell_gat_fused(**kw, self_loop=self_loop)
            torch.cuda.synchronize()
            assert ef.launches == n0 + 1
            ref = ef.ell_gat_reference(**kw, self_loop=self_loop)
        assert out.dtype == dtype
        _close_to_plain(out, ref, dtype, live)
        assert not out[~live].float().any()
        if not self_loop:
            assert torch.equal(out[:3], kw["bias"].to(dtype).expand(3, -1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 8, 4, 64), (4096, 8, 1, 64),
                                   (300, 33, 8, 4), (500, 8, 3, 6)])
def test_ell_kernel_drop_modes(dev, shape, dtype):
    """Kernel C's training form in its three dropout modes: none and a
    streamed mask against the plain version; the Philox draw (mode 2)
    equal, bit for bit, to mode 1 fed the same draw as its mask
    (``drop_mask``)."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    n, k, heads, c = shape
    kw = _edge_ell_inputs(dev, n, k, heads, c, seed=1, dtype=dtype)
    live = kw["node_mask"]
    seed = torch.tensor([987654321], dtype=torch.int64, device=dev)
    mask = ef.drop_mask(seed, 0.9, n, k, heads)
    with torch.no_grad():
        n0 = ef.train_launches
        out0 = ef.call_kernel(**ef.kernel_args(**kw, train=True))
        out1 = ef.call_kernel(**ef.kernel_args(**kw, dmask=mask, train=True))
        out2 = ef.call_kernel(**ef.kernel_args(**kw, drop_seed=seed,
                                               keep_prob=0.9, train=True))
        torch.cuda.synchronize()
        assert ef.train_launches == n0 + 3
        ref0 = ef.ell_gat_reference(**kw)
        ref1 = ef.ell_gat_reference(**kw, dmask=mask)
    _close_to_plain(out0, ref0, dtype, live)
    _close_to_plain(out1, ref1, dtype, live)
    assert torch.equal(out2, out1)
    assert not torch.equal(out1, out0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4096, 8, 4, 64), (4096, 8, 1, 64),
                                   (1000, 8, 2, 6)])
def test_ell_bwd_with_saved_dots_bit_for_bit(dev, shape, dtype):
    """Kernel C' given the attention dots kernel C wrote returns the same
    bits as C' computing its own, and those dots are the dots pass's."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
    from bathymetric_gnn_tpu_torch.ops.ell import src_sorted_slots

    n, k, heads, c = shape
    kw = _ell_inputs(dev, n, k, heads, c)
    kw = _bf16(kw) if dtype == torch.bfloat16 else kw
    seed = torch.tensor([424242], dtype=torch.int64, device=dev)
    args = ef.kernel_args(**kw, drop_seed=seed, keep_prob=0.9, train=True)
    dots = torch.empty(n, 2 * heads, device=dev)
    ef.call_kernel(**args, dots=dots)
    bkw = {nm: args[nm] for nm in (
        "xh", "att", "nbr", "nmask", "el", "el_self", "node_mask", "dmask",
        "seed", "n", "k", "heads", "c", "negative_slope", "has_self",
        "drop_mode", "thresh", "keep_inv", "dtype")}
    perm, row_ptr = (torch.from_numpy(t).int().to(dev) for t in
                     src_sorted_slots(kw["nbr_src"].cpu().numpy(),
                                      kw["nbr_mask"].cpu().numpy(),
                                      kw["node_mask"].cpu().numpy()))
    g = torch.randn(n, heads * c, generator=torch.Generator().manual_seed(4)
                    ).to(dev, dtype)
    n0 = ef.bwd_launches
    given = ef.call_bwd_kernel(**bkw, perm=perm, row_ptr=row_ptr, g=g,
                               dots=dots)
    own = ef.call_bwd_kernel(**bkw, perm=perm, row_ptr=row_ptr, g=g)
    torch.cuda.synchronize()
    assert ef.bwd_launches == n0 + 2
    for a, b in zip(given, own):
        assert torch.equal(a, b)
    assert torch.equal(dots, ef.attention_dots(args["xh"], args["att"],
                                               heads))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 2, 3, 4, 8])
def test_ell_dots_keep_the_first_versions_bits(dev, heads, dtype):
    """The dots pass of kernels C and C' (node_dots_kernel) gives the bits
    of the one-node-a-warp dots_kernel it replaced where a head has at most
    64 channels (past that the generic kernel runs itself)."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    gen = torch.Generator().manual_seed(heads)
    for c in (1, 6, 32, 33, 64, 65):
        hc = heads * c
        xh = torch.randn(3001, hc, generator=gen).to(dev, dtype)
        att = (0.3 * torch.randn(2, hc, generator=gen)).to(dev, dtype)
        new = ef.attention_dots(xh, att, heads)
        old = ef.attention_dots(xh, att, heads, generic=True)
        torch.cuda.synchronize()
        assert torch.equal(new, old), (c, (new - old).abs().max().item())
        want = (xh.float().reshape(3001, heads, c)
                * att.float().reshape(2, 1, heads, c)).sum(-1)
        torch.testing.assert_close(new, torch.cat([want[0], want[1]], 1),
                                   rtol=1e-4, atol=1e-4)


E_EDGES = [
    (1024, 1, 1, 64, 128),     # K 1
    (1024, 5, 3, 8, 64),       # K 5, 3 heads
    (1024, 33, 8, 4, 64),      # K 33 at 8 heads
    (512, 64, 8, 4, 128),      # K 64 (the wrapper's limit) at 8 heads
    (1024, 8, 2, 6, 128),      # C % 4 != 0
    (1024, 8, 1, 1030, 128),   # C % 4 != 0, HC > 1024
    (512, 8, 4, 1024, 128),    # HC 4096
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", E_EDGES)
def test_band_kernel_edges_match_plain(dev, shape, dtype):
    """Kernel E vs its plain version at the edge shapes, with and without a
    self loop; the padded nodes' rows are NaN (no in-band slot names them;
    their own outputs are left out of the comparison)."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb

    n, k, heads, c, r = shape
    live = torch.arange(n, device=dev) < n - n // 16
    for self_loop in (True, False):
        kw = _banded_inputs(dev, n, k, heads, c, r, self_loop=self_loop)
        xh = kw["xh"].clone()
        xh[~live] = float("nan")
        args = (xh.to(dtype), kw["a_cat_mat"], kw["el_t"], kw["el_self_t"],
                kw["banded"])
        with torch.no_grad():
            n0 = eb.band_launches
            got = eb.ell_gat_band_part(*args)
            torch.cuda.synchronize()
            assert eb.band_launches == n0 + 1
            want = eb.band_part_reference(*args)
        for name, a, b in zip(("y", "m", "denom"), got, want):
            assert a.dtype == torch.float32, name
            a, b = a[live], b[live]
            assert torch.isfinite(a).all(), name
            err = ((a - b).abs() / (1 + b.abs())).max().item()
            assert err <= TOL[torch.float32], (name, err)


# -- the redesigned kernel D and its dots, at the edges of what they take -----
# Kernel D (ell_gat_v2_fwd.cu, on E's forward layout, the spills visited by
# destination) takes every shape its first version took: K up to the
# wrapper's 64 (at 8 heads), heads 1-8 (3 and 5 not powers of two), C % 4
# != 0 (single columns), any HC (column tiles: HC 1030 in single columns,
# 1200 and 4096 in 16-byte chunks), any s_max. The graphs of
# test_torch_ell_v2_fwd_design.spill_graph hold a band filled to s_max,
# bands with no spill, a row whose every slot spilled, rows with no live
# slot, and dead slots naming padded nodes whose rows are NaN. Tolerances
# are TOL of the other tests.

V2_EDGES = [
    (1024, 1, 1, 64, 64),      # K 1
    (1024, 5, 3, 8, 64),       # K 5, 3 heads (pairs of stride 4)
    (1024, 16, 4, 64, 64),     # K 16 at HC 256
    (1024, 33, 8, 4, 64),      # K 33 at 8 heads: several pair tiles
    (512, 64, 8, 4, 64),       # K 64 (the wrapper's limit) at 8 heads
    (1024, 8, 2, 6, 128),      # C % 4 != 0: single columns
    (1024, 8, 1, 1030, 128),   # C % 4 != 0, HC > 1024: column tiles
    (512, 8, 2, 600, 64),      # HC 1200 in 16-byte chunks: several tiles
    (512, 8, 4, 1024, 64),     # HC 4096
]


def _v2_edge_inputs(dev, shape, dtype, self_loop, drop, full_band=True):
    from test_torch_ell_v2_fwd_design import v2_inputs

    n, k, heads, c, r = shape
    args, banded, live = v2_inputs(k, heads, c, dtype, self_loop=self_loop,
                                   drop=drop, n=n, r=r, full_band=full_band)
    args = {nm: (t.to(dev) if torch.is_tensor(t) else t)
            for nm, t in args.items()}
    return args, banded.to(dev), live.to(dev)


def _v2_call(args, banded, **extra):
    """Kernel D through call_v2_kernel on the _v2_plain arguments."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb

    kw = eb.kernel_args(
        args["xh_flat"], args["a_cat_mat"], args["loc_t"], args["el_t"],
        args["el_self_t"], args["l_spill_b"], args["xh_spill_b"],
        args["dst_loc_b"], args["dmask_t"], args["dmask_sp_b"],
        band_rows=banded.band_rows, spill_perm_d=extra.pop(
            "sp_perm", banded.spill_perm_d),
        spill_row_ptr_d=extra.pop("sp_row_ptr", banded.spill_row_ptr_d))
    return eb.call_v2_kernel(**kw, **extra), kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", V2_EDGES)
def test_v2_kernel_edges_match_plain(dev, shape, dtype):
    """Kernel D vs _v2_plain at the edge shapes, with and without a self
    loop and streamed dropout masks, the spill tables as wide as the
    fullest band; the padded nodes' own outputs are left out."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb

    for self_loop in (True, False):
        for drop in (False, True):
            args, banded, live = _v2_edge_inputs(dev, shape, dtype,
                                                 self_loop, drop)
            with torch.no_grad():
                n0 = eb.v2_launches
                out, _ = _v2_call(args, banded)
                torch.cuda.synchronize()
                assert eb.v2_launches == n0 + 1
                ref = eb._v2_plain(**args, band_rows=banded.band_rows)
            assert out.dtype == dtype
            _close_to_plain(out, ref, dtype, live)
            if not self_loop:
                assert not out[:3].float().any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["no spill", "crowded row",
                                  "stray entries", "default s_max"])
def test_v2_kernel_spill_tables(dev, dtype, case):
    """Kernel D's spill entries by destination: no spill entry at all; a
    row with 2K + 3 entries (K listed, the rest visited one by one); tables
    that list for a row an entry whose dst_loc names another row and one
    from another band (skipped); band_ell's power-of-two s_max."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
    from test_torch_ell_v2_fwd_design import spill_case_tables

    n, k, r = 2048, 8, 64
    args, banded, live = _v2_edge_inputs(
        dev, (n, k, 4, 64, r), dtype, True, True,
        full_band=case != "default s_max")
    extra = {}
    if case != "default s_max":
        dl, perm, row_ptr = spill_case_tables(args["dst_loc_b"].cpu(), case,
                                              k, r)
        args["dst_loc_b"] = dl.to(dev)
        extra = dict(sp_perm=perm.to(dev), sp_row_ptr=row_ptr.to(dev))
    with torch.no_grad():
        out, _ = _v2_call(args, banded, **extra)
        ref = eb._v2_plain(**args, band_rows=r)
    _close_to_plain(out, ref, dtype, live)


def _same_bits(a, b):
    """a and b hold the same bits (NaN included: the padded nodes' rows)."""
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    return a.dtype == b.dtype and torch.equal(a.view(ints[a.dtype]),
                                              b.view(ints[b.dtype]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_v2_kernel_repeat_bit_for_bit(dev, dtype):
    """Kernel D over two calls on the same inputs (streamed dropout, the
    model's HC 256 / 4 heads): the same bits."""
    args, banded, _ = _v2_edge_inputs(dev, (8192, 8, 4, 64, 128), dtype,
                                      True, True)
    with torch.no_grad():
        a, _ = _v2_call(args, banded)
        b, _ = _v2_call(args, banded)
    assert _same_bits(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,c", [(4, 64), (1, 64), (2, 6), (8, 4)])
def test_v2_bwd_with_saved_dots_bit_for_bit(dev, heads, c, dtype):
    """Kernel D' given the attention dots kernel D wrote returns every
    gradient with the same bits as D' computing its own, and those dots
    are the generic dots pass's."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb

    args, banded, _ = _v2_edge_inputs(dev, (2048, 8, heads, c, 64), dtype,
                                      True, True)
    ac = torch.empty(2048, 2 * heads, device=dev)
    _, kw = _v2_call(args, banded, ac=ac)
    bkw = {nm: kw[nm] for nm in (
        "xh", "acat", "loc", "el", "el_self", "l_spill", "xh_spill",
        "dst_loc", "dmask", "dmask_sp", "sp_perm", "sp_row_ptr", "n", "k",
        "heads", "c", "r", "s_max", "negative_slope", "dtype")}
    g = torch.randn(2048, heads * c, generator=torch.Generator(
        ).manual_seed(5)).to(dev, dtype)
    tables = dict(perm=banded.band_perm.int(),
                  row_ptr=banded.band_row_ptr.int())
    n0 = eb.v2_bwd_launches
    given = eb.call_v2_bwd_kernel(**bkw, **tables, dout=g, ac=ac)
    own = eb.call_v2_bwd_kernel(**bkw, **tables, dout=g)
    torch.cuda.synchronize()
    assert eb.v2_bwd_launches == n0 + 2
    for a, b in zip(given, own):
        assert (a is None and b is None) or _same_bits(a, b)
    assert _same_bits(ac, eb.mat_dots(kw["xh"], kw["acat"], generic=True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 4, 8])
def test_mat_dots_keep_the_first_versions_bits(dev, heads, dtype):
    """The attention dots of kernels D, D' and E (the register form where
    it takes the row) give the bits of the generic form they replaced
    (mat_dots_kernel, staged at HC >= 128), at HC 64, 256 and 1024 and
    widths between (HC 6: most lanes hold no column; 40, 100 and 200:
    partial column steps of each register form)."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb

    gen = torch.Generator().manual_seed(heads)
    for hc in (64, 256, 1024, 6, 40, 100, 200):
        xh = torch.randn(3001, hc, generator=gen).to(dev, dtype)
        acat = (0.3 * torch.randn(hc, 2 * heads, generator=gen)
                ).to(dev, dtype)
        new = eb.mat_dots(xh, acat)
        old = eb.mat_dots(xh, acat, generic=True)
        torch.cuda.synchronize()
        assert torch.equal(new, old), (hc, (new - old).abs().max().item())
        torch.testing.assert_close(new, xh.float() @ acat.float(),
                                   rtol=1e-4, atol=1e-4)


# -- the COO path: kernel F behind its segment sums and gathers (-k coo) ----

def _coo_batch(dev, tiles=3, side=48, seed=0, src_table=True):
    """Grid-connectivity graphs of ``tiles`` random tiles with 5 % holes,
    batched into one padded graph (pads at N - 1), as a CooGraph on
    ``dev`` and on the CPU."""
    from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
    from bathymetric_gnn_tpu_torch.ops.graph import CooGraph, batch_graphs

    rg = np.random.default_rng(seed)
    gb = GraphBuilder()
    parts = []
    for _ in range(tiles):
        depth = (30 + rg.normal(0, 0.3, (side, side)).cumsum(1)
                 ).astype(np.float32)
        valid = rg.random((side, side)) > 0.05
        bg = gb.build_graph(np.where(valid, depth, np.nan), valid)
        g, n = bg.graph, bg.num_nodes
        parts.append((g.x[:n], np.stack([g.edge_src, g.edge_dst])[
            :, g.edge_mask], g.edge_attr[g.edge_mask]))
    n_pad = 1 << (sum(p[0].shape[0] for p in parts) - 1).bit_length()
    graph, _ = batch_graphs(parts, n_pad=n_pad, e_pad=n_pad * 8)
    c = CooGraph.from_padded(graph, src_table=src_table)
    return c.to(dev), c.to("cpu")


@pytest.mark.parametrize("width", [1, 3, 4, 256])
def test_coo_segment_ops_match_plain(dev, width):
    """segment_sum over the destination table and a gather's backward over
    the source table: kernel F on the card against its plain version on
    the CPU (f32, other summation order: 1e-5 of the scale), and two calls
    bit for bit."""
    from bathymetric_gnn_tpu_torch.ops import segment as seg
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    g, gc = _coo_batch(dev)
    e, n = g.edge_src.shape[0], g.x.shape[0]
    gen = torch.Generator().manual_seed(width)
    data = torch.randn(e, width, generator=gen)
    x = torch.randn(n, width, generator=gen)
    out = []
    for gg, d, xx in ((g, data.to(dev), x.to(dev)), (gc, data, x)):
        n0 = sr.launches
        s = seg.segment_sum(d, gg.edge_dst, n, gg.edge_mask, gg.dst_table)
        s2 = seg.segment_sum(d, gg.edge_dst, n, gg.edge_mask, gg.dst_table)
        xg = xx.clone().requires_grad_(True)
        (seg.gather(xg, gg.edge_src, gg.src_table)
         * torch.where(gg.edge_mask[:, None], d, 0.0)).sum().backward()
        if gg is g:
            torch.cuda.synchronize()
            assert sr.launches - n0 == 3
            assert torch.equal(s, s2)
        out.append((s.cpu(), xg.grad.cpu()))
    for a, b in zip(*out):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-5 * max(scale, 1.0)


@pytest.mark.parametrize("gnn_type", ["GAT", "GCN", "GraphSAGE", "GIN"])
def test_coo_forward_and_train_step_repeat_bit_for_bit(dev, gnn_type):
    """The COO model at full width: two forwards, and two train steps
    (dropout 0.1 from the same generator seed, AdamW) from the same state,
    give the same bits; the forward agrees with the CPU's (classes >= 99 %,
    confidence within 2e-3) and launches kernel F."""
    import copy

    from bathymetric_gnn_tpu_torch.config.config import ModelConfig
    from bathymetric_gnn_tpu_torch.models.gnn import make_model
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr
    from bathymetric_gnn_tpu_torch.training.optim import AdamW

    g, gc = _coo_batch(dev, seed=1)
    cfg = ModelConfig(gnn_type=gnn_type)
    base = make_model(cfg, g.x.shape[-1], dropout=0.1,
                      generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want = copy.deepcopy(base).eval()(gc)
        model = copy.deepcopy(base).to(dev).eval()
        n0 = sr.launches
        a, b = model(g), model(g)
        assert sr.launches > n0
    for k in a:
        assert torch.equal(a[k], b[k]), k
    agree = (a["predicted_class"].cpu() == want["predicted_class"]).float()
    assert agree.mean().item() >= 0.99
    assert (a["confidence"].cpu() - want["confidence"]).abs().max() <= 2e-3

    def step():
        m = copy.deepcopy(base).to(dev).train()
        opt = AdamW(m.parameters(), 1e-4)
        rng = torch.Generator(device=dev).manual_seed(5)
        out = m(g, rng)
        loss = (out["class_logits"].square().mean()
                + out["confidence"].mean() + out["correction"].abs().mean())
        loss.backward()
        opt.step([p.grad for p in m.parameters()], 1e-3)
        return loss.detach(), [p.detach().clone() for p in m.parameters()]

    (l1, p1), (l2, p2) = step(), step()
    assert torch.equal(l1, l2)
    assert all(torch.equal(u, v) for u, v in zip(p1, p2))


@pytest.mark.parametrize("name", ["GCNConvELL", "SAGEConvELL",
                                  "GINConvELL"])
def test_coo_ell_convs_card_vs_cpu(dev, name):
    """The plain GCN / SAGE / GIN ELL layers (torch ops on both devices)
    on the card against the CPU: f32 sums over <= 8 slots and products in
    another order, 1e-5 of the scale."""
    from bathymetric_gnn_tpu_torch.models import conv_ell
    from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell
    from bathymetric_gnn_tpu_torch.ops.graph import make_padded_graph

    rg = np.random.default_rng(2)
    n = 5000
    src, dst = rg.integers(0, n, n * 8), rg.integers(0, n, n * 8)
    order = np.argsort(dst, kind="stable")
    src, dst = src[order], dst[order]
    keep = (np.arange(dst.size) - np.searchsorted(dst, dst)) < 8
    g = coo_to_ell(make_padded_graph(
        rg.normal(size=(n, 7)).astype(np.float32),
        np.stack([src[keep], dst[keep]]), None, n_pad=8192,
        e_pad=8192 * 8), max_degree=8)
    layer = getattr(conv_ell, name)(64, 64,
                                    generator=torch.Generator().manual_seed(1))
    x = torch.randn(8192, 64, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        want = layer(g.to("cpu"), x)
        got = layer.to(dev)(g.to(dev), x.to(dev)).cpu()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


# -- kernel F's mode (a) at every row form (-k segment_narrow) ---------------

def _segment_case(n, width, dtype, seed=0):
    """Segments of 0, 1, 8 and 40 slots, then random lengths 0..12; dead
    slots past row_ptr[n]; rows no live slot reads hold NaN."""
    rg = np.random.default_rng(seed + width)
    lens = np.concatenate([[0, 1, 8, 40, 0], rg.integers(0, 13, n - 5)])
    live = int(lens.sum())
    rows = live + 17
    perm = rg.permutation(rows)[:live + 9].astype(np.int32)
    ct = (3 * rg.normal(size=(rows, width))).astype(np.float32)
    unread = np.ones(rows, bool)
    unread[perm[:live]] = False
    ct[unread] = np.nan
    t = torch.from_numpy(ct).to(dtype)
    row_ptr = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    return t, torch.from_numpy(perm), torch.from_numpy(row_ptr)


@pytest.mark.parametrize("big", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [1, 2, 3, 4, 8, 64, 256, 260])
def test_segment_narrow_bits_match_in_order_sum(dev, width, dtype, big):
    """Kernel F (mode a) in every lane-group form (one lane a row up to a
    whole warp, column tiles past 256 f32 columns): the in-order sum's bits
    (segment_reduce_in_order), the same bits on a second call, within 1e-5
    (1 + |ref|) of index_add_; empty segments, a 40-slot one, dead slots,
    n not a multiple of the rows a warp carries, and (``big``) more rows
    than the resident lane groups hold, so the grid-stride loop turns."""
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    n = (300_001 if width <= 8 else 40_001) if big else 77
    ct, perm, row_ptr = (t.to(dev) for t in _segment_case(n, width, dtype))
    n0 = sr.launches
    out = sr.segment_reduce_sorted(ct, perm, row_ptr, n)
    again = sr.segment_reduce_sorted(ct, perm, row_ptr, n)
    torch.cuda.synchronize()
    assert sr.launches == n0 + 2
    want = sr.segment_reduce_in_order(ct, perm, row_ptr, n)
    assert out.dtype == torch.float32 and out.shape == (n, width)
    assert torch.equal(out, want)
    assert torch.equal(out, again)
    ref = sr.segment_reduce_reference(ct, perm, row_ptr, n)
    assert ((out - ref).abs() / (1 + ref.abs())).max().item() <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [4, 8, 64, 256])
def test_segment_narrow_scalar_columns_when_misaligned(dev, width, dtype):
    """A cotangent 4 bytes past a 16-byte boundary takes the scalar-column
    forms (one lane up to 8 columns, else the warp in 64-column tiles):
    the same bits as the in-order sum."""
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    ct, perm, row_ptr = _segment_case(1003, width, dtype)
    ct = ct.to(dev)
    # .to() copies into a fresh (aligned) buffer: shift it on the card
    buf = torch.empty(ct.numel() + 1, dtype=dtype, device=dev)
    ct = buf[1:].view(ct.shape).copy_(ct)
    assert ct.data_ptr() % 16 != 0
    perm, row_ptr = perm.to(dev), row_ptr.to(dev)
    out = sr.segment_reduce_sorted(ct, perm, row_ptr, 1003)
    torch.cuda.synchronize()
    assert torch.equal(out, sr.segment_reduce_in_order(ct, perm, row_ptr,
                                                       1003))


def test_segment_narrow_rejects_what_it_does_not_take(dev):
    """The wrapper refuses a cotangent that is not [S, F] f32 / bf16, a
    row_ptr of the wrong length, and tables on another device, before any
    launch."""
    from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr

    ct, perm, row_ptr = (t.to(dev) for t in _segment_case(77, 4,
                                                          torch.float32))
    n0 = sr.launches
    for args in ((ct.double(), perm, row_ptr, 77),
                 (ct[:, 0], perm, row_ptr, 77),
                 (ct, perm, row_ptr[:-1], 77),
                 (ct, perm.cpu(), row_ptr, 77),
                 (ct, perm, row_ptr, 0)):
        with pytest.raises(ValueError):
            sr.call_kernel(*args)
    assert sr.launches == n0
