"""The CUDA kernels vs their plain PyTorch versions, on the card: kernel A
in its inference and training forms, kernel B against autograd of the
plain forward, and the in-kernel Philox dropout draw; kernel C (the GAT
layer on ELL graphs) in its inference and dropout forms, kernel C'
against autograd of the plain forward, and kernel F (the sorted-segment
reduction) against ``index_add_``; kernels E (the banded band part), D
(the fused banded layer) and D' (its backward, with F's mode (a) behind
its spill gathers) against their plain versions and autograd of them.

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


@pytest.mark.parametrize("kernel", ["C'", "D'"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ell_bwd_refuses_rows_past_the_templates(dev, kernel, dtype):
    """A row wider than the row templates hold (HC 1026 with C % 4 != 0:
    33 single columns a lane, past 32) is refused with the limits named,
    not run and not sent to the plain version."""
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    if kernel == "C'":
        kw = _ell_inputs(dev, 1024, 8, 2, 513)
        kw = _bf16(kw) if dtype == torch.bfloat16 else kw
        n0 = ef.bwd_launches
        with pytest.raises(ValueError, match="a row wider than the kernel "
                           "takes .HC <= 1024 when C is not a multiple"):
            _ell_train_run(ef.ell_gat_fused_train, kw)
        assert ef.bwd_launches == n0
    else:
        kw = _banded_inputs(dev, 1024, 8, 2, 513, 128)
        kw = _bf16(kw) if dtype == torch.bfloat16 else kw
        n0 = eb.v2_bwd_launches
        with pytest.raises(ValueError, match="a row wider than the kernel "
                           "takes .HC <= 1024 when C is not a multiple"):
            _v2_run(eb.ell_gat_fused_v2, kw)
        assert eb.v2_bwd_launches == n0


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
