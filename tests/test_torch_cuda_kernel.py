"""The grid-GAT CUDA kernels vs their plain PyTorch versions, on the card:
kernel A in its inference and training forms, kernel B against autograd
of the plain forward, and the in-kernel Philox dropout draw.

Marked ``cuda``: every test skips where ``torch.cuda.is_available()`` is
false (the CPU test runs). On a machine with an H100 and nvcc:
``python -m pytest --noconftest tests/test_torch_cuda_kernel.py``
(``--noconftest``: ``tests/conftest.py`` imports jax, which this file does
not need). The kernel is built from ``bathymetric_gnn_tpu_torch/csrc`` on
first use.
"""

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
    from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef

    kw = _ell_inputs(dev, 512, 8, 4, 16)
    kw["xh"].requires_grad_()
    with pytest.raises(RuntimeError, match="C'"):
        ef.ell_gat_fused(**kw)
    kw["xh"] = kw["xh"].detach()
    with torch.no_grad():
        with pytest.raises(ValueError, match="float32"):
            ef.ell_gat_fused(**{**kw, "xh": kw["xh"].bfloat16()})
        with pytest.raises(ValueError, match="heads"):
            ef.ell_gat_fused(**{**kw, "att_src": kw["att_src"].reshape(
                1, 16, 4), "att_dst": kw["att_dst"].reshape(1, 16, 4),
                "el": None, "el_self": None})


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
