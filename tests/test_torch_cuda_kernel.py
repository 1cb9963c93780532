"""The grid-GAT CUDA kernel vs its plain PyTorch version, on the card.

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
        dict(conv.named_parameters()), heads, c, 3)
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
        ref = gf.grid_gat_infer_reference(*args, **kw)
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
