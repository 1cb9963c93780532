"""PyTorch port vs JAX: the fused grid-GAT layer's training form.

On the CPU the port's ``fused_grid_gat`` runs its plain version
(``grid_gat_reference``) and autograd differentiates it; on the card the
same entry runs kernels A and B, held against this plain version by
tests/test_torch_cuda_kernel.py and chip_smoke.py. Here the plain version
goes against the JAX ``fused_grid_gat`` run as tests/test_pallas_fused.py
runs it on the CPU: the Pallas kernels in interpret mode at a
kernel-eligible shape (block_rows 8, width 128), the XLA fallback on a
ragged height. The same numpy inputs and the same pinned dropout mask go
to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.data.graph_build import build_grid_inputs
from bathymetric_gnn_tpu.models.grid_gat import GridGATConv
from bathymetric_gnn_tpu.ops.pallas import grid_gat_fused as jf
from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as tf

from conftest import make_ramp_surface

torch.set_num_threads(2)

LEAVES = ("x", "w_lin", "a_src", "a_dst", "m_edge", "bias")


def _setup(h, w, heads=4, c=16, f_in=16, connectivity=8, seed=0):
    rg = np.random.default_rng(seed)
    depth = make_ramp_surface(h, w, seed=seed)
    valid = np.ones((h, w), bool)
    valid[5:9, 10:40] = False
    valid[rg.random((h, w)) < 0.02] = False
    depth[~valid] = np.nan
    _, _, nbr, eattr, _ = build_grid_inputs(
        np.nan_to_num(depth).astype(np.float32), valid,
        connectivity=connectivity)
    x = rg.normal(size=(h, w, f_in)).astype(np.float32)
    x[~valid] = 0.0
    layer = GridGATConv(out_channels=c, heads=heads, edge_dim=3,
                        connectivity=connectivity)
    params = layer.init(jax.random.PRNGKey(seed), jnp.asarray(x), valid, nbr,
                        eattr)["params"]
    w_lin, a_src, a_dst, m_edge, _ = jf.gat_param_matrices(params, heads, c,
                                                           3)
    bias = rg.normal(0, 0.1, heads * c).astype(np.float32)
    k = nbr.shape[0]
    dmask = ((rg.random((k + 1, heads, h, w)) < 0.9) / 0.9).astype(
        np.float32)
    leaves = [x] + [np.array(a) for a in (w_lin, a_src, a_dst, m_edge)] + [
        bias]
    fixed = (np.array(eattr), np.array(nbr, np.float32),
             valid.astype(np.float32))
    return leaves, fixed, dmask


def _jax_loss(fixed, dmask, connectivity, dtype):
    eattr, nbr, valid = (jnp.asarray(a) for a in fixed)
    dm = None if dmask is None else jnp.asarray(dmask)

    def loss(x, w, a_s, a_d, me, b):
        o = jf.fused_grid_gat(x, w, a_s, a_d, me, eattr, nbr, valid, b, dm,
                              connectivity, 0.2, True, 8, True, dtype)
        return jnp.sum(o.astype(jnp.float32) ** 2), o
    return loss


def _port_grads(leaves, fixed, dmask, connectivity, dtype):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in leaves]
    eattr, nbr, valid = (torch.from_numpy(a) for a in fixed)
    out = tf.fused_grid_gat(
        ts[0], *ts[1:5], eattr, nbr, valid, ts[5], connectivity, 0.2, True,
        dmask=None if dmask is None else torch.from_numpy(dmask),
        compute_dtype=dtype)
    loss = out.float().square().sum()
    loss.backward()
    return out.detach().float().numpy(), [t.grad.numpy() for t in ts]


def test_forward_with_dmask_matches_pallas_interpret():
    """Plain forward with a pinned dmask vs the JAX Pallas kernel
    (interpret) at 32x128, f32: the same formulation, f32 accumulation in
    another order; tolerance 2e-4 (the Pallas tests' kernel tolerance)."""
    leaves, fixed, dmask = _setup(32, 128)
    _, want = _jax_loss(fixed, dmask, 8, jnp.float32)(
        *(jnp.asarray(a) for a in leaves))
    got, _ = _port_grads(leaves, fixed, dmask, 8, torch.float32)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-4, atol=2e-4)


# (dtype, with dmask, height, connectivity): height 32 runs the JAX Pallas
# kernels (interpret); height 30 is ragged and takes its XLA fallback.
CASES = [("float32", False, 32, 8), ("float32", True, 32, 8),
         ("float32", False, 30, 8), ("float32", True, 32, 4),
         ("bfloat16", False, 32, 8), ("bfloat16", True, 32, 8)]


@pytest.mark.parametrize("dtype,drop,h,conn", CASES)
def test_grads_match_jax(dtype, drop, h, conn):
    """Gradients of sum(out^2) w.r.t. x, W, a_src, a_dst, M_edge and bias:
    autograd of the port's plain version vs jax.grad of the JAX
    fused_grid_gat (its Pallas backward kernel in interpret mode, or the
    XLA vjp on the ragged height). f32: rtol/atol 1e-3, as
    tests/test_pallas_fused.py holds the Pallas backward. bf16: both round
    the layer's streams to bf16 but at different places in the backward
    (the Pallas kernel at its dot inputs, autograd at each cast), so each
    leaf within 3e-2 of its scale, the JAX bf16 backward tests' bound."""
    leaves, fixed, dmask = _setup(h, 128, connectivity=conn)
    dmask = dmask if drop else None
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    loss = _jax_loss(fixed, dmask, conn, jdt)
    want = jax.grad(lambda *a: loss(*a)[0], argnums=tuple(range(6)))(
        *(jnp.asarray(a) for a in leaves))
    _, got = _port_grads(leaves, fixed, dmask, conn, getattr(torch, dtype))
    for name, g, w in zip(LEAVES, got, want):
        w = np.asarray(w, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, rtol=1e-3, atol=1e-3,
                                       err_msg=name)
        else:
            scale = max(np.abs(w).max(), 1e-3)
            np.testing.assert_allclose(g / scale, w / scale, rtol=0,
                                       atol=3e-2, err_msg=name)


def test_batched_dmask_runs_each_tile():
    """A leading batch dimension with a per-tile dmask gives each tile's
    unbatched result (1e-6: the summation order of a batched product)."""
    tiles = [_setup(16, 24, heads=2, c=4, f_in=8, seed=s) for s in (1, 2)]
    leaves = [torch.from_numpy(a) for a in tiles[0][0][1:]]

    def run(x, fixed, dmask):
        eattr, nbr, valid = (torch.from_numpy(a) for a in fixed)
        return tf.fused_grid_gat(torch.from_numpy(x), *leaves[:4], eattr,
                                 nbr, valid, leaves[4],
                                 dmask=torch.from_numpy(dmask))

    batched = tf.fused_grid_gat(
        torch.from_numpy(np.stack([t[0][0] for t in tiles])), *leaves[:4],
        *(torch.from_numpy(np.stack([t[1][i] for t in tiles]))
          for i in range(3)), leaves[4],
        dmask=torch.from_numpy(np.stack([t[2] for t in tiles])))
    for b, t in enumerate(tiles):
        np.testing.assert_allclose(batched[b].detach().numpy(),
                                   run(t[0][0], t[1], t[2]).detach().numpy(),
                                   rtol=1e-6, atol=1e-6)


def test_infer_entry_raises_under_grad():
    """The inference entry has no backward: with grad mode on and an input
    that requires grad it raises instead of returning an output with no
    graph; under no_grad it runs."""
    leaves, fixed, _ = _setup(16, 24, heads=2, c=4, f_in=8)
    ts = [torch.from_numpy(a) for a in leaves]
    eattr, nbr, valid = (torch.from_numpy(a) for a in fixed)
    w = ts[1].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tf.fused_grid_gat_infer(ts[0], w, *ts[2:5], eattr, nbr, valid,
                                ts[5])
    with torch.no_grad():
        out = tf.fused_grid_gat_infer(ts[0], w, *ts[2:5], eattr, nbr, valid,
                                      ts[5])
    assert out.shape == (16, 24, 8)


def test_in_kernel_draw_needs_the_card():
    """On the CPU the dropout mask is streamed: a Philox seed raises."""
    leaves, fixed, _ = _setup(16, 24, heads=2, c=4, f_in=8)
    ts = [torch.from_numpy(a) for a in leaves]
    with pytest.raises(ValueError, match="only on the card"):
        tf.fused_grid_gat(ts[0], *ts[1:5],
                          *(torch.from_numpy(a) for a in fixed), ts[5],
                          drop_seed=torch.tensor([1]), keep_prob=0.9)
