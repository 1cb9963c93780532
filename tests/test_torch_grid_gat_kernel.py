"""PyTorch port vs JAX: the fused grid-GAT inference layer function.

On the CPU the port's ``fused_grid_gat_infer`` runs its plain version
(``grid_gat_reference``). It is held against the JAX
``_reference_forward`` (+ epilogue) and against the JAX Pallas kernel run
in interpret mode at a kernel-eligible shape (32x128, block_rows 8), as
tests/test_pallas_fused.py runs it; a ragged 30x100 tile goes against the
JAX fallback. The CUDA kernel itself is held against the plain version on
the card (tests/test_torch_cuda_kernel.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.data.graph_build import build_grid_inputs
from bathymetric_gnn_tpu.models.grid_gat import GridGATConv
from bathymetric_gnn_tpu.ops.edges import offsets_for_connectivity
from bathymetric_gnn_tpu.ops.pallas import grid_gat_fused as jf
from bathymetric_gnn_tpu_torch.ops.cuda import grid_gat_fused as tf

from conftest import make_ramp_surface

torch.set_num_threads(2)


def _setup(h, w, f_in, heads, c, connectivity=8, seed=0):
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
    layer = GridGATConv(out_channels=c, heads=heads, concat=heads > 1,
                        edge_dim=3, connectivity=connectivity)
    params = layer.init(jax.random.PRNGKey(seed), jnp.asarray(x), valid,
                        nbr, eattr)["params"]
    params = {k: np.array(v) for k, v in params.items()}
    params["bias"] = rg.normal(0, 0.1, params["bias"].shape).astype(
        np.float32)
    hc = heads * c
    bn = (rg.uniform(0.5, 1.5, hc).astype(np.float32),
          rg.normal(0, 0.1, hc).astype(np.float32))
    return params, x, valid, np.asarray(nbr), np.asarray(eattr), bn


def _jax_mats(params, heads, c):
    return jf.gat_param_matrices({k: jnp.asarray(v) for k, v in
                                  params.items()}, heads, c, 3)


def _port_out(params, x, valid, nbr, eattr, heads, c, connectivity=8,
              bn=None, relu=False, dtype=torch.float32):
    mats = tf.gat_param_matrices(
        {k: torch.from_numpy(v) for k, v in params.items()}, heads, c, 3)
    kw = dict(fuse_relu=relu, compute_dtype=dtype)
    if bn is not None:
        kw.update(bn_scale=torch.from_numpy(bn[0]),
                  bn_bias=torch.from_numpy(bn[1]))
    out = tf.fused_grid_gat_infer(
        torch.from_numpy(x), *mats[:4], torch.from_numpy(eattr),
        torch.from_numpy(nbr.astype(np.float32)),
        torch.from_numpy(valid.astype(np.float32)), mats[4], connectivity,
        0.2, True, **kw)
    return out.float().numpy()


def _jax_infer(params, x, valid, nbr, eattr, heads, c, connectivity=8,
               bn=None, relu=False, dtype=jnp.float32):
    w_lin, a_src, a_dst, m_edge, bias = _jax_mats(params, heads, c)
    kw = dict(fuse_relu=relu, compute_dtype=dtype)
    if bn is not None:
        kw.update(bn_scale=jnp.asarray(bn[0]), bn_bias=jnp.asarray(bn[1]))
    out = jf.fused_grid_gat_infer(
        jnp.asarray(x), w_lin, a_src, a_dst, m_edge, jnp.asarray(eattr),
        jnp.asarray(nbr, jnp.float32), jnp.asarray(valid, jnp.float32),
        bias, None, connectivity, 0.2, True, 8, True, **kw)
    return np.asarray(out, np.float32)


def test_param_matrices_match_jax():
    params, *_ = _setup(8, 16, 8, 4, 4)
    want = _jax_mats(params, 4, 4)
    got = tf.gat_param_matrices(
        {k: torch.from_numpy(v) for k, v in params.items()}, 4, 4, 3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


@pytest.mark.parametrize("connectivity", [4, 8])
def test_plain_matches_reference_forward(connectivity):
    """No epilogue: the plain version vs JAX ``_reference_forward``.
    f32 on both sides; the only difference is x @ (W @ a) vs
    (x @ W) @ a for the attention dots and the summation order, so
    2e-4 (the Pallas tests' kernel tolerance) holds with room."""
    params, x, valid, nbr, eattr, _ = _setup(30, 44, 16, 4, 8,
                                             connectivity)
    w_lin, a_src, a_dst, m_edge, bias = _jax_mats(params, 4, 8)
    want = np.asarray(jf._reference_forward(
        jnp.asarray(x), w_lin, a_src, a_dst, m_edge, jnp.asarray(eattr),
        jnp.asarray(nbr, jnp.float32), jnp.asarray(valid, jnp.float32),
        bias, offsets=offsets_for_connectivity(connectivity),
        negative_slope=0.2, use_edge=True))
    got = _port_out(params, x, valid, nbr, eattr, 4, 8, connectivity)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


# (heads, epilogue): heads 4 concat without and with BN + ReLU; heads 1
# (the model's last layer) with BN, with and without ReLU.
CASES = [(4, None), (4, "relu"), (1, "bn"), (1, "relu")]


@pytest.mark.parametrize("heads,epi", CASES)
def test_plain_matches_pallas_interpret_f32(heads, epi):
    """f32 at a kernel-eligible shape vs the Pallas kernel (interpret
    mode): same formulation, f32 accumulation, tolerance 2e-4."""
    c = 16
    params, x, valid, nbr, eattr, bn = _setup(32, 128, 16, heads, c)
    kw = dict(bn=bn if epi else None, relu=epi == "relu")
    want = _jax_infer(params, x, valid, nbr, eattr, heads, c, **kw)
    got = _port_out(params, x, valid, nbr, eattr, heads, c, **kw)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("heads,epi", CASES)
def test_plain_matches_pallas_interpret_bf16(heads, epi):
    """bf16 I/O vs the Pallas kernel (interpret): both round x, W, W@a,
    the edge logit terms and the output to bf16 at the same places and
    keep f32 inside. W@a and the edge terms are f32 products rounded to
    bf16; where the two frameworks' f32 products differ in the last bit,
    that rounding can flip (2^-8 relative on one logit term), and the
    output's own rounding can flip too. Measured: 2 of 262144 outputs off
    by 3 bf16 steps (1.5e-3 at 0.066). Bound: 1e-2 of max(|ref|, 1)."""
    c = 16
    params, x, valid, nbr, eattr, bn = _setup(32, 128, 16, heads, c)
    kw = dict(bn=bn if epi else None, relu=epi == "relu")
    want = _jax_infer(params, x, valid, nbr, eattr, heads, c,
                      dtype=jnp.bfloat16, **kw)
    got = _port_out(params, x, valid, nbr, eattr, heads, c,
                    dtype=torch.bfloat16, **kw)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
    assert err.max() < 1e-2, err.max()
    # and nearly all outputs agree to one bf16 rounding step
    assert np.mean(np.abs(got - want) <= 2 ** -7 * np.abs(want) + 1e-6) \
        > 0.999


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_tile_matches_jax_fallback(dtype):
    """A ragged 30x100 tile (no Pallas kernel in JAX: its XLA fallback).
    f32: 2e-4 as above. bf16: the fallback rounds only x and W, while the
    port (like the kernel) also rounds W@a and the edge logit terms, which
    moves the attention weights by ~1e-2 relative; outputs stay within 3%
    of max(|ref|, 1) (the Pallas tests allow 6% for bf16 vs f32)."""
    params, x, valid, nbr, eattr, bn = _setup(30, 100, 16, 4, 16)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    want = _jax_infer(params, x, valid, nbr, eattr, 4, 16, bn=bn,
                      relu=True, dtype=jdt)
    got = _port_out(params, x, valid, nbr, eattr, 4, 16, bn=bn, relu=True,
                    dtype=tdt)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    else:
        err = np.abs(got - want) / np.maximum(np.abs(want), 1.0)
        assert err.max() < 0.03, err.max()


def test_batched_equals_per_tile():
    """A leading batch dimension runs each tile independently (up to the
    summation order of a batched product: 1e-6)."""
    tiles = [_setup(20, 24, 8, 2, 4, seed=s) for s in (1, 2)]
    params = tiles[0][0]
    mats = tf.gat_param_matrices(
        {k: torch.from_numpy(v) for k, v in params.items()}, 2, 4, 3)

    def run(x, valid, nbr, eattr):
        return tf.fused_grid_gat_infer(
            torch.from_numpy(x), *mats[:4], torch.from_numpy(eattr),
            torch.from_numpy(nbr.astype(np.float32)),
            torch.from_numpy(valid.astype(np.float32)), mats[4])

    stacked = [np.stack(a) for a in zip(*[t[1:5] for t in tiles])]
    batched = run(*stacked)
    for b, t in enumerate(tiles):
        np.testing.assert_allclose(batched[b].numpy(), run(*t[1:5]).numpy(),
                                   rtol=1e-6, atol=1e-6)
