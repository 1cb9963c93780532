"""PyTorch port vs JAX: the layers' training side.

``_BnLowp`` (the bf16 masked BatchNorm with its hand-written backward)
against the JAX ``_bn_lowp`` custom VJP, and ``MaskedBatchNorm`` in
training mode (f32 and bf16 activations, fused ReLU, feature dropout from
a pinned keep mask) against the flax module: outputs, running statistics
and gradients. The keep masks are drawn once with jax.random, exactly as
the JAX module draws them from the same key, and handed to the port.
Also the dropout generator contract and the model's two eval forms.
"""

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.models.layers import MaskedBatchNorm as JaxBN
from bathymetric_gnn_tpu.models.layers import _bn_lowp
from bathymetric_gnn_tpu_torch.data.graph_build import build_grid_inputs
from bathymetric_gnn_tpu_torch.models.grid_batched import BatchedGridGNN
from bathymetric_gnn_tpu_torch.models.layers import (MaskedBatchNorm,
                                                     _BnLowp, dropout)

torch.set_num_threads(2)

N, F = 400, 24
BF16_STEP = 2.0 ** -7     # two bf16 rounding steps, relative


def _data(seed=3, keep_prob=1.0):
    rg = np.random.default_rng(seed)
    x = rg.normal(2.0, 1.5, (N, F)).astype(np.float32)
    mask = rg.random(N) < 0.85
    x[~mask] = 50.0                      # padding must not reach the moments
    scale = rg.uniform(0.5, 1.5, F).astype(np.float32)
    bias = rg.normal(0, 0.3, F).astype(np.float32)
    w = rg.normal(size=(N, F)).astype(np.float32)   # loss = sum(y * w)
    keep = (np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed),
                                            keep_prob, (N, F)))
            if keep_prob < 1.0 else None)
    return x, mask, scale, bias, w, keep


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("keep_prob", [1.0, 0.9])
def test_bn_lowp_matches_jax(relu, keep_prob):
    """bf16 activations: y within two bf16 steps (both compute it in f32
    from moments summed in another order, then round), the f32 moments
    within 1e-5, and the gradients (dx bf16: two bf16 steps of its scale;
    dscale, dbias f32: 1e-4 of their scale) against jax.grad through the
    custom VJP."""
    x, mask, scale, bias, w, keep = _data(keep_prob=keep_prob)
    mask_f = mask.astype(np.float32)
    jkeep = (jnp.asarray(keep) if keep is not None
             else jnp.ones((1, 1), bool))

    def jfn(xb, sc, bi):
        y, mean, var = _bn_lowp(xb, jnp.asarray(mask_f), sc, bi, jkeep,
                                1e-5, relu, keep_prob)
        return jnp.sum(y.astype(jnp.float32) * w), (y, mean, var)

    xb = jnp.asarray(x, jnp.bfloat16)
    (_, (yj, mj, vj)), gj = jax.value_and_grad(
        jfn, argnums=(0, 1, 2), has_aux=True)(xb, jnp.asarray(scale),
                                               jnp.asarray(bias))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    yt, mt, vt = _BnLowp.apply(
        xt, torch.from_numpy(mask_f), st, bt,
        None if keep is None else torch.from_numpy(keep), 1e-5, relu,
        keep_prob)
    assert yt.dtype == torch.bfloat16
    (yt.float() * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-6)
    yj = np.asarray(yj, np.float32)
    np.testing.assert_allclose(yt.detach().float().numpy(), yj,
                               rtol=BF16_STEP, atol=1e-3)
    for name, g, want, tol in (("x", xt.grad, gj[0], BF16_STEP),
                               ("scale", st.grad, gj[1], 1e-4),
                               ("bias", bt.grad, gj[2], 1e-4)):
        want = np.asarray(want, np.float32)
        s = np.abs(want).max() + 1e-6
        np.testing.assert_allclose(g.float().numpy() / s, want / s, rtol=0,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("drop", [False, True])
def test_masked_batchnorm_train_matches_jax(dtype, drop):
    """The module in training mode, fused ReLU, with and without feature
    dropout (keep mask pinned to the JAX module's own draw from the same
    key): outputs, updated running stats and gradients w.r.t. x, scale and
    bias. f32 within 1e-5 (same formula); bf16 as in
    test_bn_lowp_matches_jax."""
    x, mask, scale, bias, w, _ = _data(seed=4)
    key = jax.random.PRNGKey(11)
    rate = 0.1 if drop else 0.0
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jbn = JaxBN(F)
    variables = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                         jnp.asarray(mask))
    params = flax.core.unfreeze(variables["params"])
    params["scale"], params["bias"] = jnp.asarray(scale), jnp.asarray(bias)

    def jfn(xj, p):
        y, upd = jbn.apply({"params": p,
                            "batch_stats": variables["batch_stats"]},
                           xj, jnp.asarray(mask), fuse_relu=True,
                           drop_rate=rate, drop_rng=key if drop else None,
                           mutable=["batch_stats"])
        return jnp.sum(y.astype(jnp.float32) * w), (y, upd)

    xj = jnp.asarray(x, jdt)
    (_, (yj, upd)), (gx, gp) = jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True)(xj, params)
    keep = (torch.from_numpy(np.asarray(jax.random.bernoulli(
        key, 1.0 - rate, (N, F)))) if drop else None)

    bn = MaskedBatchNorm(F).train()
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    yt = bn(xt, torch.from_numpy(mask), fuse_relu=True, keep=keep,
            keep_prob=1.0 - rate)
    assert yt.dtype == getattr(torch, dtype)
    (yt.float() * torch.from_numpy(w)).sum().backward()
    tol = 1e-5 if dtype == "float32" else BF16_STEP
    np.testing.assert_allclose(yt.detach().float().numpy(),
                               np.asarray(yj, np.float32), rtol=tol,
                               atol=1e-5 if dtype == "float32" else 1e-3)
    for s in ("mean", "var"):
        np.testing.assert_allclose(getattr(bn, s).numpy(),
                                   np.asarray(upd["batch_stats"][s]),
                                   rtol=1e-5, atol=1e-6, err_msg=s)
    for name, g, want in (("x", xt.grad, gx), ("scale", bn.scale.grad,
                                               gp["scale"]),
                          ("bias", bn.bias.grad, gp["bias"])):
        want = np.asarray(want, np.float32)
        s = np.abs(want).max() + 1e-6
        gtol = (1e-5 if dtype == "float32" else
                BF16_STEP if name == "x" else 1e-4)
        np.testing.assert_allclose(g.float().numpy() / s, want / s, rtol=0,
                                   atol=gtol, err_msg=name)


def test_dropout_draws_only_from_its_generator():
    """Dropout keeps with probability 1 - rate, scales by 1/(1 - rate),
    draws from the generator it is given (same seed, same mask) and leaves
    torch's global generator alone; without a generator it raises."""
    x = torch.ones(2000)
    state = torch.random.get_rng_state()
    a = dropout(x, 0.25, torch.Generator().manual_seed(5))
    b = dropout(x, 0.25, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert set(a.unique().tolist()) == {0.0, float(torch.tensor(1 / 0.75))}
    assert abs((a == 0).float().mean().item() - 0.25) < 0.05
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, 0.25, None)


def test_model_dropout_training_and_eval_forms():
    """BatchedGridGNN (dropout 0.1) in training mode on the CPU: every
    parameter gets a finite gradient and the draw follows the generator.
    In eval mode the folded inference form (no_grad) and the
    differentiable form (grad on) agree to 1e-5."""
    g = torch.Generator().manual_seed(0)
    model = BatchedGridGNN(7, 16, 2, 2, generator=g)
    depth = 30 + torch.randn(2, 20, 24, generator=g).cumsum(1) * 0.05
    valid = torch.rand(2, 20, 24, generator=g) > 0.1
    inputs = build_grid_inputs(depth, valid)[:4]

    def loss(seed):
        out = model.train()(*inputs,
                            dropout_rng=torch.Generator().manual_seed(seed))
        return (out["class_logits"].square().sum() + out["confidence"].sum()
                + out["correction"].square().sum())

    state = {k: v.clone() for k, v in model.state_dict().items()}
    loss(1).backward()
    for n, p in model.named_parameters():
        assert p.grad is not None and torch.isfinite(p.grad).all(), n
    model.load_state_dict(state)
    with torch.no_grad():
        assert loss(1) == loss(1)
        assert loss(1) != loss(2)
    with pytest.raises(ValueError, match="Generator"):
        model.train()(*inputs)
    model.eval()
    with torch.no_grad():
        folded = model(*inputs)
    unfolded = model(*inputs)
    for k in ("class_logits", "confidence", "correction"):
        np.testing.assert_allclose(unfolded[k].detach().numpy(),
                                   folded[k].numpy(), rtol=1e-5, atol=1e-5)
