"""PyTorch port vs JAX: the multi-task training loss, term by term.

The same numpy outputs and targets go through ``bathymetric_gnn_tpu.training.losses``
(under ``jax.jit``, as the trainers run it) and the port's
``training/losses.py``: every ``*_terms`` function, ``combined_loss`` and
its gradients, with padded nodes, empty masks, label smoothing and class
weights. Tolerance 1e-5 relative (f32 sums over the same nodes in
another order). Padded nodes may also carry NaN correction targets, as
cells inside a NaN hole of a clean survey do: the JAX loss drops them but
its gradient does not (``test_nan_targets_at_masked_nodes``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu.training import losses as JL
from bathymetric_gnn_tpu_torch.training import losses as TL

N = 600


def _batch(seed=0, empty_nodes=False, empty_noise=False, nan_pad=False):
    rg = np.random.default_rng(seed)
    logits = rg.normal(0, 2, (N, 3)).astype(np.float32)
    pred = logits.argmax(-1).astype(np.int32)
    labels = rg.integers(0, 3, N).astype(np.int32)
    if empty_noise:
        labels[labels == 2] = 0
    node_mask = rg.random(N) < 0.8          # the rest is padding
    node_mask[-50:] = False
    if empty_nodes:
        node_mask[:] = False
    corr_t = rg.normal(0, 1.5, N).astype(np.float32)
    if nan_pad:
        corr_t[~node_mask] = np.nan         # no target where no cell
    outputs = {
        "class_logits": logits,
        "predicted_class": pred,
        "confidence": rg.uniform(0.01, 0.99, N).astype(np.float32),
        "correction": rg.normal(0, 1.0, N).astype(np.float32),
    }
    targets = {"labels": labels, "correction": corr_t,
               "noise_mask": labels == 2}
    return outputs, targets, node_mask


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _torch(tree):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()}


CW = np.array([0.7, 1.9, 1.2], np.float32)
CASES = {
    "plain": dict(),
    "smoothing_weights": dict(label_smoothing=0.1, class_weights=CW),
    "empty_nodes": dict(empty_nodes=True, class_weights=CW),
    "empty_noise": dict(empty_noise=True, label_smoothing=0.05),
}


def _case(name, nan_pad=False):
    kw = dict(CASES[name])
    o, t, m = _batch(empty_nodes=kw.pop("empty_nodes", False),
                     empty_noise=kw.pop("empty_noise", False),
                     nan_pad=nan_pad)
    return o, t, m, kw


@pytest.mark.parametrize("nan_pad", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_terms_match_jax(name, nan_pad):
    o, t, m, kw = _case(name, nan_pad)
    cw = kw.get("class_weights")
    ls = kw.get("label_smoothing", 0.0)
    jo, jt, jm = _jax(o), _jax(t), jnp.asarray(m)
    to, tt, tm = _torch(o), _torch(t), torch.from_numpy(m)
    jcw = None if cw is None else jnp.asarray(cw)
    tcw = None if cw is None else torch.from_numpy(cw)
    pairs = {
        "classification": (
            jax.jit(JL.classification_loss_terms, static_argnums=4)(
                jo["class_logits"], jt["labels"], jm, jcw, ls),
            TL.classification_loss_terms(to["class_logits"], tt["labels"],
                                         tm, tcw, ls)),
        "correction": (
            jax.jit(JL.correction_loss_terms)(
                jo["correction"], jt["correction"], jt["noise_mask"] & jm),
            TL.correction_loss_terms(to["correction"], tt["correction"],
                                     tt["noise_mask"] & tm)),
        "confidence": (
            jax.jit(JL.confidence_calibration_loss_terms)(
                jo["confidence"], jo["predicted_class"], jt["labels"], jm),
            TL.confidence_calibration_loss_terms(
                to["confidence"], to["predicted_class"], tt["labels"], tm)),
        "feature_preservation": (
            jax.jit(JL.feature_preservation_loss_terms)(
                jo["predicted_class"], jt["labels"], jm),
            TL.feature_preservation_loss_terms(
                to["predicted_class"], tt["labels"], tm)),
        "shoal_safety": (
            jax.jit(JL.shoal_safety_loss_terms)(
                jo["predicted_class"], jt["labels"], jt["correction"], jm),
            TL.shoal_safety_loss_terms(
                to["predicted_class"], tt["labels"], tt["correction"], tm)),
    }
    for term, (want, got) in pairs.items():
        for w, g in zip(want, got):
            assert np.isfinite(float(g)), term
            np.testing.assert_allclose(float(g), float(w), rtol=1e-5,
                                       atol=1e-6, err_msg=term)


WEIGHTS = dict(classification_weight=1.0, correction_weight=0.5,
               confidence_weight=0.2, feature_preservation_weight=0.3,
               shoal_safety_weight=0.5, correction_delta=1.0)


def _combined(o, t, m, kw):
    """(JAX losses, JAX grads, port losses, port grads) of combined_loss
    w.r.t. the logits, confidence and correction."""
    weights = WEIGHTS
    cw = kw.get("class_weights")
    ls = kw.get("label_smoothing", 0.0)

    # the batch goes in as arguments of the jitted function, as in the
    # trainers' steps (XLA folds constants by other rules)
    def jloss(logits, conf, corr, targets, mask):
        out = dict(_jax(o), class_logits=logits, confidence=conf,
                   correction=corr)
        return JL.combined_loss(
            out, targets, mask,
            class_weights=None if cw is None else jnp.asarray(cw),
            label_smoothing=ls, **weights)

    args = [jnp.asarray(o[k]) for k in
            ("class_logits", "confidence", "correction")]
    args += [_jax(t), jnp.asarray(m)]
    want = jax.jit(jloss)(*args)
    wgrad = jax.jit(jax.grad(lambda *a: jloss(*a)["total"],
                             argnums=(0, 1, 2)))(*args)
    leaves = [torch.from_numpy(o[k].copy()).requires_grad_()
              for k in ("class_logits", "confidence", "correction")]
    out = dict(_torch(o), class_logits=leaves[0], confidence=leaves[1],
               correction=leaves[2])
    got = TL.combined_loss(
        out, _torch(t), torch.from_numpy(m),
        class_weights=None if cw is None else torch.from_numpy(cw),
        label_smoothing=ls, **weights)
    got["total"].backward()
    return (want, [np.asarray(w) for w in wgrad],
            {k: float(v.detach()) for k, v in got.items()},
            [leaf.grad.numpy() for leaf in leaves])


@pytest.mark.parametrize("name", sorted(CASES))
def test_combined_loss_and_grads_match_jax(name):
    """combined_loss (all five weighted terms and the total) and the
    gradient of the total w.r.t. the logits, confidence and correction."""
    want, wgrad, got, grads = _combined(*_case(name))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for g, w in zip(grads, wgrad):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


def test_nan_targets_at_masked_nodes():
    """NaN correction targets at masked nodes (cells inside a NaN hole of
    the clean survey: raw_correction = noisy - clean). The JAX loss drops
    them (XLA turns its mask product into a select) but its gradient
    w.r.t. the correction is NaN there, which the trainer's global-norm
    clip spreads to every parameter (a fault of the reference, ROADMAP
    queue 3). The port drops them from the loss and the gradient: its
    results equal the JAX ones on the same batch with finite targets
    there."""
    o, t, m, kw = _case("smoothing_weights", nan_pad=True)
    want, wgrad, got, grads = _combined(o, t, m, kw)
    assert np.isnan(wgrad[2]).any()
    t_fin = dict(t, correction=np.nan_to_num(t["correction"]))
    want_fin, wgrad_fin, _, _ = _combined(o, t_fin, m, kw)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got[k], float(want_fin[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    for g, w in zip(grads, wgrad_fin):
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


def test_correction_missing_gives_zero_term():
    o, t, m, _ = _case("plain")
    o.pop("correction")
    want = jax.jit(JL.combined_loss)(_jax(o), _jax(t), jnp.asarray(m))
    got = TL.combined_loss(_torch(o), _torch(t), torch.from_numpy(m))
    assert float(got["correction"]) == float(want["correction"]) == 0.0
    np.testing.assert_allclose(float(got["total"]), float(want["total"]),
                               rtol=1e-5)


def test_helpers_match_jax():
    counts = np.array([9000, 130, 870])
    np.testing.assert_array_equal(TL.compute_class_weights(counts),
                                  JL.compute_class_weights(counts))
    np.testing.assert_array_equal(
        TL.compute_class_weights(counts, smoothing=0.01),
        JL.compute_class_weights(counts, smoothing=0.01))
    corr = np.random.default_rng(2).normal(0, 3, 1000)
    assert TL.compute_correction_delta(corr) == \
        JL.compute_correction_delta(corr)
    assert TL.compute_correction_delta(np.zeros(0)) == \
        JL.compute_correction_delta(np.zeros(0))
    x = np.linspace(-3, 3, 61).astype(np.float32)
    np.testing.assert_allclose(TL.huber(torch.from_numpy(x), 1.0).numpy(),
                               np.asarray(JL.huber(jnp.asarray(x), 1.0)),
                               rtol=1e-7)
