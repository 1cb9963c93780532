"""PyTorch port vs JAX: the bf16 forms of kernels C, C', D, D', E and F.

The JAX package's Pallas kernels run at ``compute_dtype="bfloat16"`` in
interpret mode (its default off the TPU, where ``upcast_dots`` rounds the
streams to bf16 and computes in f32, the oracle these tests check); the
port's plain versions take the same bf16 ``xh`` (the bf16 layer's x @ W)
and f32 everything else. On a k-NN graph as ``tests/test_ell_banded.py``
makes it (1,500 random points padded to 2,048 nodes, k 8, 2 heads of C
12, 128-row bands):

- kernel E's plain version (``band_part_reference``) against
  ``ell_gat_band_part_pallas``: y, m and denom are f32 from the same
  bf16-rounded xh and a_cat_mat, 2e-5 (the f32 tolerance);
- kernel D's plain version against ``ell_gat_fused_pallas``, with and
  without JAX's v2 masks, and kernel C's (``ell_gat_reference``, through
  the serving and the training entries) against
  ``ell_gat_fused_wide_pallas`` with JAX's wide masks mapped to the port's
  [N, K+1, heads] layout: bf16 outputs, max |d| <= 1e-2 * max(|ref|, 1)
  and >= 99 % of the entries within one bf16 step of JAX's. (Kernel C
  reads ``nbr_src`` and cannot single out spilled slots, so it does not
  round their messages to bf16 as the TPU kernel does: a few outputs sit
  one step apart.)
- kernels C' and D' (autograd of the plain versions) against ``jax.grad``
  through the custom VJPs ``_fused_v3`` / ``_fused_v2``: every input's
  gradient within a relative L2 error of 2e-2 and a worst entry of 5e-2
  of its largest |entry| (JAX's own bf16-vs-f32 gate for these backwards
  is 0.02-0.08 / 0.10-0.15, ``tests/test_ell_banded.py``). The plain
  versions take their backward from autograd in f32 and round d xh once;
  the JAX kernels round dy and some products to bf16 first.
- kernel F mode (a)'s plain version on a bf16 cotangent against JAX's
  ``segment_reduce_sorted`` (interpret) on the same bf16 rows, 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bathymetric_gnn_tpu.models.conv_ell as jce
from bathymetric_gnn_tpu.ops import ell_banded as jeb
from bathymetric_gnn_tpu.ops.pallas.ell_gat_fused import (
    ell_gat_band_part_pallas, ell_gat_fused_pallas,
    ell_gat_fused_wide_pallas)
from bathymetric_gnn_tpu.ops.pallas.segment_reduce import \
    segment_reduce_sorted as jax_segment_reduce_sorted
from bathymetric_gnn_tpu_torch.ops import ell_banded as teb
from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
from bathymetric_gnn_tpu_torch.ops.cuda import segment_reduce as sr
from bathymetric_gnn_tpu_torch.ops.ell import src_sorted_slots

from test_torch_ell_banded import (C, HEADS, N, _j, _jax_masks, _port_graph,
                                   _streams, _t, make_knn_ell)
from test_torch_ell_train import _port_mask

torch.set_num_threads(2)

R = 128
TOL = dict(rtol=2e-5, atol=2e-5)
BF16 = jnp.bfloat16


def assert_bf16_close(got, want, name=""):
    """max |d| <= 1e-2 * max(|ref|, 1), and >= 99 % of the entries within
    one bf16 step (the spacing of bf16 numbers at the reference value)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    d = np.abs(got - want)
    assert d.max() <= 1e-2 * max(np.abs(want).max(), 1.0), (name, d.max())
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    within = (d <= step) | (d <= 1e-6)
    assert within.mean() >= 0.99, (name, within.mean())


def assert_grad_close(got, want, name=""):
    """Relative L2 error <= 2e-2 and worst entry <= 5e-2 of max |ref|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
    worst = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert rel <= 2e-2 and worst <= 5e-2, (name, rel, worst)


@pytest.fixture(scope="module")
def case():
    """(JAX EllGraph, JAX BandedEll, the port's EllGraph and BandedEll of
    tensors, a [N, 24] cotangent weight)."""
    g = make_knn_ell()
    w = np.random.default_rng(13).normal(size=(N, 24)).astype(np.float32)
    return (g, jeb.band_ell(g, band_rows=R), _port_graph(g, tensors=True),
            teb.band_ell(_port_graph(g), band_rows=R).to("cpu"), w)


def _bf16_streams(jb, seed, self_loop=True):
    """``_streams`` with xh rounded to bf16 (the bf16 layer's x @ W) and
    the attention dots taken from the rounded values."""
    s = _streams(jb, seed=seed, self_loop=self_loop)
    xh = np.asarray(jnp.asarray(s["xh"]).astype(BF16).astype(jnp.float32))
    att = _att(s["a_cat"])
    s.update(xh=xh, a_src=(xh * att[0]).sum(-1).astype(np.float32),
             a_dst=(xh * att[1]).sum(-1).astype(np.float32), att=att)
    return s


def _att(a_cat):
    """The [2, heads, C] attention vectors of a block-diagonal a_cat_mat."""
    hc = HEADS * C
    cols = np.arange(hc) // C
    return np.stack([a_cat[np.arange(hc), cols],
                     a_cat[np.arange(hc), HEADS + cols]]).reshape(2, HEADS, C)


def _a_cat(att):
    """[2, heads, C] attention vectors -> the block-diagonal a_cat_mat."""
    hc = HEADS * C
    diag = (jnp.arange(hc)[:, None] // C == jnp.arange(HEADS)[None]
            ).astype(jnp.float32)
    return jnp.concatenate([diag * att[0].reshape(hc, 1),
                            diag * att[1].reshape(hc, 1)], axis=1)


def _tb(a):
    """numpy f32 -> a bf16 tensor (exact for values already rounded)."""
    return torch.from_numpy(np.array(a, np.float32)).to(torch.bfloat16)


@pytest.mark.parametrize("self_loop", [True, False])
def test_band_part_bf16_matches_pallas(case, self_loop):
    """Kernel E's bf16 form: bf16 xh and a_cat_mat in, f32 out."""
    _, jb, _, pb, _ = case
    s = _bf16_streams(jb, 0, self_loop)
    want = ell_gat_band_part_pallas(
        _j(s["xh"]).astype(BF16), _j(s["a_cat"]), _j(s["el_t"]),
        _j(s["el_self_t"]), jb, compute_dtype="bfloat16", interpret=True)
    with torch.no_grad():
        got = eb.ell_gat_band_part(_tb(s["xh"]), _t(s["a_cat"]),
                                   _t(s["el_t"]), _t(s["el_self_t"]), pb)
    for name, a, b in zip(("y", "m", "denom"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)


@pytest.mark.parametrize("drop", [False, True])
def test_fused_v2_bf16_matches_pallas(case, drop):
    """Kernel D's bf16 form (bf16 xh and spill rows, spill messages rounded
    before the fold, bf16 out), with and without JAX's v2 masks."""
    _, jb, _, pb, _ = case
    s = _bf16_streams(jb, 2)
    masks = _jax_masks(jb) if drop else None
    want = ell_gat_fused_pallas(
        _j(s["xh"]).astype(BF16), _j(s["a_src"]), _j(s["a_dst"]),
        _j(s["a_cat"]), _j(s["el_t"]), _j(s["el_self_t"]), _j(s["m_edge"]),
        jb, compute_dtype="bfloat16", dropout_masks=masks, interpret=True)
    with torch.no_grad():
        got = eb.ell_gat_fused_v2(
            _tb(s["xh"]), _t(s["a_src"]), _t(s["a_dst"]), _t(s["a_cat"]),
            _t(s["el_t"]), _t(s["el_self_t"]), _t(s["m_edge"]), pb,
            dropout_masks=None if masks is None else tuple(
                _t(np.asarray(m)) for m in masks))
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    assert_bf16_close(got.float().numpy(), want.astype(jnp.float32))


def _wide_inputs(jb, att, m_edge):
    """The JAX wide kernel's edge-logit streams as the JAX layer builds
    them (``conv_ell.py:233-237``)."""
    el_w_b = (jnp.einsum("tfl,fh->thl", jb.eattr_wide_t, m_edge)
              + jb.negmask_wide[:, None, :])
    return _a_cat(att), el_w_b, m_edge.T @ jb.mean_attr_t


def _port_c_inputs(tg, pb, m_edge):
    """The port's el [N, K, heads] and el_self [N, heads] for kernel C."""
    return tg.edge_attr @ m_edge, pb.mean_attr_t.T @ m_edge


def _wide_masks(jb, seed=321, p=0.3):
    k = np.asarray(jb.loc_t).shape[0]
    return jce.make_banded_dropout_masks(
        jax.random.PRNGKey(seed), p, N, k, HEADS,
        np.asarray(jb.spill_dst_local_b).shape, wide=True)


@pytest.mark.parametrize("drop", [False, True])
def test_ell_gat_bf16_matches_wide_pallas(case, drop):
    """Kernel C's bf16 form (serving entry without dropout, the training
    entry with JAX's wide masks mapped to the port's layout) against the
    wide Pallas kernel at compute_dtype bfloat16."""
    g, jb, tg, pb, _ = case
    s = _bf16_streams(jb, 4)
    masks = _wide_masks(jb) if drop else None
    a_cat, el_w_b, el_self_t = _wide_inputs(jb, _j(s["att"]),
                                            _j(s["m_edge"]))
    want = ell_gat_fused_wide_pallas(
        _j(s["xh"]).astype(BF16), a_cat, el_w_b, el_self_t, _j(s["m_edge"]),
        jb, compute_dtype="bfloat16", dropout_masks=masks, interpret=True)
    el, el_self = _port_c_inputs(tg, pb, _t(s["m_edge"]))
    att = _t(s["att"])
    args = (_tb(s["xh"]).reshape(N, HEADS * C), att[0:1], att[1:2],
            tg.nbr_src, tg.nbr_mask, el, el_self)
    with torch.no_grad():
        if drop:
            k = tg.nbr_src.shape[1]
            dmask = torch.from_numpy(_port_mask(*masks, jb, N, k, HEADS))
            got = ef.ell_gat_fused_train(*args, dmask=dmask, keep_prob=0.7)
        else:
            got = ef.ell_gat_fused(*args)
    assert want.dtype == BF16 and got.dtype == torch.bfloat16
    assert_bf16_close(got.float().numpy(), want.astype(jnp.float32))


@pytest.mark.parametrize("drop", [False, True])
def test_ell_gat_bf16_grads_match_jax(case, drop):
    """Kernel C' (autograd of C's bf16 plain version) against jax.grad
    through ``_fused_v3`` at bfloat16: d xh (bf16), d att and d m_edge."""
    g, jb, tg, pb, w = case
    s = _bf16_streams(jb, 5)
    masks = _wide_masks(jb, seed=9) if drop else None
    wj = jnp.asarray(w)

    def loss(xh, att, m_edge):
        a_cat, el_w_b, el_self_t = _wide_inputs(jb, att, m_edge)
        out = ell_gat_fused_wide_pallas(
            xh.reshape(N, HEADS, C), a_cat, el_w_b, el_self_t, m_edge, jb,
            compute_dtype="bfloat16", dropout_masks=masks, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * wj)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        _j(s["xh"]).reshape(N, HEADS * C).astype(BF16), _j(s["att"]),
        _j(s["m_edge"]))
    assert want[0].dtype == BF16
    xh = _tb(s["xh"]).reshape(N, HEADS * C).requires_grad_()
    att = _t(s["att"]).requires_grad_()
    m_edge = _t(s["m_edge"]).requires_grad_()
    el, el_self = _port_c_inputs(tg, pb, m_edge)
    dmask = None
    if drop:
        dmask = torch.from_numpy(_port_mask(*masks, jb, N,
                                            tg.nbr_src.shape[1], HEADS))
    out = ef.ell_gat_fused_train(xh, att[0:1], att[1:2], tg.nbr_src,
                                 tg.nbr_mask, el, el_self, dmask=dmask)
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert xh.grad.dtype == torch.bfloat16
    for name, a, b in (("xh", xh.grad.float(), want[0].astype(jnp.float32)),
                       ("att", att.grad, want[1]),
                       ("m_edge", m_edge.grad, want[2])):
        assert_grad_close(a.numpy(), np.asarray(b), name)


V2_LEAVES = ("xh", "a_src", "a_dst", "a_cat", "el_t", "el_self_t", "m_edge")


@pytest.mark.parametrize("drop", [False, True])
def test_fused_v2_bf16_grads_match_jax(case, drop):
    """Kernel D' (autograd of D's bf16 plain version; the spill gathers'
    backward kernel F mode (a) on the bf16 cotangent) against jax.grad
    through ``_fused_v2`` at bfloat16, every input's gradient."""
    _, jb, _, pb, w = case
    s = _bf16_streams(jb, 3)
    masks = _jax_masks(jb, seed=7) if drop else None
    wj = jnp.asarray(w)

    def loss(*leaves):
        kw = dict(zip(V2_LEAVES, leaves))
        out = ell_gat_fused_pallas(
            kw["xh"], kw["a_src"], kw["a_dst"], kw["a_cat"], kw["el_t"],
            kw["el_self_t"], kw["m_edge"], jb, compute_dtype="bfloat16",
            dropout_masks=masks, interpret=True)
        return jnp.sum(out.astype(jnp.float32) * wj)

    jleaves = [_j(s[n]) for n in V2_LEAVES]
    jleaves[0] = jleaves[0].astype(BF16)
    want = jax.grad(loss, argnums=tuple(range(len(V2_LEAVES))))(*jleaves)
    leaves = {n: _t(s[n]).clone().requires_grad_() for n in V2_LEAVES}
    leaves["xh"] = _tb(s["xh"]).requires_grad_()
    out = eb.ell_gat_fused_v2(
        *(leaves[n] for n in V2_LEAVES[:-1]), leaves["m_edge"], pb,
        dropout_masks=None if masks is None else tuple(
            _t(np.asarray(m)) for m in masks))
    assert out.dtype == torch.bfloat16
    (out.float() * torch.from_numpy(w)).sum().backward()
    assert leaves["xh"].grad.dtype == torch.bfloat16
    for n, ref in zip(V2_LEAVES, want):
        assert_grad_close(leaves[n].grad.float().numpy(),
                          np.asarray(ref.astype(jnp.float32)), n)


def test_segment_reduce_bf16_matches_jax(case):
    """Kernel F mode (a)'s plain version on a bf16 cotangent (the bf16
    spill rows' gather backward) against JAX's reducer on the same rows:
    f32 sums of the bf16 values."""
    g, _, _, _, _ = case
    banded = jeb.band_ell(g, band_rows=R, spill_pad=64)
    src = np.asarray(banded.spill_src_b).reshape(-1)
    live = np.asarray(banded.spill_dst_local_b)[:, 0, :].reshape(-1) >= 0
    s = src.shape[0]
    ct = jnp.asarray(np.random.default_rng(0).normal(size=(s, 16)),
                     BF16)
    want = jax_segment_reduce_sorted(
        jnp.take(ct, banded.spill_perm, axis=0), banded.spill_src_sorted,
        banded.spill_red_first, banded.spill_red_jcount, n=N,
        max_j=banded.spill_red_maxj, interpret=True)
    kp = -(-s // N)
    nbr = np.zeros(N * kp, np.int32)
    nbr[:s] = src
    mask = np.zeros(N * kp, bool)
    mask[:s] = live
    ct_pad = torch.zeros(N * kp, 16, dtype=torch.bfloat16)
    ct_pad[:s] = _tb(ct.astype(jnp.float32))
    perm, row_ptr = src_sorted_slots(nbr.reshape(N, kp), mask.reshape(N, kp))
    got = sr.segment_reduce_sorted(ct_pad, torch.from_numpy(perm),
                                   torch.from_numpy(row_ptr), N)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
