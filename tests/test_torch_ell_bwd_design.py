"""The reformulations behind kernels C' and D' (the ELL GAT backward
kernels), checked on the CPU in plain torch against autograd of the plain
versions, at the small sizes of the other ELL tests (N = 2048, K = 8,
2 heads of 12 channels).

- D' folds d acat into its destination pass: split by destination, d acat
  is sum_i xh[i] (x) [dl_self | sum_k dl_k + dl_self] plus sum_i sum_k
  xh[src_k] (x) [dl_k | 0], which equals autograd's d a_cat_mat of
  ``fused_v2_reference`` (float64 sums of autograd's own dl, within 1e-5
  of the gradient's scale: autograd sums in f32);
- D' visits a row's spill entries through ``spill_perm_d`` /
  ``spill_row_ptr_d``: for every (band, row) they are exactly, and in
  ascending order, the entries whose ``dst_loc`` is the row, also for an
  empty row and a band filled to ``s_max``; and the rows that zero the
  dead entries (entry s by row s mod R) cover each entry once;
- C' writes the destination side of d xh as three scalars per (node,
  head), (at_s, sum_k dl_k + dl_s, dl_s): the rows ``dst_side_rows``
  (here; the card tests use it too) forms from them equal the
  destination-side gradient of the plain layer (float64, 1e-12), and with the bf16 form's two roundings they stay
  within one bf16 step of each rounded term.
"""

import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
from bathymetric_gnn_tpu_torch.ops.ell import (coo_to_ell, ell_gather,
                                               ell_masked_softmax)
from bathymetric_gnn_tpu_torch.ops.ell_banded import (band_ell,
                                                      window_sources)

torch.set_num_threads(2)

N, K, HEADS, C = 2048, 8, 2, 12
HC = HEADS * C
F64 = torch.float64


def _knn_graph(seed=0, n=N, k=K):
    """A k-NN ELL graph over n - n / 16 random points padded to n nodes,
    with the first 5 live nodes isolated (no live slot)."""
    rg = np.random.default_rng(seed)
    n_live = n - n // 16
    pos = (rg.random((n_live, 2)) * 100).astype(np.float32)
    x = rg.normal(size=(n_live, 3)).astype(np.float32)
    gb = GraphBuilder()
    gb.buckets.node_buckets = (n,)
    g = coo_to_ell(gb.build_knn_graph(x, pos, k).graph, max_degree=k)
    g.nbr_mask[:5] = False
    return g


def _v2_inputs(g, r, drop, self_loop, seed=1):
    banded = band_ell(g, band_rows=r, heads=HEADS).to("cpu")
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, s=1.0):
        return torch.randn(*shape, generator=gen) * s

    xh = rnd(N, HEADS, C)
    att = rnd(2, HEADS, C, s=0.3)
    masks = None
    if drop:
        t_count, _, s_max = banded.spill_dst_local_b.shape
        masks = tuple((torch.rand(*shape, generator=gen) < 0.9).float() / 0.9
                      for shape in (((K + 1) * HEADS, N),
                                    (t_count, HEADS, s_max)))
    return dict(xh=xh, a_src=(xh * att[0]).sum(-1),
                a_dst=(xh * att[1]).sum(-1),
                a_cat_mat=rnd(HC, 2 * HEADS, s=0.3),   # a full matrix
                el_t=banded.negmask_t + rnd(K * HEADS, N),
                el_self_t=rnd(HEADS, N) if self_loop else None,
                m_edge=rnd(3, HEADS, s=0.3), banded=banded,
                dropout_masks=masks)


@pytest.mark.parametrize("drop", [False, True])
@pytest.mark.parametrize("self_loop", [True, False])
def test_v2_dacat_by_destination_matches_autograd(drop, self_loop):
    """D''s d acat from its destination terms (the row's own xh times
    [dl_self | sum dl + dl_self]) and its slot terms (each in-band row
    times [dl_k | 0]) equals autograd's d a_cat_mat."""
    kw = _v2_inputs(_knn_graph(), 128, drop, self_loop)
    leaves = {nm: kw[nm].clone().requires_grad_()
              for nm in ("a_cat_mat", "el_t", "el_self_t")
              if kw[nm] is not None}
    out = eb.fused_v2_reference(**{**kw, **leaves})
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2))
    grads = dict(zip(leaves, torch.autograd.grad(out, list(leaves.values()),
                                                 g)))
    x = kw["xh"].reshape(N, HC).to(F64)
    dl = grads["el_t"].to(F64).reshape(K, HEADS, N).permute(2, 0, 1)
    dls = (grads["el_self_t"].to(F64).T if self_loop
           else torch.zeros(N, HEADS, dtype=F64))
    src, valid = (t.T for t in window_sources(kw["banded"].loc_t, 128))
    dl_live = torch.where(valid[..., None], dl, torch.zeros_like(dl))
    # destination terms: [dl_self | sum_k dl_k + dl_self]
    dest = x.T @ torch.cat([dls, dl.sum(1) + dls], 1)
    # slot terms: sum over (i, k) of xh[src_k] dl_k (a_src half only)
    slot = torch.zeros(HC, 2 * HEADS, dtype=F64)
    slot[:, :HEADS] = torch.einsum("ikc,ikh->ch", x[src.reshape(-1)].reshape(
        N, K, HC), dl_live)
    want = grads["a_cat_mat"].to(F64)
    scale = want.abs().max().item()
    assert (dest + slot - want).abs().max().item() <= 1e-5 * scale
    # the slot terms are what the source-side sum over dac would give
    dac_src = torch.zeros(N, HEADS, dtype=F64).index_add_(
        0, src[valid], dl_live[valid])
    torch.testing.assert_close(slot[:, :HEADS], x.T @ dac_src, rtol=1e-10,
                               atol=1e-10)


@pytest.mark.parametrize("r,full_band", [(128, False), (128, True),
                                         (32, True)])
def test_v2_spill_entries_by_destination(r, full_band):
    """spill_perm_d / spill_row_ptr_d list, for each destination, exactly
    the entries of its band's spill table whose dst_loc is its row, in
    ascending order; empty rows get an empty range; a band filled to
    s_max is listed whole; and entry s of a band's table is zeroed (when
    dead) by exactly one row, s mod R."""
    g = _knn_graph()
    s_max = None
    if full_band:
        counts = (band_ell(g, band_rows=r).spill_dst_local_b >= 0).sum(-1)
        s_max = int(counts.max())
    b = band_ell(g, band_rows=r, s_max=s_max)
    dst_loc = b.spill_dst_local_b.reshape(-1)
    t_count, _, s = b.spill_dst_local_b.shape
    perm, row_ptr = b.spill_perm_d, b.spill_row_ptr_d
    empty = 0
    for i in range(N):
        got = perm[row_ptr[i]:row_ptr[i + 1]]
        t, row = divmod(i, r)
        want = t * s + np.nonzero(dst_loc[t * s:(t + 1) * s] == row)[0]
        np.testing.assert_array_equal(got, want)
        empty += len(got) == 0
    assert empty > 0
    if full_band:
        assert ((b.spill_dst_local_b >= 0).all(-1)).any()
    owners = np.zeros((t_count, s), int)
    for row in range(r):
        owners[:, row::r] += 1
    assert (owners == 1).all()


def _split_reference(x_dst, x_src, att_src, att_dst, nbr_src, nbr_mask, el,
                     el_self, dmask):
    """The plain layer (ell_gat_reference's math, float64, no bias) with
    the destination's own rows (its attention dots, self logit and self
    message) from x_dst and the gathered neighbour rows from x_src: the
    gradient of x_dst is the destination side of d xh alone. Also returns
    the dropped self weight at_s."""
    n = x_dst.shape[0]
    xd = x_dst.reshape(n, HEADS, C)
    xs = x_src.reshape(n, HEADS, C)
    a_src_d = (xd * att_src).sum(-1)
    a_dst = (xd * att_dst).sum(-1)
    a_src_s = (xs * att_src).sum(-1)

    def leaky(v):
        return torch.where(v >= 0, v, 0.2 * v)

    logits = leaky(ell_gather(a_src_s, nbr_src) + a_dst[:, None] + el)
    self_lg = leaky(a_src_d + a_dst + el_self)
    wts, w_self = ell_masked_softmax(logits, nbr_mask, self_lg)
    wts = wts * dmask[:, :K]
    w_self = w_self * dmask[:, K]
    nbr = ell_gather(xs, nbr_src)
    nbr = torch.where(nbr_mask[..., None, None], nbr, torch.zeros_like(nbr))
    out = (nbr * wts[..., None]).sum(1) + xd * w_self[..., None]
    return out.reshape(n, HC), w_self


def dst_side_rows(dsc: torch.Tensor, dy: torch.Tensor,
                  att: torch.Tensor) -> torch.Tensor:
    """The destination side of d xh [N, HC] from the three scalars per
    (node, head) that kernel C''s destination pass writes (dsc [N, 3,
    heads]: at_s, dst_r, dls_r), the cotangent dy [N, HC] and att [2, HC]
    (att_src, att_dst): at_s dy + dst_r att_dst + dls_r att_src, the rows
    kernel F's mode (b) starts from inside C'. Plain torch, any device; f32
    (float64 for a float64 dsc). The card tests use it too."""
    n, _, heads = dsc.shape
    hc = dy.shape[1]
    ct = torch.promote_types(dsc.dtype, torch.float32)
    a = att.to(ct).reshape(2, heads, hc // heads)
    d = dsc.to(ct)
    rows = (d[:, 0, :, None] * dy.to(ct).reshape(n, heads, -1)
            + d[:, 1, :, None] * a[1] + d[:, 2, :, None] * a[0])
    return rows.reshape(n, hc)


@pytest.mark.parametrize("form", ["float32", "bfloat16"])
@pytest.mark.parametrize("drop", [False, True])
def test_c_dst_side_from_three_scalars(form, drop):
    """C''s destination side rebuilt by ``dst_side_rows`` from (at_s,
    sum_k dl_k + dl_s, dl_s) equals the destination-side gradient of the
    plain layer; with the bf16 form's roundings of the last two, within
    one bf16 step of their terms."""
    g = _knn_graph()
    gen = torch.Generator().manual_seed(3)
    xh = torch.randn(N, HC, generator=gen, dtype=F64)
    att = torch.randn(2, HEADS, C, generator=gen, dtype=F64) * 0.3
    el = torch.randn(N, K, HEADS, generator=gen, dtype=F64).requires_grad_()
    el_self = torch.randn(N, HEADS, generator=gen,
                          dtype=F64).requires_grad_()
    dmask = torch.ones(N, K + 1, HEADS, dtype=F64)
    if drop:
        dmask = (torch.rand(N, K + 1, HEADS, generator=gen) < 0.9).to(
            F64) / 0.9
    nbr_src = torch.from_numpy(g.nbr_src).long()
    nbr_mask = torch.from_numpy(g.nbr_mask)
    x_dst = xh.clone().requires_grad_()
    out, at_s = _split_reference(x_dst, xh, att[0], att[1], nbr_src,
                                 nbr_mask, el, el_self, dmask)
    dy = torch.randn(N, HC, generator=gen, dtype=F64)
    d_dst, d_el, d_self = torch.autograd.grad(out, (x_dst, el, el_self), dy)
    dls = d_self
    dst_l = d_el.sum(1) + dls
    if form == "bfloat16":
        dst_r = dst_l.to(torch.bfloat16).to(F64)
        dls_r = dls.to(torch.bfloat16).to(F64)
    else:
        dst_r, dls_r = dst_l, dls
    dsc = torch.stack([at_s.detach(), dst_r, dls_r], 1)      # [N, 3, H]
    rows = dst_side_rows(dsc, dy, att.reshape(2, HC))
    assert rows.dtype == F64
    if form == "float32":
        scale = d_dst.abs().max().item()
        assert (rows - d_dst).abs().max().item() <= 1e-12 * scale
    else:
        a = att.reshape(2, HEADS, C)
        step = (dst_l.abs()[..., None] * a[1].abs()
                + dls.abs()[..., None] * a[0].abs()).reshape(N, HC)
        err = (rows - d_dst).abs()
        assert bool((err <= 2.0 ** -8 * step + 1e-12 * d_dst.abs().max()
                     ).all())
        assert (dst_r != dst_l).any()     # the roundings are taken
