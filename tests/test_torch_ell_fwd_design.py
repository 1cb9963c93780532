"""The decompositions behind kernels C and E (the ELL GAT forward kernels,
``csrc/ell_gat_fwd.cu`` and ``csrc/ell_gat_band.cu``), emulated on the CPU
in plain torch and held against their plain versions
(``ell_gat_reference``, ``band_part_reference``) at small sizes (256
nodes, K in {1, 5, 8, 16, 33}, heads in {1, 4, 8}), in f32 and with the
bf16 form's roundings.

- C: a node is owned by a group of lpr lanes (the fewest that hold its
  row at two 16-byte chunks a lane, so that a warp holds 32 / lpr nodes;
  32 when the nodes' lists would take more than 8 KB a warp); its
  live slots are compacted into a dense list (a dead slot is never an
  entry, so its row is never read); lane p of the group owns the pair
  (entry p // hp, head p % hp), hp = heads rounded up to a power of two;
  K x hp > lpr takes several pair tiles, each lane carrying its max and
  sum over its tiles before the xor tree among the group's lanes of its
  head (offsets >= hp); every lane of a head forms the self logit; the
  group sums the self row and the entries' rows in order; then the bias
  (the bf16 sum rounded before it) and the node mask.
- E: the same on the band layout: the slots with a window source listed
  densely (dead and spilled slots are never entries), the same pair
  softmax with the max floored at -1e4 when there is no self loop, and the
  same gather, left unnormalized; m and denom per head.

Tolerances: f32 1e-5 x (1 + |ref|) for C and 1e-5 of each output's
largest |entry| for E (the plain versions sum the same f32 terms in
another order: ~1e-7 relative); bf16 C 1.6e-2 x (1 + |ref|) (the card
tests' bf16 tolerance: one or two bf16 rounding steps of the output, where
a ~1e-7 difference of the f32 sum can flip a rounding), with at least 99 %
of the outputs equal bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu_torch.data.graph_build import GraphBuilder
from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_fused as ef
from bathymetric_gnn_tpu_torch.ops.ell import coo_to_ell
from bathymetric_gnn_tpu_torch.ops.ell_banded import (band_ell, leaky_relu,
                                                      window_sources)

torch.set_num_threads(2)

N = 256
WARP = 32
BF16 = torch.bfloat16
SLOPE = 0.2


def _knn_graph(k, seed=0, n=N):
    """A k-NN ELL graph over n - n / 16 random points padded to n nodes;
    the first 3 live nodes keep no live slot, the next 3 keep one."""
    rg = np.random.default_rng(seed)
    n_live = n - n // 16
    pos = (rg.random((n_live, 2)) * 100).astype(np.float32)
    x = rg.normal(size=(n_live, 3)).astype(np.float32)
    gb = GraphBuilder()
    gb.buckets.node_buckets = (n,)
    g = coo_to_ell(gb.build_knn_graph(x, pos, k).graph, max_degree=k)
    g.nbr_mask[:3] = False
    g.nbr_mask[3:6, 1:] = False
    return g


def _pow2(heads):
    return 1 << (heads - 1).bit_length()


def _xor_tree(v, lo, op):
    """v [..., lpr] (one value a lane of a node's group) after the
    butterfly over the xor offsets lpr / 2, ..., lo: every lane holds its
    head's result."""
    width = v.shape[-1]
    o = width // 2
    while o >= lo:
        v = op(v, v[..., torch.arange(width) ^ o])
        o //= 2
    return v


def _lanes_per_node(hc, c, heads, lowp, node_bytes):
    """The lanes of a node's group (rows::fwd_geom): the fewest (a power of
    two, at least hp, at most 32) that hold the row at two 16-byte chunks a
    lane (single columns when c does not allow 16 bytes), or 32 when the
    lists of the 32 / lpr nodes of a warp would take more than 8 KB."""
    v = 8 if lowp else 4
    v = v if c % v == 0 else 1
    need = -(-(-(-hc // v)) // 2)
    lpr = 1
    while lpr < WARP and (lpr < need or lpr < _pow2(heads)):
        lpr *= 2
    return WARP if (WARP // lpr) * node_bytes > 8 * 1024 else lpr


def _gather(x, src, valid, w, self_w):
    """acc[i] = self_w[i] x[i] + sum_u w[i, u] x[src[i, u]] over the valid
    entries in order, as a node's lane group sums them (FwdRow). x [N, HC];
    src, valid [N, U]; w [N, U, HC]; self_w [N, HC] or None. An entry's
    row is read only where it is valid."""
    n, hc = x.shape
    acc = self_w * x if self_w is not None else torch.zeros(n, hc)
    for u in range(src.shape[1]):
        j = torch.where(valid[:, u], src[:, u], torch.arange(n))
        row = torch.where(valid[:, u, None], x[j], torch.zeros(()))
        acc = acc + torch.where(valid[:, u, None], w[:, u] * row,
                                torch.zeros(()))
    return acc


def _pairs(k, heads, lpr):
    """The (entry, head) pairs of a node's softmax in its group of lpr
    lanes: pair p is lane p % lpr of tile p // lpr, entry p // hp and head
    p % hp (hp = heads rounded up to a power of two). Returns (p, entry
    index clamped into the list, head, head < heads, head clamped, hp)."""
    hp = _pow2(heads)
    tiles = max(1, math.ceil(k * hp / lpr))
    p = torch.arange(tiles * lpr)
    h = p % hp
    hv = h < heads
    return p, (p // hp).clamp(max=k - 1), h, hv, h.clamp(max=heads - 1), hp


def _pair_softmax(l, nl, heads, k, m0):
    """rows::pair_softmax: l [N, P] the pairs' logits, nl [N] the listed
    entries, m0 [N, lpr] each lane's starting max (its head's self logit or
    floor). Each lane takes the max and the sum of its tiles' pairs, then
    one xor tree among the group's lanes of its head. Returns (e [N, P]
    (0 outside the pairs), m [N, lpr], sum [N, lpr])."""
    n, lpr = m0.shape
    p, _, _, hv, _, hp = _pairs(k, heads, lpr)
    tiles = p.numel() // lpr
    pair = ((p // hp)[None] < nl[:, None]) & hv[None]
    m = torch.maximum(m0, torch.where(pair, l, -math.inf).reshape(
        n, tiles, lpr).amax(1))
    m = _xor_tree(m, hp, torch.maximum)
    e = torch.where(pair, torch.exp(l - m[:, p % lpr]), torch.zeros(()))
    total = e.reshape(n, tiles, lpr)[:, 0]
    for t in range(1, tiles):                       # a lane's tiles in order
        total = total + e.reshape(n, tiles, lpr)[:, t]
    return e, m, _xor_tree(total, hp, torch.add)


def _entry_weights(w, k, heads, lpr):
    """The pairs' weights [N, P] as [N, K, heads] (entry, head)."""
    p, u, h, hv, _, hp = _pairs(k, heads, lpr)
    own = hv & (p < k * hp)          # the pairs that name an entry
    out = torch.zeros(w.shape[0], k, heads)
    out[:, u[own], h[own]] = w[:, own]
    return out


def c_design(xh, att_src, att_dst, nbr_src, nbr_mask, el=None, el_self=None,
             *, self_loop=True, bias=None, node_mask=None, dmask=None):
    """Kernel C's decomposition in plain torch (arguments as
    ``ell_gat_reference``)."""
    f32 = torch.float32
    cd = xh.dtype
    lowp = cd == BF16
    n, hc = xh.shape
    heads, c = att_src.shape[-2:]
    k = nbr_src.shape[1]
    x = xh.to(f32)
    a_s = att_src.reshape(heads, c).to(cd).to(f32)
    a_d = att_dst.reshape(heads, c).to(cd).to(f32)
    a_src = (x.reshape(n, heads, c) * a_s).sum(-1)
    a_dst = (x.reshape(n, heads, c) * a_d).sum(-1)
    el = torch.zeros(n, k, heads) if el is None else el.to(f32)
    el_self = torch.zeros(n, heads) if el_self is None else el_self.to(f32)
    dm = torch.ones(n, k + 1, heads) if dmask is None else dmask.to(f32)
    mask = nbr_mask.to(torch.bool)
    hp = _pow2(heads)
    lpr = _lanes_per_node(hc, c, heads, lowp, ((k + 1) * hp + 2 * k) * 4)

    # the live slots, compacted in slot order (a ballot and a prefix count)
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    nl = mask.sum(1)
    src_c = nbr_src.long().gather(1, order)
    live_u = torch.arange(k)[None] < nl[:, None]                 # [N, K]

    p, u, h, hv, hh, hp = _pairs(k, heads, lpr)
    rows = torch.arange(n)[:, None]
    l = leaky_relu(a_src[src_c[:, u], hh[None]] + a_dst[:, hh]
                   + el[rows, order[:, u], hh[None]], SLOPE)
    lane_h = torch.arange(lpr) % hp
    lane_ok = torch.tensor(self_loop) & (lane_h < heads)[None]
    self_l = leaky_relu(a_src + a_dst + el_self, SLOPE)
    self_lane = torch.where(lane_ok, self_l[:, lane_h.clamp(max=heads - 1)],
                            -math.inf)                           # [N, lpr]
    e, m, total = _pair_softmax(l, nl, heads, k, self_lane)
    e_self = torch.where(lane_ok, torch.exp(self_lane - m), torch.zeros(()))
    den = torch.clamp_min(total + e_self, 1e-16)
    w = e / den[:, p % lpr] * dm[rows, order[:, u], hh[None]]
    self_w = e_self[:, :heads] / den[:, :heads] * dm[:, k]      # lanes h < hp

    # the gather: weights per (entry, column), the self term, the epilogue
    col_head = torch.arange(hc) // c
    acc = _gather(x, src_c, live_u,
                  _entry_weights(w, k, heads, lpr)[..., col_head],
                  self_w[:, col_head] if self_loop else None)
    if bias is not None:
        b = bias.reshape(hc).to(cd).to(f32)
        acc = (acc.to(BF16).to(f32) if lowp else acc) + b
    out = acc.to(cd)
    if node_mask is not None:
        out = torch.where(node_mask[:, None], out, torch.zeros((), dtype=cd))
    return out


def e_design(xh, a_cat_mat, el_t, el_self_t, banded):
    """Kernel E's decomposition in plain torch (arguments as
    ``band_part_reference``): kernel C's on the band layout, the slots
    with a window source listed, the weights left unnormalized, the max
    floored at -1e4 without a self loop."""
    f32 = torch.float32
    n, heads, c = xh.shape
    hc = heads * c
    k = banded.loc_t.shape[0]
    x = xh.reshape(n, hc).to(f32)
    ac = x @ a_cat_mat.to(xh.dtype).to(f32)
    a_src, a_dst = ac[:, :heads], ac[:, heads:]
    src, valid = (t.T for t in window_sources(banded.loc_t,
                                              banded.band_rows))
    el = el_t.to(f32).reshape(k, heads, n).permute(2, 0, 1)     # [N, K, H]
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    nl = valid.sum(1)
    src_c = src.gather(1, order)
    live_u = torch.arange(k)[None] < nl[:, None]
    hp = _pow2(heads)
    lists = -(-((k + 1) * hp * 4 + 4 * k) // 8) * 8 + 8 * k
    lpr = _lanes_per_node(hc, c, heads, xh.dtype == BF16, lists)

    p, u, h, hv, hh, hp = _pairs(k, heads, lpr)
    rows = torch.arange(n)[:, None]
    l = leaky_relu(a_src[src_c[:, u], hh[None]] + a_dst[:, hh]
                   + el[rows, order[:, u], hh[None]], SLOPE)
    lane_h = (torch.arange(lpr) % hp).clamp(max=heads - 1)
    has_self = el_self_t is not None
    self_l = leaky_relu(a_src + a_dst + (el_self_t.to(f32).T if has_self
                                         else 0.0), SLOPE)
    m0 = self_l[:, lane_h] if has_self else torch.full((n, lpr), -1e4)
    e, m, total = _pair_softmax(l, nl, heads, k, m0)
    e_self = torch.exp(m0 - m) if has_self else torch.zeros(n, lpr)
    den = torch.clamp_min(total + e_self, 1e-16)
    col_head = torch.arange(hc) // c
    y = _gather(x, src_c, live_u,
                _entry_weights(e, k, heads, lpr)[..., col_head],
                e_self[:, col_head] if has_self else None)
    return y, m[:, :heads], den[:, :heads]


def _c_inputs(k, heads, c, dtype, seed=1, nan_dead=False):
    g = _knn_graph(k, seed)
    gen = torch.Generator().manual_seed(seed)
    hc = heads * c

    def rnd(*shape, s=1.0):
        return torch.randn(*shape, generator=gen) * s

    node_mask = torch.from_numpy(g.node_mask)
    nbr_src = torch.from_numpy(g.nbr_src).long()
    nbr_mask = torch.from_numpy(g.nbr_mask)
    xh = rnd(N, hc)
    if nan_dead:
        # the dead slots name padded nodes whose rows are NaN: rows that no
        # live slot names
        pad = torch.nonzero(~node_mask).flatten()
        nbr_src = torch.where(nbr_mask, nbr_src, pad[torch.arange(
            N * k).reshape(N, k) % pad.numel()])
        xh[pad] = float("nan")
    return dict(xh=xh.to(dtype), att_src=rnd(1, heads, c, s=0.3),
                att_dst=rnd(1, heads, c, s=0.3), nbr_src=nbr_src,
                nbr_mask=nbr_mask, el=rnd(N, k, heads),
                el_self=rnd(N, heads), bias=rnd(hc, s=0.1),
                node_mask=node_mask)


def _close(out, ref, lowp):
    if lowp:
        d = (out.float() - ref.float()).abs()
        assert (d / (1 + ref.float().abs())).max().item() <= 1.6e-2
        assert (out == ref).float().mean().item() >= 0.99
    else:
        d = (out - ref).abs() / (1 + ref.abs())
        assert d.max().item() <= 1e-5, d.max().item()


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("heads", [1, 4, 8])
@pytest.mark.parametrize("k", [1, 5, 8, 16, 33])
def test_kernel_c_design_matches_reference(k, heads, dtype):
    """Compaction, pair tiles with a carried max and sum (K x hp > 32 for
    K 16 at 4 heads, K 5, 8, 16, 33 at 8), lane-group gather and the
    epilogue, with and without a self loop, against ell_gat_reference;
    nodes with no live slot get the bias alone (no self loop) and padded
    nodes 0."""
    kw = _c_inputs(k, heads, 8, dtype)
    for self_loop in (True, False):
        out = c_design(**kw, self_loop=self_loop)
        ref = ef.ell_gat_reference(**kw, self_loop=self_loop,
                                   negative_slope=SLOPE)
        assert out.dtype == ref.dtype == dtype
        _close(out, ref, dtype == BF16)
        assert not out[~kw["node_mask"]].any()
        if not self_loop:
            bias = kw["bias"].to(dtype)
            assert torch.equal(out[:3], bias.expand(3, -1))


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("heads,c", [(4, 64), (3, 12), (1, 300), (2, 6)])
def test_kernel_c_design_dropout_and_nan_rows(heads, c, dtype):
    """The dropout multipliers applied per pair (the denominator stays the
    undropped one), row widths of one, a few and 16-byte chunks, heads not
    a power of two, C % 4 != 0; NaN in the rows the dead slots name never
    reaches an output."""
    kw = _c_inputs(8, heads, c, dtype, seed=2, nan_dead=True)
    gen = torch.Generator().manual_seed(5)
    dmask = (torch.rand(N, 9, heads, generator=gen) < 0.9).float() / 0.9
    out = c_design(**kw, dmask=dmask)
    ref = ef.ell_gat_reference(**kw, dmask=dmask, negative_slope=SLOPE)
    live = kw["node_mask"]
    assert torch.isfinite(out[live].float()).all()
    assert torch.isfinite(ref[live].float()).all()
    _close(out, ref, dtype == BF16)


def _band_inputs(k, heads, c, dtype, self_loop, seed=3, r=32):
    g = _knn_graph(k, seed)
    banded = band_ell(g, band_rows=r, heads=heads).to("cpu")
    loc = banded.loc_t.clone()
    loc[:, 3:6] = -1                 # nodes with no in-band slot
    banded.loc_t = loc
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, s=1.0):
        return torch.randn(*shape, generator=gen) * s

    node_mask = torch.from_numpy(g.node_mask)
    xh = rnd(N, heads, c)
    xh[~node_mask] = float("nan")    # rows no in-band slot names
    return dict(xh=xh.to(dtype), a_cat_mat=rnd(heads * c, 2 * heads, s=0.3),
                el_t=rnd(k * heads, N),
                el_self_t=rnd(heads, N) if self_loop else None,
                banded=banded), node_mask


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("heads", [1, 4, 8])
@pytest.mark.parametrize("k", [1, 5, 8, 16, 33])
def test_kernel_e_design_matches_reference(k, heads, dtype):
    """Dense in-band lists, the pair softmax and the lane-group gather
    against band_part_reference: y, m and denom, with and without a
    self loop (the -1e4 floor), nodes with no in-band slot, NaN in the rows
    of padded nodes (their own outputs are NaN in both; no other)."""
    for self_loop in (True, False):
        kw, live = _band_inputs(k, heads, 8, dtype, self_loop)
        got = e_design(**kw)
        ref = eb.band_part_reference(**kw, negative_slope=SLOPE)
        for name, a, b in zip(("y", "m", "denom"), got, ref):
            a, b = a[live], b[live]
            assert torch.isfinite(a).all() and torch.isfinite(b).all(), name
            scale = b.abs().max().item() + 1e-12
            err = (a - b).abs().max().item()
            assert err <= 1e-5 * scale, (name, err, scale)
        if not self_loop:
            assert torch.equal(got[0][3:6], torch.zeros(3, 8 * heads))
            assert (got[1][3:6] == -1e4).all()
