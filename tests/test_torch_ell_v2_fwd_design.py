"""The decomposition behind kernel D (the banded-ELL GAT forward with the
spills folded in, ``csrc/ell_gat_v2_fwd.cu``) and the register form of its
attention dots (``csrc/ell_gat_rows.cuh``), emulated on the CPU in plain
torch and held against the plain version ``_v2_plain`` at small sizes
(256 nodes in 16-row bands, K in {1, 5, 8, 16}, heads in {1, 4, 8}), in
f32 and with the bf16 form's roundings.

- D: a destination is owned by a group of lpr lanes (the fewest that hold
  its row at two 16-byte chunks a lane, 32 when the 32 / lpr nodes' lists
  would take more than 8 KB); the slots with a window source are listed
  densely (a dead or spilled slot is never an entry, its row never read),
  then the first K entries of the row's range in the destination-sorted
  spill tables that lie in its band's table; lane p of the group owns the
  pair (entry p // hp, head p % hp); the in-band softmax is kernel E's
  (self logit or the -1e4 floor as the starting max, each lane's tiles in
  order, then an xor tree among the group's lanes of a head); the spill
  exponents exp(min(l - m, 60)) against the in-band max come from the same
  pair lanes, 0 for an entry whose dst_loc does not name the row; the
  denominator is the floored in-band one plus the spill sum; the dropout
  multipliers scale the weights only; the gather adds the self row, the
  in-band rows and the spill rows in list order (each spill message
  rounded to bf16 first in the bf16 form), then the entries past K one by
  one, and multiplies by 1 / denominator once.
- The dots: each lane's FMA chains, then the reduce-scatter butterfly
  that keeps half of a lane's sums at each of the first log2(MM) xor
  offsets: the same partial sums as one xor tree per sum.

Tolerances: f32 1e-5 x (1 + |ref|) (the plain version sums the same f32
terms in another order and divides where the kernel multiplies by the
reciprocal: ~1e-7 relative); bf16 1.6e-2 x (1 + |ref|) (the card tests'
bf16 tolerance: one or two bf16 rounding steps of the output, where a
~1e-7 difference of the f32 sum can flip a rounding), with at least 99 %
of the outputs equal bit for bit. The reduce-scatter is held bit for bit.
"""

import math
import types

import numpy as np
import pytest
import torch

from bathymetric_gnn_tpu_torch.ops.cuda import ell_gat_banded as eb
from bathymetric_gnn_tpu_torch.ops.graph import sorted_segments
from bathymetric_gnn_tpu_torch.ops.ell_banded import (band_ell, leaky_relu,
                                                      window_sources)
from test_torch_ell_fwd_design import (BF16, SLOPE, _entry_weights, _gather,
                                       _lanes_per_node, _pair_softmax,
                                       _pairs, _pow2, _xor_tree)

torch.set_num_threads(2)

N = 256
R = 16


def spill_graph(n, k, r, seed=0):
    """An ELL graph (numpy nbr_src, nbr_mask, edge_attr, node_mask) of n
    nodes in r-row bands, the last n / 16 padded (no live slot). Live slots
    name sources within r rows of their destination (inside its band's
    window), except in bands 0 and 2, where a quarter of the slots name a
    source three bands on (spilled) and row 2r + 5 spills every slot;
    the other bands have no spill. Rows 0-2 have no live slot; the dead
    slots name padded nodes."""
    rg = np.random.default_rng(seed)
    n_pad = n // 16
    n_live = n - n_pad
    i = np.arange(n)[:, None]
    src = np.clip(i + rg.integers(-r, r + 1, (n, k)), 0, n_live - 1)
    mask = rg.random((n, k)) < 0.8
    band = i // r
    far = (rg.random((n, k)) < 0.25) & ((band == 0) | (band == 2))
    far[2 * r + 5] = True
    mask[2 * r + 5] = True
    src = np.where(far, (band + 3) * r + rg.integers(0, r, (n, k)), src)
    mask[:3] = False
    mask[n_live:] = False
    src = np.where(mask, src, n_live + rg.integers(0, n_pad, (n, k)))
    return types.SimpleNamespace(
        nbr_src=src.astype(np.int32), nbr_mask=mask,
        edge_attr=rg.normal(size=(n, k, 3)).astype(np.float32),
        node_mask=np.arange(n) < n_live)


def v2_inputs(k, heads, c, dtype, *, self_loop=True, drop=False, seed=0,
              n=N, r=R, full_band=True):
    """Kernel D's inputs (those of ``_v2_plain`` and the destination-sorted
    spill tables) on ``spill_graph``, split by band_ell with the spill
    tables exactly as wide as the fullest band's spills (``full_band``);
    NaN in the padded nodes' rows (no live slot or spill entry names
    them). Returns (args, banded, node_mask)."""
    g = spill_graph(n, k, r, seed)
    s_max = None
    if full_band:
        dl = band_ell(g, band_rows=r, heads=heads).spill_dst_local_b
        s_max = int((dl >= 0).sum(-1).max())
    banded = band_ell(g, band_rows=r, heads=heads, s_max=s_max).to("cpu")
    gen = torch.Generator().manual_seed(seed)

    def rnd(*shape, s=1.0):
        return torch.randn(*shape, generator=gen) * s

    hc = heads * c
    live = torch.from_numpy(g.node_mask)
    xh = rnd(n, heads, c)
    xh[~live] = float("nan")
    att = rnd(2, heads, c, s=0.3)
    diag = (torch.arange(hc)[:, None] // c
            == torch.arange(heads)[None]).float()
    a_cat = torch.cat([diag * att[0].reshape(hc, 1),
                       diag * att[1].reshape(hc, 1)], 1)
    xf = xh.reshape(n, hc).to(dtype)
    l_spill, xh_spill = eb._spill_inputs(
        xf, (xh * att[0]).sum(-1), (xh * att[1]).sum(-1), rnd(3, heads),
        banded, SLOPE, eb._plain_gather)
    t_count, _, s = banded.spill_dst_local_b.shape
    masks = (None, None)
    if drop:
        masks = tuple((torch.rand(*shape, generator=gen) < 0.9).float() / 0.9
                      for shape in (((k + 1) * heads, n),
                                    (t_count, heads, s)))
    args = dict(xh_flat=xf, a_cat_mat=a_cat, loc_t=banded.loc_t,
                el_t=banded.negmask_t + rnd(k * heads, n),
                el_self_t=rnd(heads, n) if self_loop else None,
                l_spill_b=l_spill, xh_spill_b=xh_spill,
                dst_loc_b=banded.spill_dst_local_b, dmask_t=masks[0],
                dmask_sp_b=masks[1])
    return args, banded, live


def _node_bytes(k, hp):
    """One destination's lists (v2_node_bytes): [3 + 2K, hp] floats, [3K]
    ints, 8-byte aligned, then [2K] long long."""
    return ((3 + 2 * k) * hp * 4 + 3 * k * 4 + 7) // 8 * 8 + 2 * k * 8


def d_design(xh_flat, a_cat_mat, loc_t, el_t, el_self_t, l_spill_b,
             xh_spill_b, dst_loc_b, sp_perm, sp_row_ptr, *, band_rows,
             dmask_t=None, dmask_sp_b=None):
    """Kernel D's decomposition in plain torch (arguments as ``_v2_plain``
    and the spill entries by destination, perm [T * S] / row_ptr [N + 1])."""
    f32 = torch.float32
    cd = xh_flat.dtype
    lowp = cd == BF16
    n, hc = xh_flat.shape
    heads = a_cat_mat.shape[1] // 2
    c = hc // heads
    k = loc_t.shape[0]
    r = band_rows
    t_count, _, s_max = l_spill_b.shape
    x = xh_flat.to(f32)
    ac = x @ a_cat_mat.to(cd).to(f32)
    a_src, a_dst = ac[:, :heads], ac[:, heads:]
    src, valid = (t.T for t in window_sources(loc_t, r))
    el = el_t.to(f32).reshape(k, heads, n).permute(2, 0, 1)      # [N, K, H]
    dm = (torch.ones(n, k + 1, heads) if dmask_t is None else
          dmask_t.to(f32).reshape(k + 1, heads, n).permute(2, 0, 1))
    dsp = (torch.ones(t_count, heads, s_max) if dmask_sp_b is None else
           dmask_sp_b.to(f32)).reshape(-1)
    l_sp = l_spill_b.to(f32).reshape(-1)
    xs_flat = xh_spill_b.to(f32).reshape(-1, hc)
    dst_flat = dst_loc_b.reshape(-1).long()
    hp = _pow2(heads)
    lpr = _lanes_per_node(hc, c, heads, lowp, _node_bytes(k, hp))
    rows = torch.arange(n)[:, None]
    band = torch.arange(n) // r
    row_in_band = torch.arange(n) % r
    has_self = el_self_t is not None

    # the slots with a window source, listed in slot order
    order = torch.argsort((~valid).to(torch.int8), dim=1, stable=True)
    nl = valid.sum(1)
    src_c = src.gather(1, order)
    live_u = torch.arange(k)[None] < nl[:, None]

    # the in-band softmax over (entry, head) pairs (kernel E's)
    p, u, h, hv, hh, hp = _pairs(k, heads, lpr)
    lg = leaky_relu(a_src[src_c[:, u], hh[None]] + a_dst[:, hh]
                    + el[rows, order[:, u], hh[None]], SLOPE)
    lane_h = (torch.arange(lpr) % hp).clamp(max=heads - 1)
    self_l = leaky_relu(a_src + a_dst + (el_self_t.to(f32).T if has_self
                                         else 0.0), SLOPE)
    m0 = self_l[:, lane_h] if has_self else torch.full((n, lpr), -1e4)
    e, m, total = _pair_softmax(lg, nl, heads, k, m0)
    e_self = torch.exp(m0 - m) if has_self else torch.zeros(n, lpr)
    den = torch.clamp_min(total + e_self, 1e-16)

    # the row's first K spill entries in its band's table, listed in order
    perm, row_ptr = sp_perm.long(), sp_row_ptr.long()
    cnt = row_ptr[1:] - row_ptr[:-1]
    raw = torch.full((n, k), -1, dtype=torch.long)
    for j in range(k):
        has = j < cnt
        at = (row_ptr[:-1] + j).clamp(max=max(perm.numel() - 1, 0))
        raw[:, j] = torch.where(has, perm[at], torch.full_like(at, -1))
    sp = raw - band[:, None] * s_max
    listed = (raw >= 0) & (sp >= 0) & (sp < s_max)
    so = torch.argsort((~listed).to(torch.int8), dim=1, stable=True)
    ns = listed.sum(1)
    ent = raw.gather(1, so).clamp_min(0)                          # [N, K]
    spos = sp.gather(1, so).clamp(0, s_max - 1)
    own = (dst_flat[ent] == row_in_band[:, None]) & (
        torch.arange(k)[None] < ns[:, None])

    # the spill exponents in the pair lanes, against the in-band max
    tiles = max(1, math.ceil(k * hp / lpr))
    q = torch.arange(tiles * lpr)
    eq, hq = (q // hp).clamp(max=k - 1), q % hp
    hqc = hq.clamp(max=heads - 1)
    lq = l_sp[(band[:, None] * heads + hqc[None]) * s_max + spos[:, eq]]
    ok = own[:, eq] & (q // hp < k)[None] & (hq < heads)[None]
    es = torch.where(ok, torch.exp(torch.clamp(lq - m[:, q % lpr],
                                               max=60.0)), torch.zeros(()))
    ssum = es.reshape(n, tiles, lpr)[:, 0]
    for t in range(1, tiles):                       # a lane's tiles in order
        ssum = ssum + es.reshape(n, tiles, lpr)[:, t]
    ssum = _xor_tree(ssum, hp, torch.add)
    den_h = (den + ssum)[:, :heads]

    # the weights (dropped) and the gather: self, in-band, spill, the tail
    w = e * dm[rows, order[:, u], hh[None]]
    self_w = e_self[:, :heads] * dm[:, k]
    col_head = torch.arange(hc) // c
    acc = _gather(x, src_c, live_u,
                  _entry_weights(w, k, heads, lpr)[..., col_head],
                  self_w[:, col_head] if has_self else None)
    ws = es * dsp[(band[:, None] * heads + hqc[None]) * s_max + spos[:, eq]]
    ws_e = _entry_weights(ws, k, heads, lpr)                     # [N, K, H]
    for j in range(k):
        msg = ws_e[:, j, col_head] * xs_flat[ent[:, j]]
        if lowp:
            msg = msg.to(BF16).to(f32)
        acc = torch.where(own[:, j, None], acc + msg, acc)
    dt = torch.zeros(n, hc)
    for j in range(k, int(cnt.max().item()) if cnt.numel() else 0):
        f = torch.where(j < cnt, perm[(row_ptr[:-1] + j).clamp(
            max=perm.numel() - 1)], torch.full_like(cnt, -1))
        spj = f - band * s_max
        mine = (f >= 0) & (spj >= 0) & (spj < s_max)
        f = f.clamp_min(0)
        mine = mine & (dst_flat[f] == row_in_band)
        o = (band[:, None] * heads + col_head[None]) * s_max \
            + spj.clamp(0, s_max - 1)[:, None]
        ex = torch.exp(torch.clamp(l_sp[o] - m[:, col_head], max=60.0))
        msg = ex * dsp[o] * xs_flat[f]
        if lowp:
            msg = msg.to(BF16).to(f32)
        acc = torch.where(mine[:, None], acc + msg, acc)
        dt = torch.where(mine[:, None], dt + ex, dt)
    out = acc * (1.0 / (den_h[:, col_head] + dt))
    return out.to(cd)


def spill_case_tables(dst_loc_b, case, k, r):
    """Spill tables band_ell never builds, on a band layout of r-row bands
    (dst_loc_b [T, 1, S], on the CPU): "no spill" (every entry dead);
    "crowded row" (band 2's row 7 has 2K + 3 entries); "stray entries"
    (row 2r + 1's range also lists an entry of another row of its band and
    one of band 0); else band_ell's own. Returns (dst_loc_b, perm,
    row_ptr): the entries grouped by destination as sorted_segments gives
    them."""
    t_count, _, s_max = dst_loc_b.shape
    dl = dst_loc_b.reshape(t_count, s_max).clone()
    n = t_count * r
    if case == "no spill":
        dl.fill_(-1)
    elif case == "crowded row":
        dl[2, :2 * k + 3] = 7
    flat = torch.arange(t_count)[:, None] * r + dl.clamp_min(0)
    perm, row_ptr = (torch.from_numpy(a) for a in sorted_segments(
        flat.numpy(), (dl >= 0).numpy(), n))
    if case == "stray entries":
        other = 2 * s_max + int(((dl[2] >= 0) & (dl[2] != 1)).nonzero()[0])
        far = int((dl[0] >= 0).nonzero()[0])
        at = int(row_ptr[2 * r + 2])
        perm = torch.cat([perm[:at], torch.tensor([other, far],
                                                  dtype=perm.dtype),
                          perm[at:]])
        row_ptr = row_ptr + torch.where(torch.arange(n + 1) > 2 * r + 1, 2,
                                        0).to(row_ptr.dtype)
    return dl.reshape(t_count, 1, s_max), perm, row_ptr


def _close(out, ref, live, lowp):
    out, ref = out.float()[live], ref.float()[live]
    assert torch.isfinite(out).all() and torch.isfinite(ref).all()
    d = (out - ref).abs() / (1 + ref.abs())
    if lowp:
        assert d.max().item() <= 1.6e-2, d.max().item()
        assert (out == ref).float().mean().item() >= 0.99
    else:
        assert d.max().item() <= 1e-5, d.max().item()


def _tables(banded):
    return banded.spill_perm_d, banded.spill_row_ptr_d


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("heads", [1, 4, 8])
@pytest.mark.parametrize("k", [1, 5, 8, 16])
def test_kernel_d_design_matches_reference(k, heads, dtype):
    """Dense in-band and spill lists, the pair softmax, the spill exponents
    against the in-band max and the lane-group gather against _v2_plain,
    with and without a self loop and with and without streamed dropout, on
    a graph with a band filled to s_max, bands with no spill, a row whose
    every slot spilled and rows with no live slot; NaN in the rows of
    padded nodes (no live slot or spill entry names them)."""
    for self_loop in (True, False):
        for drop in (False, True):
            args, banded, live = v2_inputs(k, heads, 8, dtype,
                                           self_loop=self_loop, drop=drop)
            dl = banded.spill_dst_local_b[:, 0]
            s_max = dl.shape[1]
            per_band = (dl >= 0).sum(1)
            assert int(per_band.max()) == s_max            # a full band
            assert bool((per_band == 0).any())             # no spill
            assert not bool((banded.loc_t[:, 2 * R + 5] >= 0).any())
            got = d_design(**args, sp_perm=banded.spill_perm_d,
                           sp_row_ptr=banded.spill_row_ptr_d,
                           band_rows=R)
            ref = eb._v2_plain(**args, band_rows=R, negative_slope=SLOPE)
            assert got.dtype == ref.dtype == dtype
            _close(got, ref, live, dtype == BF16)
            if not self_loop:
                # no live slot, no spill, no self loop: the -1e4 floor's
                # denominator 1e-16 over an empty sum
                assert not got[:3].float().any()


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("case", ["crowded row", "stray entries",
                                  "no spill"])
def test_kernel_d_design_spill_tables(case, dtype):
    """The spill entries by destination on tables band_ell never builds: a
    row with 2K + 3 spill entries (the first K listed, the rest visited one
    by one), entries the tables list for a row whose dst_loc names another
    row or that lie outside the row's band table (skipped: _v2_plain reads
    dst_loc alone), and a graph with no spill at all."""
    k, heads = 8, 4
    args, banded, live = v2_inputs(k, heads, 8, dtype, drop=True, seed=3,
                                   full_band=False)
    args["dst_loc_b"], perm, row_ptr = spill_case_tables(
        args["dst_loc_b"], case, k, R)
    got = d_design(**args, sp_perm=perm, sp_row_ptr=row_ptr, band_rows=R)
    ref = eb._v2_plain(**args, band_rows=R, negative_slope=SLOPE)
    _close(got, ref, live, dtype == BF16)
    if case == "crowded row":
        assert int(row_ptr[2 * R + 8] - row_ptr[2 * R + 7]) > 2 * k


def _dots_lanes(xh, acat):
    """Each lane's FMA chains over the columns lane, lane + 32, ... of one
    node, for all M sums: [32, M] f32 (products and sums rounded to f32 one
    at a time)."""
    hc, mm = acat.shape
    p = torch.zeros(32, mm)
    for t in range((hc + 31) // 32):
        cols = torch.arange(32) + 32 * t
        ok = cols < hc
        xv = torch.where(ok, xh[cols.clamp(max=hc - 1)], torch.zeros(()))
        av = torch.where(ok[:, None], acat[cols.clamp(max=hc - 1)],
                         torch.zeros(()))
        p = p + xv[:, None] * av
    return p


def _xor_trees(p):
    """One xor tree a sum (offsets 16 ... 1), every lane adding its own
    partial and its partner's: [32, M], the same in every lane."""
    o = 16
    while o >= 1:
        p = p + p[torch.arange(32) ^ o]
        o //= 2
    return p


def _reduce_scatter(p):
    """The register form's reduction: at each of the first log2(MM) xor
    offsets a lane keeps the half of its sums its lane bit selects and
    adds its partner's copy of the same sums; then a plain butterfly on the
    one sum left. Returns the sum each lane holds [32] and its index."""
    mm = p.shape[1]
    lg = mm.bit_length() - 1
    lanes = torch.arange(32)
    for lv in range(lg):
        o = 16 >> lv
        half = p.shape[1] // 2
        up = (lanes & o) != 0
        send = torch.where(up[:, None], p[:, :half], p[:, half:])
        keep = torch.where(up[:, None], p[:, half:], p[:, :half])
        p = keep + send[lanes ^ o]
    s = p[:, 0]
    o = 16 >> lg
    while o >= 1:
        s = s + s[lanes ^ o]
        o //= 2
    return s, lanes >> (5 - lg)


@pytest.mark.parametrize("hc,mm", [(64, 2), (256, 8), (100, 4), (6, 16),
                                   (128, 16), (256, 2)])
def test_dots_reduce_scatter_keeps_the_xor_tree_bits(hc, mm):
    """The reduce-scatter butterfly of the register form gives each sum
    the bits one xor tree a sum gives (the generic form's), for random
    per-lane partials of magnitudes that make the order matter."""
    gen = torch.Generator().manual_seed(hc * 31 + mm)
    for _ in range(20):
        xh = torch.randn(hc, generator=gen) * 10 ** torch.randint(
            -3, 4, (hc,), generator=gen).float()
        acat = torch.randn(hc, mm, generator=gen)
        p = _dots_lanes(xh, acat)
        full = _xor_trees(p)
        mine, m = _reduce_scatter(p)
        assert torch.equal(mine, full[torch.arange(32), m])
        assert torch.equal(full, full[:1].expand(32, -1))
