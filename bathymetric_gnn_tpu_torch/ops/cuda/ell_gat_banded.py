"""GAT layer on the banded ELL layout: CUDA kernels E (the band part), D
(the fused layer with the spill edges folded in) and D' (D's backward),
and their plain versions.

Counterpart of the older entries of
``bathymetric_gnn_tpu/ops/pallas/ell_gat_fused.py``, f32 and bf16 (the JAX
``compute_dtype``, picked by the dtype of ``xh``):
- ``ell_gat_band_part`` (``ell_gat_band_part_pallas``, the Pallas
  ``_kernel``): the softmax over each row's in-band slots and self loop,
  returning the UNNORMALIZED weighted sum y [N, HC] and the row statistics
  m and denom [N, heads]; ``ops/ell_banded.banded_gat_spill_pass_flat``
  completes the layer. It has no backward: under grad mode with an input
  that requires grad it raises (so does the JAX package's entry, which has
  no VJP).
- ``ell_gat_fused_v2`` (``ell_gat_fused_pallas``, the Pallas ``_kernel_v2``
  with ``_bwd_kernel_v2`` as its custom VJP ``_fused_v2``): the whole
  layer, spills folded in against the in-band max (the 60-clamp), the
  streamed dropout masks of ``models/conv_ell.make_banded_dropout_masks``
  applied to the weights, the output normalized. The spill rows and their
  logits are gathered here in torch, through ``gather_rows_reduce_bwd``
  (kernel F mode (a) as their backward).

In the bf16 form xh, a_cat_mat (rounded to bf16, the JAX wrappers'
``a_cat_mat.astype(cd)``) and the spill rows (gathered from the bf16 xh)
stream as bf16, every logit, softmax and sum runs in f32, E returns f32 as
its TPU kernel does, D returns bf16 with each spill message rounded to
bf16 before it is added (the TPU kernel's bf16 spill dot), and D' returns
d xh in bf16 and the rest in f32 (d xh_spill cast to bf16 for its
gather's backward, kernel F mode (a) on a bf16 cotangent).

The layout is ``ops/ell_banded.band_ell``'s (``loc_t`` [K, N], ``el_t``
[K * heads, N], ``el_self_t`` [heads, N], per-band spill tables). The
kernels need no 3R-row window: Hopper gathers each in-band source's row
directly. A slot with no window source (``ops/ell_banded.window_sources``)
is left out by E (masked from loc) and counts with a zero attention dot
in D and D', whose ``el_t`` must carry NEG_BIG there, as the TPU kernels
expect (``negmask_t``).

Which implementation runs follows only the device of ``xh``: a CUDA tensor
launches the hand-written kernels (``csrc/ell_gat_band.cu``,
``csrc/ell_gat_v2_fwd.cu``, ``csrc/ell_gat_v2_bwd.cu``), a CPU tensor runs
the plain versions (``band_part_reference``, ``fused_v2_reference``, and
autograd through the latter). There is no fallback between them: a CUDA
input the kernels do not take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ell_banded import (NEG_BIG, gather_rows_reduce_bwd, leaky_relu,
                          window_sources)
from .grid_gat_fused import _DTYPE_CODE

# Launches in this process of kernel E, kernel D and kernel D'. Only
# ``call_band_kernel``, ``call_v2_kernel`` and ``call_v2_bwd_kernel`` add to
# them; callers reset them to 0 to count the launches of one run.
band_launches = 0
v2_launches = 0
v2_bwd_launches = 0

_MAX_HEADS = 8
_MAX_K = 64


def _band_softmax(xh_flat, a_cat_mat, loc_t, el_t, el_self_t, band_rows,
                  negative_slope, masked):
    """The in-band softmax of kernels E, D and D' in plain torch: x [N, HC]
    f32, e = exp(l - m) [N, K, heads], e_self [N, heads] or None, m (held
    constant: no gradient) and the clamped denominator [N, heads], and the
    in-band source rows [N, K, heads, C] (0 where a slot has no source).
    ``masked``: E's form, slots with no source left out of the softmax.
    a_cat_mat is rounded to xh's dtype (bf16 in the bf16 form) first."""
    f32 = torch.float32
    n, hc = xh_flat.shape
    heads = a_cat_mat.shape[1] // 2
    k = loc_t.shape[0]
    x = xh_flat.to(f32)
    ac = x @ a_cat_mat.to(xh_flat.dtype).to(f32)              # [N, 2H]
    src, valid = (t.T for t in window_sources(loc_t, band_rows))
    a_src, a_dst = ac[:, :heads], ac[:, heads:]
    g = a_src[src.reshape(-1)].reshape(n, k, heads)
    g = torch.where(valid[..., None], g, torch.zeros_like(g))
    el = el_t.to(f32).reshape(k, heads, n).permute(2, 0, 1)   # [N, K, H]
    lg = leaky_relu(g + a_dst[:, None, :] + el, negative_slope)
    if masked:
        lg = torch.where(valid[..., None], lg, torch.full_like(lg, NEG_BIG))
    if el_self_t is not None:
        self_lg = leaky_relu(a_src + a_dst + el_self_t.to(f32).T,
                             negative_slope)
        floor = self_lg
    else:
        floor = torch.full_like(a_dst, -1e4)
    m = torch.maximum(lg.max(dim=1).values, floor).detach()
    e = torch.exp(lg - m[:, None, :])
    if masked:
        e = torch.where(valid[..., None], e, torch.zeros_like(e))
    den = e.sum(1)
    e_self = None
    if el_self_t is not None:
        e_self = torch.exp(self_lg - m)
        den = den + e_self
    den = den.clamp_min(1e-16)
    nbr = x[src.reshape(-1)].reshape(n, k, heads, hc // heads)
    nbr = torch.where(valid[..., None, None], nbr, torch.zeros_like(nbr))
    return x, e, e_self, m, den, nbr


def band_part_reference(xh, a_cat_mat, el_t, el_self_t, banded,
                        negative_slope: float = 0.2):
    """Plain PyTorch version of kernel E, with the signature of
    ``ell_gat_band_part``: xh [N, heads, C]; a_cat_mat [HC, 2 * heads]
    ([att_src | att_dst] as a block-diagonal matrix, or any); el_t
    [K * heads, N]; el_self_t [heads, N] or None (no self loop); banded a
    BandedEll of tensors. Returns (y [N, HC] unnormalized, m [N, heads],
    denom [N, heads]), f32 (also for a bf16 xh)."""
    n, heads, c = xh.shape
    x, e, e_self, m, den, nbr = _band_softmax(
        xh.reshape(n, heads * c), a_cat_mat, banded.loc_t, el_t, el_self_t,
        banded.band_rows, negative_slope, masked=True)
    y = (nbr * e[..., None]).sum(1)
    if e_self is not None:
        y = y + x.reshape(n, heads, c) * e_self[..., None]
    return y.reshape(n, heads * c), m, den


def _plain_gather(table, idx, perm, row_ptr):
    return table[idx.long()]


def _spill_inputs(xh_flat, a_src, a_dst, m_edge, banded, negative_slope,
                  gather):
    """The spill rows xh_spill_b [T, S, HC] and their LeakyReLU'd logits
    l_spill_b [T, heads, S] (-1e30 in dead entries), gathered with
    ``gather(table, idx, perm, row_ptr)`` (as the JAX entry builds them
    outside its kernel)."""
    heads = a_src.shape[1]
    t_count, s_max = banded.spill_src_b.shape
    flat_src = banded.spill_src_b.reshape(-1)
    flat_dst = banded.spill_dst_b.reshape(-1)
    xh_spill_b = gather(xh_flat, flat_src, banded.spill_perm,
                        banded.spill_row_ptr).reshape(t_count, s_max, -1)
    l_s = (gather(a_src, flat_src, banded.spill_perm, banded.spill_row_ptr)
           + gather(a_dst, flat_dst, banded.spill_perm_d,
                    banded.spill_row_ptr_d))
    if m_edge is not None:
        l_s = l_s + banded.spill_eattr_b.reshape(
            -1, banded.spill_eattr_b.shape[-1]) @ m_edge
    l_s = leaky_relu(l_s, negative_slope)
    dead = banded.spill_dst_local_b.reshape(-1) < 0
    l_s = torch.where(dead[:, None], torch.full_like(l_s, -1e30), l_s)
    return l_s.reshape(t_count, s_max, heads).permute(0, 2, 1), xh_spill_b


def _v2_plain(xh_flat, a_cat_mat, loc_t, el_t, el_self_t, l_spill_b,
              xh_spill_b, dst_loc_b, *, band_rows: int,
              negative_slope: float = 0.2, dmask_t=None, dmask_sp_b=None):
    """Kernel D's function on its own inputs (those of ``_FusedV2``):
    xh_flat [N, HC], a_cat_mat [HC, 2 * heads], loc_t [K, N], el_t
    [K * heads, N], el_self_t [heads, N] or None, l_spill_b [T, heads, S],
    xh_spill_b [T, S, HC], dst_loc_b [T, 1, S] int (row in the band, -1
    dead), dmask_t [(K+1) * heads, N] and dmask_sp_b [T, heads, S] or
    None. Returns out [N, HC] in xh_flat's dtype (a bf16 form rounds each
    spill message to bf16 before it is summed). As in D', m is a constant
    and the spill exponent's clamp passes the gradient of the unclamped
    exp."""
    f32 = torch.float32
    cd = xh_flat.dtype
    n, hc = xh_flat.shape
    heads = a_cat_mat.shape[1] // 2
    k = loc_t.shape[0]
    x, e, e_self, m, den, nbr = _band_softmax(
        xh_flat, a_cat_mat, loc_t, el_t, el_self_t, band_rows,
        negative_slope, masked=False)
    t_count, _, s_max = l_spill_b.shape
    dloc = dst_loc_b.reshape(t_count, s_max).long()
    live = ((dloc >= 0) & (dloc < band_rows)).reshape(-1)
    rows = (torch.arange(t_count, device=dloc.device)[:, None] * band_rows
            + dloc.clamp_min(0)).reshape(-1)
    rows = torch.where(live, rows, torch.zeros_like(rows))
    z = l_spill_b.to(f32).permute(0, 2, 1).reshape(-1, heads) - m[rows]
    e_s = torch.exp(z - (z - 60.0).clamp_min(0.0).detach())   # [T*S, H]
    e_s = torch.where(live[:, None], e_s, torch.zeros_like(e_s))
    den = den + torch.zeros_like(den).index_add_(0, rows, e_s)
    w, w_self, w_s = e, e_self, e_s
    if dmask_t is not None:
        dm = dmask_t.to(f32).reshape(k + 1, heads, n).permute(2, 0, 1)
        w = e * dm[:, :k]
        if e_self is not None:
            w_self = e_self * dm[:, k]
        w_s = e_s * dmask_sp_b.to(f32).permute(0, 2, 1).reshape(-1, heads)
    y = (nbr * w[..., None]).sum(1)
    if w_self is not None:
        y = y + x.reshape(n, heads, -1) * w_self[..., None]
    msg = xh_spill_b.to(f32).reshape(-1, heads, hc // heads) * w_s[..., None]
    if cd != f32:
        msg = msg.to(cd).to(f32)
    y = y + torch.zeros_like(y).index_add_(0, rows, msg)
    return (y / den[..., None]).reshape(n, hc).to(cd)


def fused_v2_reference(xh, a_src, a_dst, a_cat_mat, el_t, el_self_t,
                       m_edge, banded, negative_slope: float = 0.2,
                       dropout_masks=None):
    """Plain PyTorch version of kernel D, with the signature of
    ``ell_gat_fused_v2`` (its spill gathers plain row gathers too);
    through autograd, the plain version of kernel D'. Returns [N, HC] in
    xh's dtype."""
    n, heads, c = xh.shape
    xh_flat = xh.reshape(n, heads * c)
    l_spill_b, xh_spill_b = _spill_inputs(xh_flat, a_src, a_dst, m_edge,
                                          banded, negative_slope,
                                          _plain_gather)
    dmask_t, dmask_sp_b = dropout_masks or (None, None)
    return _v2_plain(xh_flat, a_cat_mat, banded.loc_t, el_t, el_self_t,
                     l_spill_b, xh_spill_b, banded.spill_dst_local_b,
                     band_rows=banded.band_rows,
                     negative_slope=negative_slope, dmask_t=dmask_t,
                     dmask_sp_b=dmask_sp_b)


def _no_grad_wanted(tensors, entry: str) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{entry} (kernel E) has no backward: call it under "
            "torch.no_grad(); the banded layer trains through kernels D and "
            "D' (ell_gat_fused_v2) or C and C'")


def ell_gat_band_part(xh, a_cat_mat, el_t, el_self_t, banded,
                      negative_slope: float = 0.2):
    """Band pass of the banded GAT layer (the JAX
    ``ell_gat_band_part_pallas``): xh [N, heads, C]; a_cat_mat [HC,
    2 * heads]; el_t [K * heads, N]; el_self_t [heads, N] or None;
    ``banded`` an ``ops/ell_banded.BandedEll`` of tensors. Returns (y
    [N, HC] unnormalized, m [N, heads], denom [N, heads]), f32 for a
    float32 or a bf16 xh. A CUDA ``xh`` launches kernel E, a CPU ``xh`` runs
    the plain version."""
    _no_grad_wanted((xh, a_cat_mat, el_t, el_self_t), "ell_gat_band_part")
    if xh.device.type == "cuda":
        n, heads, c = xh.shape
        return call_band_kernel(**kernel_args(
            xh.reshape(n, heads * c), a_cat_mat, banded.loc_t, el_t,
            el_self_t, band_rows=banded.band_rows,
            negative_slope=negative_slope))
    if xh.device.type == "cpu":
        return band_part_reference(xh, a_cat_mat, el_t, el_self_t, banded,
                                   negative_slope)
    raise ValueError(f"unsupported device {xh.device}")


def ell_gat_fused_v2(xh, a_src, a_dst, a_cat_mat, el_t, el_self_t, m_edge,
                     banded, negative_slope: float = 0.2,
                     dropout_masks=None):
    """The fused banded GAT layer (the JAX ``ell_gat_fused_pallas``),
    differentiable in xh, a_src, a_dst, a_cat_mat, el_t, el_self_t and
    m_edge. xh [N, heads, C]; a_src, a_dst [N, heads] attention dots (for
    the spill logits); a_cat_mat [HC, 2 * heads]; el_t [K * heads, N]
    (NEG_BIG in dead and spilled slots); el_self_t [heads, N] or None;
    m_edge [Fe, heads] or None; ``banded`` a BandedEll of tensors;
    ``dropout_masks`` None or ([(K+1) * heads, N], [T, heads, S]) weight
    multipliers. Returns the normalized output [N, HC] in xh's dtype
    (float32 or bfloat16; the spill rows are gathered in it).

    The spill rows and the spill logits are gathered here in torch, the
    gathers' backward kernel F mode (a) over the BandedEll's sorted tables
    (``gather_rows_reduce_bwd``). CUDA: kernel D forward and kernel D'
    backward (``_FusedV2``), keeping only their inputs between them. CPU:
    kernel D's function in plain torch, and autograd."""
    n, heads, c = xh.shape
    xh_flat = xh.reshape(n, heads * c)
    l_spill_b, xh_spill_b = _spill_inputs(xh_flat, a_src, a_dst, m_edge,
                                          banded, negative_slope,
                                          gather_rows_reduce_bwd)
    dmask_t, dmask_sp_b = dropout_masks or (None, None)
    if xh.device.type == "cuda":
        return _FusedV2.apply(
            xh_flat, a_cat_mat, el_t, el_self_t, l_spill_b, xh_spill_b,
            banded.loc_t, banded.spill_dst_local_b, dmask_t, dmask_sp_b,
            banded.band_perm, banded.band_row_ptr, banded.spill_perm_d,
            banded.spill_row_ptr_d, (banded.band_rows, float(negative_slope)))
    if xh.device.type == "cpu":
        return _v2_plain(
            xh_flat, a_cat_mat, banded.loc_t, el_t, el_self_t, l_spill_b,
            xh_spill_b, banded.spill_dst_local_b,
            band_rows=banded.band_rows, negative_slope=negative_slope,
            dmask_t=dmask_t, dmask_sp_b=dmask_sp_b)
    raise ValueError(f"unsupported device {xh.device}")


class _FusedV2(torch.autograd.Function):
    """Kernel D forward, kernel D' backward, as the JAX custom VJP
    ``_fused_v2``: the forward keeps the layer's inputs (and the dropout
    masks) and the attention dots kernel D computed ([N, 2 * heads] f32),
    the backward recomputes the softmax in D' from them and sums its d acat
    partials in a fixed order. D visits the spill entries by destination
    (spill_perm_d / spill_row_ptr_d); D' reads the in-band slots by source
    (band_perm / band_row_ptr) and the spill entries by destination: the
    BandedEll's own tables."""

    @staticmethod
    def forward(ctx, xh_flat, a_cat_mat, el_t, el_self_t, l_spill_b,
                xh_spill_b, loc_t, dst_loc_b, dmask_t, dmask_sp_b, band_perm,
                band_row_ptr, spill_perm_d, spill_row_ptr_d, opts):
        band_rows, slope = opts
        kw = kernel_args(xh_flat, a_cat_mat, loc_t, el_t, el_self_t,
                         l_spill_b, xh_spill_b, dst_loc_b, dmask_t,
                         dmask_sp_b, band_rows=band_rows,
                         negative_slope=slope, spill_perm_d=spill_perm_d,
                         spill_row_ptr_d=spill_row_ptr_d)
        n, k = kw["n"], kw["k"]
        _check(tuple(band_perm.shape) == (n * k,)
               and tuple(band_row_ptr.shape) == (n + 1,)
               and band_perm.device == xh_flat.device
               and band_row_ptr.device == xh_flat.device,
               f"band tables {tuple(band_perm.shape)} / "
               f"{tuple(band_row_ptr.shape)} vs N={n}, K={k}")
        # the attention dots kernel D computes, kept for kernel D'
        ac = torch.empty(n, 2 * kw["heads"], device=xh_flat.device,
                         dtype=torch.float32)
        out = call_v2_kernel(**kw, ac=ac)
        ctx.save_for_backward(
            kw["xh"], kw["acat"], kw["loc"], kw["el"], kw["el_self"],
            kw["l_spill"], kw["xh_spill"], kw["dst_loc"], kw["dmask"],
            kw["dmask_sp"], band_perm.to(torch.int32).contiguous(),
            band_row_ptr.to(torch.int32).contiguous(), kw["sp_perm"],
            kw["sp_row_ptr"], ac)
        ctx.kw = {name: kw[name] for name in (
            "n", "k", "heads", "c", "r", "s_max", "negative_slope", "dtype")}
        ctx.has_self = el_self_t is not None
        ctx.spill_dtype = xh_spill_b.dtype
        return out

    @staticmethod
    def backward(ctx, g):
        (xh, acat, loc, el, el_self, l_spill, xh_spill, dst_loc, dmask,
         dmask_sp, perm, row_ptr, sp_perm, sp_row_ptr, ac) = ctx.saved_tensors
        dxh, dacat, del_t, del_self, dl_spill, dxh_spill = call_v2_bwd_kernel(
            xh=xh, acat=acat, loc=loc, el=el, el_self=el_self,
            l_spill=l_spill, xh_spill=xh_spill, dst_loc=dst_loc,
            dmask=dmask, dmask_sp=dmask_sp, dout=g.to(xh.dtype).contiguous(),
            perm=perm, row_ptr=row_ptr, sp_perm=sp_perm,
            sp_row_ptr=sp_row_ptr, ac=ac, **ctx.kw)
        return (dxh, dacat, del_t, del_self if ctx.has_self else None,
                dl_spill, dxh_spill.to(ctx.spill_dtype), None, None, None,
                None, None, None, None, None, None)


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"banded ell_gat kernel: {msg}")


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def kernel_args(xh_flat, a_cat_mat, loc_t, el_t, el_self_t=None,
                l_spill_b=None, xh_spill_b=None, dst_loc_b=None,
                dmask_t=None, dmask_sp_b=None, *, band_rows: int,
                negative_slope: float = 0.2, spill_perm_d=None,
                spill_row_ptr_d=None) -> dict:
    """Check a CUDA call and prepare the inputs of kernel E (without the
    spill arguments) or kernels D and D' (with them): contiguous tensors
    (xh, a_cat_mat and the spill rows in xh's dtype, float32 or bfloat16;
    the other floats f32; indices int32) and the sizes. Kernel D also
    takes the spill entries by destination (``spill_perm_d`` /
    ``spill_row_ptr_d``, the BandedEll's; they become ``sp_perm`` /
    ``sp_row_ptr``). Raises ValueError on anything the kernels do not
    take."""
    f32 = torch.float32
    _check(xh_flat.dim() == 2, f"xh must be [N, HC], got "
           f"{tuple(xh_flat.shape)}")
    n, hc = xh_flat.shape
    _check(xh_flat.dtype in _DTYPE_CODE, f"xh dtype {xh_flat.dtype}: the "
           "kernels take float32 or bfloat16")
    cd = xh_flat.dtype
    _check(a_cat_mat.dim() == 2 and a_cat_mat.shape[0] == hc
           and a_cat_mat.shape[1] % 2 == 0,
           f"a_cat_mat {tuple(a_cat_mat.shape)} vs HC={hc}")
    heads = a_cat_mat.shape[1] // 2
    _check(1 <= heads <= _MAX_HEADS and hc % heads == 0,
           f"heads={heads} not in 1..{_MAX_HEADS} or not dividing HC={hc}")
    r = int(band_rows)
    _check(r >= 1 and n >= 1 and n % r == 0,
           f"N={n} not a multiple of band_rows={r}")
    _check(loc_t.dim() == 2 and loc_t.shape[1] == n,
           f"loc_t {tuple(loc_t.shape)} vs N={n}")
    k = loc_t.shape[0]
    _check(1 <= k <= _MAX_K, f"K={k} not in 1..{_MAX_K}")
    _check(tuple(el_t.shape) == (k * heads, n),
           f"el_t {tuple(el_t.shape)} != {(k * heads, n)}")
    if el_self_t is not None:
        _check(tuple(el_self_t.shape) == (heads, n),
               f"el_self_t {tuple(el_self_t.shape)} != {(heads, n)}")
    _check(n * max(hc, k * heads) < 2 ** 62, "graph too large")
    tensors = [t for t in (xh_flat, a_cat_mat, loc_t, el_t, el_self_t,
                           l_spill_b, xh_spill_b, dst_loc_b, dmask_t,
                           dmask_sp_b) if t is not None]
    _check(all(t.device == xh_flat.device for t in tensors),
           "all inputs must be on the device of xh")
    _check(all(t.dtype == f32 for t in (a_cat_mat, el_t, el_self_t,
                                        l_spill_b, dmask_t, dmask_sp_b)
               if t is not None), "a_cat_mat, el_t, el_self_t, l_spill_b "
           "and the dropout masks must be float32")
    _check(xh_spill_b is None or xh_spill_b.dtype == cd,
           "xh_spill_b must have xh's dtype")

    def cf(t):
        return None if t is None else t.to(f32).contiguous()

    kw = dict(xh=xh_flat.contiguous(), acat=a_cat_mat.to(cd).contiguous(),
              loc=loc_t.to(torch.int32).contiguous(), el=cf(el_t),
              el_self=cf(el_self_t), n=n, k=k, heads=heads, c=hc // heads,
              r=r, negative_slope=float(negative_slope),
              dtype=_DTYPE_CODE[cd])
    vec_ts = [kw["xh"]]
    if l_spill_b is not None:
        t_count = n // r
        _check(l_spill_b.dim() == 3 and l_spill_b.shape[:2] == (t_count,
                                                                 heads),
               f"l_spill_b {tuple(l_spill_b.shape)} vs T={t_count}, "
               f"heads={heads}")
        s_max = l_spill_b.shape[2]
        _check(s_max >= 1 and tuple(xh_spill_b.shape) == (t_count, s_max, hc)
               and dst_loc_b.numel() == t_count * s_max,
               f"xh_spill_b {tuple(xh_spill_b.shape)} / dst_loc_b "
               f"{tuple(dst_loc_b.shape)} vs {(t_count, s_max, hc)}")
        _check((dmask_t is None) == (dmask_sp_b is None),
               "dmask_t and dmask_sp_b go together")
        if dmask_t is not None:
            _check(tuple(dmask_t.shape) == ((k + 1) * heads, n)
                   and tuple(dmask_sp_b.shape) == (t_count, heads, s_max),
                   f"dropout masks {tuple(dmask_t.shape)} / "
                   f"{tuple(dmask_sp_b.shape)}")
        kw.update(l_spill=cf(l_spill_b), xh_spill=xh_spill_b.contiguous(),
                  dst_loc=dst_loc_b.to(torch.int32).reshape(
                      t_count, s_max).contiguous(),
                  dmask=cf(dmask_t), dmask_sp=cf(dmask_sp_b), s_max=s_max)
        vec_ts.append(kw["xh_spill"])
    if spill_perm_d is not None or spill_row_ptr_d is not None:
        _check(l_spill_b is not None and spill_perm_d is not None
               and spill_row_ptr_d is not None,
               "the spill tables go with the spill arguments, perm and "
               "row_ptr together")
        _check(spill_perm_d.dim() == 1
               and tuple(spill_row_ptr_d.shape) == (n + 1,)
               and spill_perm_d.device == xh_flat.device
               and spill_row_ptr_d.device == xh_flat.device,
               f"spill tables {tuple(spill_perm_d.shape)} / "
               f"{tuple(spill_row_ptr_d.shape)} vs N={n}")
        kw.update(sp_perm=spill_perm_d.to(torch.int32).contiguous(),
                  sp_row_ptr=spill_row_ptr_d.to(torch.int32).contiguous())
    kw["vec"] = 4 if kw["c"] % 4 == 0 and all(
        _aligned(t) for t in vec_ts) else 1
    return kw


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _raise(lib, prefix: str, name: str, err: int):
    msg = getattr(lib, f"{prefix}_error_string")(err).decode()
    raise RuntimeError(f"{name} failed to launch: CUDA error {err} ({msg})")


def call_band_kernel(*, xh, acat, loc, el, el_self, n, k, heads, c, r,
                     negative_slope, vec, dtype):
    """Launch kernel E (its dots and band kernels) on prepared inputs
    (``kernel_args`` without spill arguments) on the current stream;
    returns (y [N, HC], m [N, heads], denom [N, heads]) f32. The only
    place that counts ``band_launches``."""
    global band_launches
    from ._build import library

    f32 = dict(device=xh.device, dtype=torch.float32)
    ac = torch.empty(n, 2 * heads, **f32)
    y = torch.empty(n, heads * c, **f32)
    m = torch.empty(n, heads, **f32)
    den = torch.empty(n, heads, **f32)
    lib = library("ell_gat_band")
    with torch.cuda.device(xh.device):
        err = lib.ell_gat_band(
            dtype, xh.data_ptr(), acat.data_ptr(), loc.data_ptr(),
            el.data_ptr(), _ptr(el_self), ac.data_ptr(), y.data_ptr(),
            m.data_ptr(), den.data_ptr(), n, k, heads, c, r, negative_slope,
            vec,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        _raise(lib, "ell_gat_band", "kernel E (ell_gat_band)", err)
    band_launches += 1
    return y, m, den


def _check_ac(ac, n, heads, device):
    _check(ac.dtype == torch.float32 and tuple(ac.shape) == (n, 2 * heads)
           and ac.is_contiguous() and ac.device == device,
           f"attention dots {tuple(ac.shape)} {ac.dtype}: want a contiguous "
           f"float32 [{n}, {2 * heads}] on {device}")


def call_v2_kernel(*, xh, acat, loc, el, el_self, l_spill, xh_spill,
                   dst_loc, dmask, dmask_sp, sp_perm, sp_row_ptr, n, k,
                   heads, c, r, s_max, negative_slope, vec, dtype, ac=None):
    """Launch kernel D (its dots and row kernels) on prepared inputs
    (``kernel_args`` with the spill tables) on the current stream; returns
    out [N, HC] in xh's dtype. ``ac`` (f32 [N, 2 * heads]), when given,
    receives the attention dots, which kernel D' can take
    (``call_v2_bwd_kernel(ac=...)``). The only place that counts
    ``v2_launches``."""
    global v2_launches
    from ._build import library

    if ac is None:
        ac = torch.empty(n, 2 * heads, device=xh.device, dtype=torch.float32)
    _check_ac(ac, n, heads, xh.device)
    out = torch.empty(n, heads * c, device=xh.device, dtype=xh.dtype)
    lib = library("ell_gat_v2_fwd")
    with torch.cuda.device(xh.device):
        err = lib.ell_gat_v2_fwd(
            dtype, xh.data_ptr(), acat.data_ptr(), loc.data_ptr(),
            el.data_ptr(), _ptr(el_self), l_spill.data_ptr(),
            xh_spill.data_ptr(), dst_loc.data_ptr(), sp_perm.data_ptr(),
            sp_row_ptr.data_ptr(), _ptr(dmask), _ptr(dmask_sp),
            ac.data_ptr(), out.data_ptr(), n, k, heads, c, r, s_max,
            negative_slope, vec, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        _raise(lib, "ell_gat_v2_fwd", "kernel D (ell_gat_v2_fwd)", err)
    v2_launches += 1
    return out


def call_v2_bwd_kernel(*, xh, acat, loc, el, el_self, l_spill, xh_spill,
                       dst_loc, dmask, dmask_sp, dout, perm, row_ptr,
                       sp_perm, sp_row_ptr, n, k, heads, c, r, s_max,
                       negative_slope, dtype, ac=None):
    """Launch kernel D' (dots, the destination pass with d acat folded in,
    the source walk) on the inputs kernel D was given (``kernel_args``),
    the cotangent ``dout`` [N, HC] in xh's dtype, the in-band slots'
    source-sorted tables (perm / row_ptr) and the spill entries'
    destination-sorted tables (sp_perm / sp_row_ptr: the BandedEll's
    ``spill_perm_d`` / ``spill_row_ptr_d``), int32. Returns (dxh [N, HC] in
    xh's dtype, d acat [HC, 2 * heads], d el_t [K * heads, N], d el_self_t
    [heads, N] or None, d l_spill [T, heads, S], d xh_spill [T, S, HC]),
    f32 but dxh; the kernel writes every entry of the spill cotangents
    (0 at dead entries). ``ac``: the attention dots kernel D wrote for the
    same xh and acat (``call_v2_kernel(ac=...)``), or None: D' computes
    them itself (the same bits). The only place that counts
    ``v2_bwd_launches``."""
    global v2_bwd_launches
    from ._build import library

    hc = heads * c
    _check(tuple(dout.shape) == (n, hc) and dout.dtype == xh.dtype
           and dout.is_contiguous(), f"cotangent {tuple(dout.shape)} "
           f"{dout.dtype}")
    _check(tuple(sp_row_ptr.shape) == (n + 1,)
           and sp_perm.dtype == sp_row_ptr.dtype == torch.int32,
           "spill tables: int32 perm and row_ptr [N + 1]")
    t_count = n // r
    xh, xh_spill, dout = (t if _aligned(t) else t.clone()
                          for t in (xh, xh_spill, dout))
    vec = 4 if c % 4 == 0 else 1
    lib = library("ell_gat_v2_bwd")
    with torch.cuda.device(xh.device):
        blocks = lib.ell_gat_v2_bwd_blocks(dtype, n, k, heads, c, vec)
    _check(blocks >= 1, f"K={k} x heads={heads}, HC={hc}: the slot tables "
           "and the d acat accumulator of one warp exceed the card's shared "
           "memory")
    f32 = dict(device=xh.device, dtype=torch.float32)
    ac_given = ac is not None
    if ac_given:
        _check_ac(ac, n, heads, xh.device)
    else:
        ac = torch.empty(n, 2 * heads, **f32)
    alpha = torch.empty(n * k, heads, **f32)
    dl = torch.empty(n * k, heads, **f32)
    cself = torch.empty(n, heads, **f32)
    dac = torch.empty(n, 2 * heads, **f32)
    dxh = torch.empty(n, hc, device=xh.device, dtype=xh.dtype)
    del_t = torch.empty(k * heads, n, **f32)
    del_self = torch.empty(heads, n, **f32) if el_self is not None else None
    # every entry is written by the kernel (0 at dead entries)
    dl_spill = torch.empty(t_count, heads, s_max, **f32)
    dxh_spill = torch.empty(t_count, s_max, hc, **f32)
    part = torch.empty(blocks, hc, 2 * heads, **f32)
    with torch.cuda.device(xh.device):
        err = lib.ell_gat_v2_bwd(
            dtype, xh.data_ptr(), acat.data_ptr(), loc.data_ptr(),
            el.data_ptr(), _ptr(el_self), l_spill.data_ptr(),
            xh_spill.data_ptr(), dst_loc.data_ptr(), sp_perm.data_ptr(),
            sp_row_ptr.data_ptr(), _ptr(dmask), _ptr(dmask_sp),
            dout.data_ptr(), perm.data_ptr(), row_ptr.data_ptr(),
            ac.data_ptr(), alpha.data_ptr(), dl.data_ptr(),
            cself.data_ptr(), dac.data_ptr(), dxh.data_ptr(),
            del_t.data_ptr(), _ptr(del_self), dl_spill.data_ptr(),
            dxh_spill.data_ptr(), part.data_ptr(), n, k, heads, c, r, s_max,
            negative_slope, vec, blocks, int(ac_given),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        _raise(lib, "ell_gat_v2_bwd", "kernel D' (ell_gat_v2_bwd)", err)
    v2_bwd_launches += 1
    return dxh, part.sum(0), del_t, del_self, dl_spill, dxh_spill


def mat_dots(xh: torch.Tensor, acat: torch.Tensor,
             generic: bool = False) -> torch.Tensor:
    """The attention dots [N, M] f32 that kernels D, D' and E compute, of
    xh [N, HC] and acat [HC, M] (``kernel_args``' ``xh`` and ``acat``, M <=
    16). ``generic`` runs the generic form (``rows::mat_dots_kernel``)
    instead of the register form: a debug entry for holding the two
    against each other bit for bit and for timing the dots alone. CUDA
    only; not on any model path."""
    from ._build import library

    n, hc = xh.shape
    _check(xh.is_cuda and acat.dim() == 2 and acat.shape[0] == hc
           and acat.dtype == xh.dtype and xh.dtype in _DTYPE_CODE
           and xh.is_contiguous() and acat.is_contiguous()
           and 1 <= acat.shape[1] <= 16, f"xh {tuple(xh.shape)} / acat "
           f"{tuple(acat.shape)}")
    out = torch.empty(n, acat.shape[1], device=xh.device,
                      dtype=torch.float32)
    lib = library("ell_gat_v2_fwd")
    with torch.cuda.device(xh.device):
        err = lib.ell_gat_mat_dots(
            _DTYPE_CODE[xh.dtype], xh.data_ptr(), acat.data_ptr(),
            out.data_ptr(), n, hc, acat.shape[1], int(generic),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        _raise(lib, "ell_gat_v2_fwd", "ell_gat_mat_dots", err)
    return out
