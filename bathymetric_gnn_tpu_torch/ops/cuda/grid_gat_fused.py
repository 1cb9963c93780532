"""Fused grid-GAT layer: CUDA kernels A (forward) and B (backward) and
their plain versions.

Counterpart of ``bathymetric_gnn_tpu/ops/pallas/grid_gat_fused.py``: its
training entry ``fused_grid_gat`` (custom VJP over the Pallas ``_kernel``
and ``_bwd_kernel``) and its inference entry ``fused_grid_gat_infer``.
One 8- (or 4-) connected GAT layer on dense [B, H, W, F] tiles: x @ W and
the attention dots, per-offset logits + premasked edge logits, LeakyReLU,
softmax over the neighbours and the self loop, optional post-softmax
attention dropout, the weighted sum, + bias, an optional BatchNorm-affine
(+ ReLU) epilogue (inference), and the validity mask.

Which implementation runs follows only the device of ``x``: a CUDA tensor
launches the hand-written kernels (``csrc/grid_gat_fwd.cu``,
``csrc/grid_gat_bwd.cu``), a CPU tensor runs ``grid_gat_reference`` (and
autograd through it). There is no fallback between them: a CUDA input the
kernels do not take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..edges import offsets_for_connectivity

NEG = -1e30

# Launches of the CUDA kernels in this process: kernel A in its inference
# form, kernel A in its training form, and kernel B (one backward call
# launches its two kernels). Only the launch sites below add to them;
# callers reset them to 0 to count the launches of one run.
launches = 0
train_launches = 0
bwd_launches = 0

_KERNEL_HEADS = (1, 2, 4, 8)
_BWD_HEADS = (1, 2, 4, 8)
_MAX_EDGE_DIM = 4
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def gat_param_matrices(params: dict, heads: int, out_channels: int,
                       edge_dim: Optional[int]):
    """GridGATConv params -> the kernel's matrix forms: A_src/A_dst
    [HC, heads] block-diagonal per head, M_edge [ed, heads], bias [HC]."""
    w_lin = params["lin_src"]
    hc = heads * out_channels
    c = out_channels
    dev, dt = w_lin.device, w_lin.dtype
    eye = torch.eye(heads, device=dev, dtype=dt)
    # A[a*c + j, a] = att[a, j]
    a_src = (params["att_src"].reshape(heads, c, 1) * eye[:, None, :]
             ).reshape(hc, heads)
    a_dst = (params["att_dst"].reshape(heads, c, 1) * eye[:, None, :]
             ).reshape(hc, heads)
    if edge_dim is not None and "lin_edge" in params:
        we = params["lin_edge"].reshape(edge_dim, heads, c)
        m_edge = torch.einsum("fac,ac->fa", we,
                              params["att_edge"].reshape(heads, c))
    else:
        m_edge = torch.zeros(edge_dim or 3, heads, device=dev, dtype=dt)
    bias = params.get("bias")
    if bias is None:
        bias = torch.zeros(hc, device=dev, dtype=dt)
    return w_lin, a_src, a_dst, m_edge, bias


def edge_precompute(w_lin, a_src_mat, a_dst_mat, m_edge, eattr, nbr_mask,
                    use_edge: bool, compute_dtype=torch.float32):
    """Per-layer precompute (torch form of ``_edge_precompute``).

    Returns, in ``compute_dtype``:
      wa      [F, 2*heads]     W @ [a_src | a_dst]
      el      [B, K, heads, H, W]  edge logit terms, -1e30 where the
                                   neighbour is missing
      el_self [B, heads, H, W]     self-loop term (mean incoming attr)
    ``eattr`` is [B, K, H, W, ed], ``nbr_mask`` [B, K, H, W].
    """
    heads = a_src_mat.shape[1]
    nbm = nbr_mask > 0                                      # [B, K, H, W]
    if use_edge:
        ea = eattr.to(torch.float32)
        me = m_edge.to(torch.float32)
        el = _edge_terms(ea, me)                            # [B, K, h, H, W]
        el = torch.where(nbm[:, :, None], el, torch.full_like(el, NEG))
        el_self = _edge_terms(_mean_incoming(ea, nbm), me)  # [B, h, H, W]
    else:
        b, k, h, w = nbm.shape
        el = torch.where(nbm, 0.0, NEG)[:, :, None].expand(
            b, k, heads, h, w)
        el_self = torch.zeros(b, heads, h, w, device=nbm.device)
    wa = torch.cat([w_lin @ a_src_mat, w_lin @ a_dst_mat], dim=1)
    return (wa.to(compute_dtype), el.to(compute_dtype).contiguous(),
            el_self.to(compute_dtype).contiguous())


def _edge_terms(ea, me):
    """ea [..., H, W, ed] . me [ed, heads] -> [..., heads, H, W] as ed
    elementwise multiply-adds in a fixed order, so that a tile's terms do
    not depend on the batch it is served in (a matrix product picks its
    kernel, and with it the rounding, by the whole batch's shape)."""
    out = ea[..., 0].unsqueeze(-3) * me[0].reshape(-1, 1, 1)
    for f in range(1, ea.shape[-1]):
        out.addcmul_(ea[..., f].unsqueeze(-3), me[f].reshape(-1, 1, 1))
    return out


def _mean_incoming(ea, nbm):
    """The self loop's edge attribute: the mean over the valid incoming
    edges ([B, K, H, W, ed], [B, K, H, W] -> [B, H, W, ed]), summed slot by
    slot in order (elementwise, as ``_edge_terms``); the counts are whole
    numbers, exact in any order."""
    cnt = nbm.to(torch.float32).sum(1).clamp_min(1.0)[..., None]
    live = torch.where(nbm[..., None], ea, 0.0)
    total = live[:, 0] + live[:, 1] if ea.shape[1] > 1 else live[:, 0]
    for k in range(2, ea.shape[1]):
        total.add_(live[:, k])
    return total / cnt


def edge_attr_terms(eattr, nbr_mask, use_edge: bool,
                    compute_dtype=torch.float32):
    """The edge attributes kernel B contracts with d(logits) for dM_edge:
    (eattr [B, K, H, W, ed], the self loop's mean incoming attribute
    [B, H, W, ed]), in ``compute_dtype``; zeros when ``use_edge`` is
    off (the layer then has no edge term)."""
    ea = eattr.to(torch.float32)
    if not use_edge:
        ea = torch.zeros_like(ea)
    return (ea.to(compute_dtype).contiguous(),
            _mean_incoming(ea, nbr_mask > 0).to(compute_dtype).contiguous())


def _shift2(a: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """a_shifted[b, r, c] = a[b, r + dr, c + dc] (wraps; masked later)."""
    return torch.roll(a, shifts=(-dr, -dc), dims=(1, 2))


def grid_gat_reference(x, w_lin, a_src_mat, a_dst_mat, m_edge, eattr,
                       nbr_mask, valid, bias, connectivity: int = 8,
                       negative_slope: float = 0.2, use_edge: bool = True, *,
                       dmask=None, bn_scale=None, bn_bias=None,
                       fuse_relu: bool = False,
                       compute_dtype=torch.float32):
    """Plain PyTorch version of kernel A (batched [B, H, W, F]), and, through
    autograd, of kernel B.

    ``_reference_forward`` (with its ``dmask`` [B, K+1, heads, H, W], self
    loop at slot K, multiplied into the post-softmax weights) plus the
    epilogue and mask as ``_fused_forward`` applies them. In bf16 it rounds
    where the kernel rounds: x, W, W@[a_src|a_dst], the edge logit terms
    and the output; everything else is f32. The attention dots are
    x @ (W @ a), the kernel's formulation, equal to (x @ W) @ a up to f32
    rounding.
    """
    offsets = offsets_for_connectivity(connectivity)
    heads = a_src_mat.shape[1]
    hc = w_lin.shape[1]
    c = hc // heads
    wa, el, el_self = edge_precompute(w_lin, a_src_mat, a_dst_mat, m_edge,
                                      eattr, nbr_mask, use_edge,
                                      compute_dtype)
    f32 = torch.float32
    x = x.to(compute_dtype).to(f32)
    w = w_lin.to(compute_dtype).to(f32)
    xh = x @ w                                              # [B, H, W, HC]
    ad = x @ wa.to(f32)                                     # [B, H, W, 2h]
    a_src, a_dst = ad[..., :heads], ad[..., heads:]
    el = el.to(f32).permute(0, 1, 3, 4, 2)                  # [B, K, H, W, h]
    el_self = el_self.to(f32).permute(0, 2, 3, 1)           # [B, H, W, h]
    nbm = (nbr_mask > 0)[..., None]                         # [B, K, H, W, 1]

    def leaky(v):
        return torch.where(v >= 0, v, negative_slope * v)

    logits = []
    for k, (dr, dc) in enumerate(offsets):
        lg = leaky(_shift2(a_src, dr, dc) + a_dst + el[:, k])
        logits.append(torch.where(nbm[:, k], lg, torch.full_like(lg, NEG)))
    self_lg = leaky(a_src + a_dst + el_self)

    m = self_lg
    for lg in logits:
        m = torch.maximum(m, lg)
    e_self = torch.exp(self_lg - m)
    denom = e_self
    exps = []
    for k, lg in enumerate(logits):
        e = torch.exp(lg - m) * nbm[:, k]
        exps.append(e)
        denom = denom + e
    denom = denom.clamp_min(1e-16)

    w_self = e_self / denom
    wts = [e / denom for e in exps]
    if dmask is not None:
        dm = dmask.to(f32).permute(0, 1, 3, 4, 2)           # [B, K+1, H, W, h]
        w_self = w_self * dm[:, len(offsets)]
        wts = [wk * dm[:, k] for k, wk in enumerate(wts)]

    def eh(wt):  # [B, H, W, heads] -> [B, H, W, HC]
        return torch.repeat_interleave(wt, c, dim=-1)

    acc = xh * eh(w_self)
    for k, (dr, dc) in enumerate(offsets):
        acc = acc + _shift2(xh, dr, dc) * eh(wts[k])
    acc = acc + bias.to(f32).reshape(1, 1, 1, hc)
    if bn_scale is not None:
        acc = acc * bn_scale.to(f32) + bn_bias.to(f32)
    if fuse_relu:
        acc = torch.relu(acc)
    acc = acc * (valid > 0)[..., None]
    return acc.to(compute_dtype)


def _batched(x, eattr, nbr_mask, valid, dmask=None):
    if x.dim() == 3:
        return (True, x[None], eattr[None], nbr_mask[None], valid[None],
                None if dmask is None else dmask[None])
    return False, x, eattr, nbr_mask, valid, dmask


def fused_grid_gat_infer(x, w_lin, a_src_mat, a_dst_mat, m_edge, eattr,
                         nbr_mask, valid, bias, connectivity: int = 8,
                         negative_slope: float = 0.2, use_edge: bool = True,
                         *, bn_scale=None, bn_bias=None,
                         fuse_relu: bool = False,
                         compute_dtype=torch.float32):
    """Inference GAT layer with an optional BatchNorm-affine (+ ReLU)
    epilogue; returns [.., H, W, HC] in ``compute_dtype``.

    Arguments and layouts are those of the JAX ``fused_grid_gat_infer``
    (x [H, W, F], eattr [K, H, W, ed], nbr_mask [K, H, W], valid [H, W]),
    each with an optional leading batch dimension. The JAX entry's
    ``dmask`` (always None there), ``block_rows`` and ``interpret`` have
    no meaning here and are not taken. ``compute_dtype=torch.bfloat16``
    streams x, W, W@a and the edge logits in bf16 and writes bf16; softmax
    and accumulation stay f32. A CUDA ``x`` launches kernel A, a CPU ``x``
    runs the plain version.

    It has no backward: with grad mode on and an input that requires grad
    it raises (``fused_grid_gat`` is the differentiable layer).
    """
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, w_lin, a_src_mat, a_dst_mat, m_edge, bias,
                      bn_scale, bn_bias)):
        raise RuntimeError(
            "fused_grid_gat_infer has no backward: call it under "
            "torch.no_grad(), or use fused_grid_gat to train")
    unbatched, x, eattr, nbr_mask, valid, _ = _batched(x, eattr, nbr_mask,
                                                       valid)
    args = (x, w_lin, a_src_mat, a_dst_mat, m_edge, eattr, nbr_mask, valid,
            bias, connectivity, negative_slope, use_edge)
    kw = dict(bn_scale=bn_scale, bn_bias=bn_bias, fuse_relu=fuse_relu,
              compute_dtype=compute_dtype)
    if x.device.type == "cuda":
        out = call_kernel(**kernel_args(*args, **kw))
    elif x.device.type == "cpu":
        out = grid_gat_reference(*args, **kw)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return out[0] if unbatched else out


def fused_grid_gat(x, w_lin, a_src_mat, a_dst_mat, m_edge, eattr, nbr_mask,
                   valid, bias, connectivity: int = 8,
                   negative_slope: float = 0.2, use_edge: bool = True, *,
                   dmask=None, drop_seed=None, keep_prob: float = 1.0,
                   compute_dtype=torch.float32):
    """Training GAT layer (differentiable in x, w_lin, a_src_mat,
    a_dst_mat, m_edge and bias); returns [.., H, W, HC] in
    ``compute_dtype``, pre-BatchNorm.

    The JAX ``fused_grid_gat``'s arguments, layouts and semantics, with a
    batch dimension. Attention dropout comes from one of
    - ``dmask`` [.., K+1, heads, H, W]: multipliers of the post-softmax
      weights (self loop at slot K), streamed into both kernels;
    - ``drop_seed``: an int64 tensor of one element on the card; kernel A
      draws keep(p = ``keep_prob``)/keep_prob multipliers with Philox
      from it and kernel B regenerates them (CUDA only: on the CPU pass a
      ``dmask``).

    CUDA: kernel A forward and kernel B backward (``_FusedGridGAT``),
    keeping only the layer inputs and the edge precompute between them.
    CPU: the plain version, differentiated by autograd. bf16 treats its
    roundings as identity in the backward, as the JAX kernel does.
    """
    if dmask is not None and drop_seed is not None:
        raise ValueError("dmask and drop_seed are mutually exclusive")
    unbatched, x, eattr, nbr_mask, valid, dmask = _batched(
        x, eattr, nbr_mask, valid, dmask)
    if x.device.type == "cuda":
        out = _FusedGridGAT.apply(
            x, w_lin, a_src_mat, a_dst_mat, m_edge, bias, eattr, nbr_mask,
            valid, dmask, drop_seed,
            (connectivity, negative_slope, use_edge, keep_prob,
             compute_dtype))
    elif x.device.type == "cpu":
        if drop_seed is not None:
            raise ValueError("the in-kernel dropout draw runs only on the "
                             "card; pass a dmask on the CPU")
        out = grid_gat_reference(x, w_lin, a_src_mat, a_dst_mat, m_edge,
                                 eattr, nbr_mask, valid, bias, connectivity,
                                 negative_slope, use_edge, dmask=dmask,
                                 compute_dtype=compute_dtype)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return out[0] if unbatched else out


class _FusedGridGAT(torch.autograd.Function):
    """Kernel A (training form) forward, kernel B backward, as the JAX
    custom VJP's ``_fwd``/``_bwd``: the forward keeps the layer inputs,
    the edge precompute and the dropout mask or seed; the backward sums
    kernel B's per-block partials and forms dW_lin = dW + d(W@a) a_cat^T
    and d a_cat = W^T d(W@a) (JAX ``_fused_backward``)."""

    @staticmethod
    def forward(ctx, x, w_lin, a_src_mat, a_dst_mat, m_edge, bias, eattr,
                nbr_mask, valid, dmask, drop_seed, opts):
        connectivity, slope, use_edge, keep_prob, dt = opts
        kw = kernel_args(x, w_lin, a_src_mat, a_dst_mat, m_edge, eattr,
                         nbr_mask, valid, bias, connectivity, slope,
                         use_edge, bn_scale=None, bn_bias=None,
                         fuse_relu=False, compute_dtype=dt, dmask=dmask,
                         drop_seed=drop_seed, keep_prob=keep_prob,
                         train=True)
        out = call_kernel(**kw)
        ea, mattr = edge_attr_terms(eattr, nbr_mask, use_edge, dt)
        ctx.save_for_backward(kw["x"], kw["w"], kw["wa"], kw["el"],
                              kw["el_self"], kw["valid"], ea, mattr,
                              kw["dmask"], kw["seed"], w_lin, a_src_mat,
                              a_dst_mat)
        ctx.kw = {k: kw[k] for k in ("heads", "connectivity",
                                     "negative_slope", "drop_mode",
                                     "thresh", "keep_inv")}
        ctx.dtypes = (x.dtype, w_lin.dtype, m_edge.dtype, bias.dtype)
        return out

    @staticmethod
    def backward(ctx, g):
        (xk, wk, wa, el, el_self, valid, ea, mattr, dmask, seed, w_lin,
         a_src_mat, a_dst_mat) = ctx.saved_tensors
        x_dt, w_dt, me_dt, b_dt = ctx.dtypes
        dx, dw_part, dme_part, db_part = call_bwd_kernel(
            x=xk, w=wk, wa=wa, el=el, el_self=el_self, valid=valid,
            g=g.to(xk.dtype).contiguous(), eattr=ea, mattr=mattr,
            dmask=dmask, seed=seed, **ctx.kw)
        dx, dw_lin, d_src, d_dst, dme, db = bwd_gradients(
            dx, dw_part, dme_part, db_part, w_lin, a_src_mat, a_dst_mat)
        return (dx.to(x_dt), dw_lin.to(w_dt), d_src.to(a_src_mat.dtype),
                d_dst.to(a_dst_mat.dtype), dme.to(me_dt), db.to(b_dt),
                None, None, None, None, None, None)


def bwd_gradients(dx, dw_part, dme_part, db_part, w_lin, a_src_mat,
                  a_dst_mat):
    """Kernel B's outputs (``call_bwd_kernel``) -> the layer's gradients
    (dx, dW_lin, d a_src, d a_dst, dM_edge, dbias): the per-block partials
    summed, dW_lin = dW + d(W@a) a_cat^T and d a_cat = W^T d(W@a) (JAX
    ``_fused_backward``), in f32 (dx in kernel B's dtype)."""
    hc = w_lin.shape[1]
    heads = a_src_mat.shape[1]
    dw = dw_part[..., :hc].sum(0)
    dwa = dw_part[..., hc:].sum(0)                          # [F, 2h]
    a_cat = torch.cat([a_src_mat, a_dst_mat], dim=1).to(torch.float32)
    dw_lin = dw + dwa @ a_cat.T
    d_a = w_lin.to(torch.float32).T @ dwa                   # [HC, 2h]
    return (dx, dw_lin, d_a[:, :heads], d_a[:, heads:], dme_part.sum(0),
            db_part.sum(0))


def drop_threshold(keep_prob: float):
    """(threshold, 1 / keep) of the in-kernel draw: a weight is dropped
    where the Philox word is < round((1 - keep) * 2^32)."""
    if not 0.0 < keep_prob <= 1.0:
        raise ValueError(f"keep_prob {keep_prob} not in (0, 1]")
    thresh = min(2 ** 32 - 1, int(round((1.0 - keep_prob) * 2 ** 32)))
    return thresh, 1.0 / keep_prob


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"grid_gat kernel: {msg}")


def kernel_args(x, w_lin, a_src_mat, a_dst_mat, m_edge, eattr, nbr_mask,
                valid, bias, connectivity, negative_slope, use_edge, *,
                bn_scale, bn_bias, fuse_relu, compute_dtype, dmask=None,
                drop_seed=None, keep_prob: float = 1.0,
                train: bool = False) -> dict:
    """Check a batched CUDA call and prepare kernel A's own inputs (the
    edge precompute, casts, contiguous copies, the dropout arguments).
    ``train`` marks the training form (it counts in ``train_launches``).
    Raises ValueError on anything the kernel does not take."""
    dt = compute_dtype
    _check(dt in _DTYPE_CODE, f"compute_dtype {dt} (float32 or bfloat16)")
    b, h, w, f_in = x.shape
    heads = a_src_mat.shape[1]
    hc = w_lin.shape[1]
    k = len(offsets_for_connectivity(connectivity))
    _check(heads in _KERNEL_HEADS, f"heads={heads} not in {_KERNEL_HEADS}")
    _check(hc % heads == 0, f"HC={hc} not a multiple of heads={heads}")
    _check(w_lin.shape[0] == f_in, f"W {tuple(w_lin.shape)} vs F={f_in}")
    _check(min(b, h, w, f_in) >= 1, f"empty input {tuple(x.shape)}")
    _check(tuple(nbr_mask.shape) == (b, k, h, w),
           f"nbr_mask {tuple(nbr_mask.shape)} != {(b, k, h, w)}")
    _check(tuple(valid.shape) == (b, h, w),
           f"valid {tuple(valid.shape)} != {(b, h, w)}")
    _check(b * h * w < 2 ** 31 and b * h * w * max(hc, f_in) < 2 ** 40,
           "input too large for the kernel's index arithmetic")
    dev = x.device
    tensors = [x, w_lin, a_src_mat, a_dst_mat, m_edge, eattr, nbr_mask,
               valid, bias] + [t for t in (bn_scale, bn_bias, dmask,
                                           drop_seed) if t is not None]
    _check(all(t.device == dev for t in tensors),
           "all inputs must be on the device of x")
    drop_mode, thresh, keep_inv = 0, 0, 1.0
    if dmask is not None:
        _check(drop_seed is None, "dmask and drop_seed together")
        _check(tuple(dmask.shape) == (b, k + 1, heads, h, w),
               f"dmask {tuple(dmask.shape)} != {(b, k + 1, heads, h, w)}")
        dmask = dmask.to(torch.float32).contiguous()
        drop_mode = 1
    elif drop_seed is not None:
        _check(drop_seed.dtype == torch.int64 and drop_seed.numel() == 1,
               "drop_seed must be one int64 element")
        drop_seed = drop_seed.contiguous()
        drop_mode = 2
        thresh, keep_inv = drop_threshold(keep_prob)

    wa, el, el_self = edge_precompute(w_lin, a_src_mat, a_dst_mat, m_edge,
                                      eattr, nbr_mask, use_edge, dt)
    f32 = dict(device=dev, dtype=torch.float32)
    fuse_bn = bn_scale is not None
    kw = dict(
        x=x.to(dt).contiguous(), w=w_lin.to(dt).contiguous(),
        wa=wa.contiguous(), el=el, el_self=el_self,
        valid=(valid > 0).to(torch.float32).contiguous(),
        bias=bias.to(torch.float32).reshape(hc).contiguous(),
        bn_scale=(bn_scale.to(torch.float32).reshape(hc).contiguous()
                  if fuse_bn else torch.ones(hc, **f32)),
        bn_shift=(bn_bias.to(torch.float32).reshape(hc).contiguous()
                  if fuse_bn else torch.zeros(hc, **f32)),
        heads=heads, connectivity=connectivity,
        negative_slope=float(negative_slope), fuse_bn=fuse_bn,
        fuse_relu=bool(fuse_relu), drop_mode=drop_mode, dmask=dmask,
        seed=drop_seed, thresh=thresh, keep_inv=keep_inv, train=train)
    for name in ("x", "w", "wa", "el", "el_self", "valid", "bias",
                 "bn_scale", "bn_shift"):
        t = kw[name]
        want = dt if name in ("x", "w", "wa", "el", "el_self") else (
            torch.float32)
        _check(t.dtype == want and t.is_contiguous(),
               f"{name}: {t.dtype}, contiguous={t.is_contiguous()}")
    return kw


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def call_kernel(*, x, w, wa, el, el_self, valid, bias, bn_scale, bn_shift,
                heads, connectivity, negative_slope, fuse_bn, fuse_relu,
                drop_mode=0, dmask=None, seed=None, thresh=0, keep_inv=1.0,
                train=False, empty=torch.empty):
    """Launch kernel A on prepared inputs (``kernel_args``) on the current
    stream; returns the output [B, H, W, HC], allocated by ``empty``
    (``torch.empty``; the guard checks pass a ``guard.GuardPool``'s). The
    only place that counts ``launches`` (inference form) and
    ``train_launches`` (training form)."""
    global launches, train_launches
    from ._build import library

    b, h, wd, f_in = x.shape
    hc = w.shape[1]
    out = empty(b, h, wd, hc, device=x.device, dtype=x.dtype)
    lib = library("grid_gat_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.grid_gat_fwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), wa.data_ptr(),
            el.data_ptr(), el_self.data_ptr(), valid.data_ptr(),
            bias.data_ptr(), bn_scale.data_ptr(), bn_shift.data_ptr(),
            out.data_ptr(), b, h, wd, f_in, hc, heads, connectivity,
            negative_slope, int(fuse_bn), int(fuse_relu), drop_mode,
            _ptr(dmask), _ptr(seed), thresh, keep_inv, stream)
    if err != 0:
        msg = lib.grid_gat_cuda_error_string(err).decode()
        raise RuntimeError(f"grid_gat_fwd kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    if train:
        train_launches += 1
    else:
        launches += 1
    return out


def _splits(ncell: int):
    """(nsplit, cells per split) of kernel B's weight-grad partials: at
    most 128 partials (enough blocks to fill the card with the products
    kernel's 256 x 128 weight-grad tiles), each over a run of >= 1024 cells
    (a multiple of its depth step, 32 bf16 or 16 f32 cells)."""
    target = max(1, min(128, ncell // 1024))
    cps = -(-ncell // target)
    cps = -(-cps // 32) * 32
    return -(-ncell // cps), cps


def call_bwd_kernel(*, x, w, wa, el, el_self, valid, g, eattr, mattr, heads,
                    connectivity, negative_slope, drop_mode=0, dmask=None,
                    seed=None, thresh=0, keep_inv=1.0, empty=torch.empty):
    """Launch kernel B (its attention and products kernels) on the inputs
    kernel A was given (``kernel_args``), the cotangent ``g`` [B, H, W, HC]
    and the edge attribute terms (``edge_attr_terms``). Returns (dx
    [B, H, W, F], dW|d(W@a) partials [nsplit, F, HC + 2h], dM_edge
    partials [nblk, ed, heads], dbias partials [nblk, HC]), the partials
    f32; they and the scratch between the two kernels (dxh, d_ad) are
    allocated by ``empty``, as in ``call_kernel``. The only place that
    counts ``bwd_launches``."""
    global bwd_launches
    from ._build import library

    b, h, wd, f_in = x.shape
    hc = w.shape[1]
    ed = eattr.shape[-1]
    _check(heads in _BWD_HEADS, f"backward: heads={heads} not in "
           f"{_BWD_HEADS}")
    _check(ed <= _MAX_EDGE_DIM, f"edge_dim {ed} > {_MAX_EDGE_DIM}")
    _check(tuple(g.shape) == (b, h, wd, hc) and g.dtype == x.dtype
           and g.is_contiguous(), f"cotangent {tuple(g.shape)} {g.dtype}")
    dev, dt = x.device, x.dtype
    lib = library("grid_gat_bwd")
    nblk = lib.grid_gat_bwd_blocks(heads, b, h, wd)
    nsplit, cps = _splits(b * h * wd)
    dxh = empty(b, h, wd, hc, device=dev, dtype=dt)
    dad = empty(b, h, wd, 2 * heads, device=dev, dtype=dt)
    dme_part = empty(nblk, ed, heads, device=dev, dtype=torch.float32)
    db_part = empty(nblk, hc, device=dev, dtype=torch.float32)
    dx = empty(b, h, wd, f_in, device=dev, dtype=dt)
    dw_part = empty(nsplit, f_in, hc + 2 * heads, device=dev,
                    dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.grid_gat_bwd(
            _DTYPE_CODE[dt], x.data_ptr(), w.data_ptr(), wa.data_ptr(),
            el.data_ptr(), el_self.data_ptr(), valid.data_ptr(),
            g.data_ptr(), eattr.data_ptr(), mattr.data_ptr(),
            dxh.data_ptr(), dad.data_ptr(), dme_part.data_ptr(),
            db_part.data_ptr(), dx.data_ptr(), dw_part.data_ptr(), b, h, wd,
            f_in, hc, heads, connectivity, ed, negative_slope, drop_mode,
            _ptr(dmask), _ptr(seed), thresh, keep_inv, nsplit, cps, stream)
    if err != 0:
        msg = lib.grid_gat_bwd_error_string(err).decode()
        raise RuntimeError(f"grid_gat_bwd kernels failed to launch: CUDA "
                           f"error {err} ({msg})")
    bwd_launches += 1
    return dx, dw_part, dme_part, db_part


def drop_mask(drop_seed: torch.Tensor, keep_prob: float, batch: int,
              connectivity: int, heads: int, height: int,
              width: int) -> torch.Tensor:
    """The in-kernel dropout draw of ``drop_seed`` written out as the f32
    mask [B, K+1, heads, H, W] that kernels A and B apply: a debug entry
    for holding the draw against the streamed-mask path. CUDA only; not on
    any model path."""
    from ._build import library

    _check(drop_seed.is_cuda and drop_seed.dtype == torch.int64
           and drop_seed.numel() == 1, "drop_seed: one int64 on the card")
    k = len(offsets_for_connectivity(connectivity))
    thresh, keep_inv = drop_threshold(keep_prob)
    out = torch.empty(batch, k + 1, heads, height, width,
                      device=drop_seed.device, dtype=torch.float32)
    lib = library("grid_gat_fwd")
    with torch.cuda.device(drop_seed.device):
        err = lib.grid_gat_drop_mask(
            out.data_ptr(), drop_seed.data_ptr(), thresh, keep_inv, batch,
            connectivity, heads, height, width,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"grid_gat_drop_mask failed: CUDA error {err}")
    return out
