"""GAT layer on an ELL graph: CUDA kernels C (forward) and C' (backward)
and their plain versions.

Counterpart of ``bathymetric_gnn_tpu/ops/pallas/ell_gat_fused.py``'s
``ell_gat_fused_wide_pallas`` (the Pallas ``_kernel_v3`` and, through its
custom VJP ``_fused_v3``, ``_bwd_kernel_v3``), f32 and bf16. One PyG-exact GAT
layer on a destination-major ELL graph: the attention dots of xh, the
per-slot logits a_src[nbr] + a_dst + el and the self-loop logit, LeakyReLU,
the masked softmax over the live slots and the self loop, optional
post-softmax attention dropout, the weighted gather-sum, + bias and the
node mask. The TPU kernel's band/spill layout exists because a TPU has no
fast gather; the CUDA kernels read ``nbr_src`` directly, so they take the
graph as ``ops/ell.coo_to_ell`` packs it.

The dtype of ``xh`` picks the form (the JAX ``compute_dtype``): float32,
or bfloat16, where xh and the attention vectors are read as bf16 (the JAX
wrapper's ``a_cat_mat.astype(cd)``) and the output is bf16, while the
logits, softmax and sums run in f32 and el, el_self, the dropout masks and
every gradient but d xh stay f32.

Two entries:
- ``ell_gat_fused``: the serving entry (kernel C, inference form), with no
  backward: it raises under grad mode with an input that requires grad;
- ``ell_gat_fused_train``: the differentiable layer (kernel C's dropout
  form forward, kernel C' backward, which ends in kernel F's mode (b),
  ``csrc/segment_reduce.cuh``), with the dropout multipliers streamed
  (``dmask``) or drawn in the kernels from a seed.

Which implementation runs follows only the device of ``xh``: a CUDA tensor
launches the hand-written kernels (``csrc/ell_gat_fwd.cu``,
``csrc/ell_gat_bwd.cu``), a CPU tensor runs ``ell_gat_reference`` (and
autograd through it). There is no fallback between them: a CUDA input the
kernels do not take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ell import ell_gather, ell_masked_softmax, src_sorted_slots
from . import segment_reduce
from .grid_gat_fused import _DTYPE_CODE, drop_threshold

# Launches in this process: kernel C in its inference form, kernel C in its
# training form, and kernel C' (whose call also launches kernel F, counted
# in ``segment_reduce.launches``). Only ``call_kernel`` and
# ``call_bwd_kernel`` add to them; callers reset them to 0 to count the
# launches of one run.
launches = 0
train_launches = 0
bwd_launches = 0

_MAX_HEADS = 8


def ell_gat_reference(xh, att_src, att_dst, nbr_src, nbr_mask, el=None,
                      el_self=None, *, self_loop: bool = True, bias=None,
                      node_mask=None, negative_slope: float = 0.2,
                      dmask=None):
    """Plain PyTorch version of kernel C (the JAX ``GATConvELL`` math on a
    given xh), with the signature of ``ell_gat_fused``; through autograd,
    the plain version of kernel C'.

    xh [N, HC]; att_src, att_dst [..., heads, C]; nbr_src [N, K] int;
    nbr_mask [N, K] bool; el [N, K, heads] edge-logit terms or None;
    el_self [N, heads] or None (zeros) for the self loop, which
    ``self_loop`` turns on; bias [HC] or None; node_mask [N] bool or None;
    dmask [N, K+1, heads] post-softmax dropout multipliers (the self loop
    at slot K; the denominator stays the undropped one) or None.
    Returns [N, HC] in xh's dtype. For a bf16 xh the attention vectors
    are rounded to bf16, everything is computed in f32 from the bf16
    values, the sum is rounded to bf16 and the bias (rounded to bf16) is
    added in bf16, as the JAX layer adds it to the kernel's bf16 output.
    """
    f32 = torch.float32
    cd = xh.dtype
    n, hc = xh.shape
    a_s = att_src.reshape(-1, att_src.shape[-1]).to(cd).to(f32)
    a_d = att_dst.reshape(-1, att_dst.shape[-1]).to(cd).to(f32)
    heads, c = a_s.shape
    x3 = xh.to(f32).reshape(n, heads, c)
    a_src = (x3 * a_s).sum(-1)                              # [N, heads]
    a_dst = (x3 * a_d).sum(-1)

    def leaky(v):
        return torch.where(v >= 0, v, negative_slope * v)

    mask = nbr_mask.to(torch.bool)
    logits = ell_gather(a_src, nbr_src) + a_dst[:, None, :]
    if el is not None:
        logits = logits + el.to(f32)
    logits = leaky(logits)
    self_lg = None
    if self_loop:
        s = a_src + a_dst
        if el_self is not None:
            s = s + el_self.to(f32)
        self_lg = leaky(s)
    wts, w_self = ell_masked_softmax(logits, mask, self_lg)
    if dmask is not None:
        k = nbr_src.shape[1]
        dm = dmask.to(f32)
        wts = wts * dm[:, :k]
        if w_self is not None:
            w_self = w_self * dm[:, k]
    nbr_x = ell_gather(x3, nbr_src)                          # [N, K, h, C]
    nbr_x = torch.where(mask[..., None, None], nbr_x, torch.zeros_like(nbr_x))
    out = (nbr_x * wts[..., None]).sum(1)
    if w_self is not None:
        out = out + x3 * w_self[..., None]
    out = out.reshape(n, hc).to(cd)
    if bias is not None:
        out = out + bias.to(cd)
    if node_mask is not None:
        out = torch.where(node_mask.to(torch.bool)[:, None], out,
                          torch.zeros_like(out))
    return out


def ell_gat_fused(xh, att_src, att_dst, nbr_src, nbr_mask, el=None,
                  el_self=None, *, self_loop: bool = True, bias=None,
                  node_mask=None, negative_slope: float = 0.2):
    """Inference GAT layer on an ELL graph (arguments as
    ``ell_gat_reference``); returns [N, HC] in xh's dtype (float32 or
    bfloat16). A CUDA ``xh`` launches kernel C, a CPU ``xh`` runs the plain
    version.

    It has no backward: with grad mode on and an input that requires grad
    it raises (``ell_gat_fused_train`` is the differentiable layer)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (xh, att_src, att_dst, el, el_self, bias)):
        raise RuntimeError(
            "ell_gat_fused is the no-grad serving entry and has no "
            "backward: call it under torch.no_grad(), or train with "
            "ell_gat_fused_train (kernels C and C')")
    args = (xh, att_src, att_dst, nbr_src, nbr_mask, el, el_self)
    kw = dict(self_loop=self_loop, bias=bias, node_mask=node_mask,
              negative_slope=negative_slope)
    if xh.device.type == "cuda":
        return call_kernel(**kernel_args(*args, **kw))
    if xh.device.type == "cpu":
        return ell_gat_reference(*args, **kw)
    raise ValueError(f"unsupported device {xh.device}")


def ell_gat_fused_train(xh, att_src, att_dst, nbr_src, nbr_mask, el=None,
                        el_self=None, *, self_loop: bool = True, bias=None,
                        node_mask=None, negative_slope: float = 0.2,
                        dmask=None, drop_seed=None, keep_prob: float = 1.0,
                        slot_tables=None):
    """Training GAT layer on an ELL graph (arguments as
    ``ell_gat_reference``), differentiable in xh, att_src, att_dst, el,
    el_self and bias; returns [N, HC] in xh's dtype (float32 or
    bfloat16).

    Attention dropout comes from one of
    - ``dmask`` [N, K+1, heads]: multipliers of the post-softmax weights
      (self loop at slot K), streamed into kernels C and C';
    - ``drop_seed``: an int64 tensor of one element on the card; kernel C
      draws keep(p = ``keep_prob``)/keep_prob multipliers with Philox from
      it and kernel C' regenerates them (CUDA only: on the CPU pass a
      ``dmask``).

    CUDA: kernel C (training form) forward and kernel C' backward
    (``_EllGATFused``), keeping only the layer's inputs between them; the
    cotangent streams into C' in xh's dtype and d xh comes back in it.
    ``slot_tables`` = (perm, row_ptr) of ``ops/ell.src_sorted_slots`` on
    the card, over which C' reduces the source side of the gradient; when
    None they are built on the host from ``nbr_src``/``nbr_mask``. CPU:
    the plain version, differentiated by autograd.
    """
    if dmask is not None and drop_seed is not None:
        raise ValueError("dmask and drop_seed are mutually exclusive")
    if xh.device.type == "cuda":
        if slot_tables is None:
            slot_tables = tuple(
                torch.from_numpy(t).to(xh.device) for t in src_sorted_slots(
                    nbr_src.cpu().numpy(), nbr_mask.cpu().numpy(),
                    None if node_mask is None else
                    node_mask.cpu().numpy()))
        return _EllGATFused.apply(
            xh, att_src, att_dst, el, el_self, bias, nbr_src, nbr_mask,
            node_mask, dmask, drop_seed, slot_tables[0], slot_tables[1],
            (bool(self_loop), float(negative_slope), float(keep_prob)))
    if xh.device.type == "cpu":
        if drop_seed is not None:
            raise ValueError("the in-kernel dropout draw runs only on the "
                             "card; pass a dmask on the CPU")
        return ell_gat_reference(
            xh, att_src, att_dst, nbr_src, nbr_mask, el, el_self,
            self_loop=self_loop, bias=bias, node_mask=node_mask,
            negative_slope=negative_slope, dmask=dmask)
    raise ValueError(f"unsupported device {xh.device}")


class _EllGATFused(torch.autograd.Function):
    """Kernel C (training form) forward, kernel C' backward, as the JAX
    custom VJP ``_fused_v3``: the forward keeps the layer's inputs (and
    the dropout mask or seed) and the attention dots kernel C computed
    ([N, 2 * heads] f32), the backward recomputes the softmax in kernel C'
    from them and sums its per-block d att_src / d att_dst / d bias
    partials in a fixed order."""

    @staticmethod
    def forward(ctx, xh, att_src, att_dst, el, el_self, bias, nbr_src,
                nbr_mask, node_mask, dmask, drop_seed, perm, row_ptr, opts):
        self_loop, slope, keep_prob = opts
        kw = kernel_args(xh, att_src, att_dst, nbr_src, nbr_mask, el,
                         el_self, self_loop=self_loop, bias=bias,
                         node_mask=node_mask, negative_slope=slope,
                         dmask=dmask, drop_seed=drop_seed,
                         keep_prob=keep_prob, train=True)
        n, k = kw["n"], kw["k"]
        _check(tuple(perm.shape) == (n * k,)
               and tuple(row_ptr.shape) == (n + 1,)
               and perm.device == xh.device and row_ptr.device == xh.device,
               f"slot tables {tuple(perm.shape)} / {tuple(row_ptr.shape)} "
               f"vs N={n}, K={k}")
        # the attention dots kernel C computes, kept for kernel C'
        dots = torch.empty(n, 2 * kw["heads"], device=xh.device,
                           dtype=torch.float32)
        out = call_kernel(**kw, dots=dots)
        ctx.save_for_backward(
            kw["xh"], kw["att"], kw["nbr"], kw["nmask"], kw["el"],
            kw["el_self"], kw["node_mask"], kw["dmask"], kw["seed"],
            perm.to(torch.int32).contiguous(),
            row_ptr.to(torch.int32).contiguous(), dots)
        ctx.kw = {name: kw[name] for name in (
            "n", "k", "heads", "c", "negative_slope", "has_self",
            "drop_mode", "thresh", "keep_inv", "dtype")}
        ctx.shapes = (att_src.shape, att_dst.shape)
        ctx.has = (el is not None, el_self is not None, bias is not None)
        return out

    @staticmethod
    def backward(ctx, g):
        (xh, att, nbr, nmask, el, el_self, node_mask, dmask, seed, perm,
         row_ptr, dots) = ctx.saved_tensors
        dxh, _, dl, del_self, part = call_bwd_kernel(
            xh=xh, att=att, nbr=nbr, nmask=nmask, el=el, el_self=el_self,
            node_mask=node_mask, dmask=dmask, seed=seed, perm=perm,
            row_ptr=row_ptr, g=g.to(xh.dtype).contiguous(), dots=dots,
            **ctx.kw)
        sums = part.sum(0)                                  # [3, HC]
        has_el, has_self, has_bias = ctx.has
        n, k, heads = ctx.kw["n"], ctx.kw["k"], ctx.kw["heads"]
        return (dxh, sums[0].reshape(ctx.shapes[0]),
                sums[1].reshape(ctx.shapes[1]),
                dl.reshape(n, k, heads) if has_el else None,
                del_self if has_self else None,
                sums[2] if has_bias else None,
                None, None, None, None, None, None, None, None)


def drop_mask(drop_seed: torch.Tensor, keep_prob: float, n: int, k: int,
              heads: int) -> torch.Tensor:
    """The in-kernel dropout draw of ``drop_seed`` written out as the f32
    mask [N, K+1, heads] that kernels C and C' apply: a debug entry for
    holding the draw against the streamed-mask path. CUDA only; not on any
    model path."""
    from ._build import library

    _check(drop_seed.is_cuda and drop_seed.dtype == torch.int64
           and drop_seed.numel() == 1, "drop_seed: one int64 on the card")
    thresh, keep_inv = drop_threshold(keep_prob)
    out = torch.empty(n, k + 1, heads, device=drop_seed.device,
                      dtype=torch.float32)
    lib = library("ell_gat_fwd")
    with torch.cuda.device(drop_seed.device):
        err = lib.ell_gat_drop_mask(
            out.data_ptr(), drop_seed.data_ptr(), thresh, keep_inv, n, k,
            heads, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ell_gat_drop_mask failed: CUDA error {err}")
    return out


def attention_dots(xh: torch.Tensor, att: torch.Tensor, heads: int,
                   generic: bool = False) -> torch.Tensor:
    """The attention dots [N, 2 * heads] f32 (a_src then a_dst) that
    kernels C and C' compute, of xh [N, HC] and att [2, HC] (``kernel_args``'
    ``xh`` and ``att``). ``generic`` runs the one-node-a-warp form
    (``ellgat::dots_kernel``) instead of ``rows::node_dots_kernel``: a debug
    entry for holding the two against each other bit for bit. CUDA only;
    not on any model path."""
    from ._build import library

    n, hc = xh.shape
    _check(xh.is_cuda and att.shape == (2, hc) and att.dtype == xh.dtype
           and xh.is_contiguous() and att.is_contiguous()
           and hc % heads == 0, f"xh {tuple(xh.shape)} / att "
           f"{tuple(att.shape)}")
    out = torch.empty(n, 2 * heads, device=xh.device, dtype=torch.float32)
    lib = library("ell_gat_fwd")
    with torch.cuda.device(xh.device):
        err = lib.ell_gat_dots(
            _DTYPE_CODE[xh.dtype], xh.data_ptr(), att.data_ptr(),
            out.data_ptr(), n, heads, hc // heads, int(generic),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"ell_gat_dots failed: CUDA error {err}")
    return out


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"ell_gat kernel: {msg}")


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def kernel_args(xh, att_src, att_dst, nbr_src, nbr_mask, el=None,
                el_self=None, *, self_loop: bool = True, bias=None,
                node_mask=None, negative_slope: float = 0.2, dmask=None,
                drop_seed=None, keep_prob: float = 1.0,
                train: bool = False) -> dict:
    """Check a CUDA call and prepare kernel C's inputs (contiguous
    tensors: xh, the attention vectors as one [2, HC] tensor and the bias
    in xh's dtype, el, el_self and the mask f32, indices int32, uint8
    masks; the dropout arguments). ``train`` marks the training form (it
    counts in ``train_launches``). Raises ValueError on anything the
    kernel does not take."""
    f32 = torch.float32
    _check(xh.dim() == 2, f"xh must be [N, HC], got {tuple(xh.shape)}")
    n, hc = xh.shape
    heads, c = att_src.shape[-2], att_src.shape[-1]
    _check(xh.dtype in _DTYPE_CODE, f"xh dtype {xh.dtype}: the kernel takes "
           "float32 or bfloat16")
    cd = xh.dtype
    _check(1 <= heads <= _MAX_HEADS, f"heads={heads} not in 1..{_MAX_HEADS}")
    _check(heads * c == hc, f"att {tuple(att_src.shape)} vs HC={hc}")
    _check(att_dst.numel() == hc, f"att_dst {tuple(att_dst.shape)}")
    _check(nbr_src.dim() == 2 and nbr_src.shape[0] == n
           and tuple(nbr_mask.shape) == tuple(nbr_src.shape),
           f"nbr_src {tuple(nbr_src.shape)} / nbr_mask "
           f"{tuple(nbr_mask.shape)} vs N={n}")
    k = nbr_src.shape[1]
    _check(n >= 1 and k >= 1, f"empty graph: N={n}, K={k}")
    _check(n * max(hc, 2 * heads, k) < 2 ** 62, "graph too large")
    dev = xh.device
    tensors = [t for t in (xh, att_src, att_dst, nbr_src, nbr_mask, el,
                           el_self, bias, node_mask, dmask, drop_seed)
               if t is not None]
    _check(all(t.device == dev for t in tensors),
           "all inputs must be on the device of xh")
    if el is not None:
        _check(tuple(el.shape) == (n, k, heads),
               f"el {tuple(el.shape)} != {(n, k, heads)}")
    if el_self is not None:
        _check(tuple(el_self.shape) == (n, heads),
               f"el_self {tuple(el_self.shape)} != {(n, heads)}")
    if bias is not None:
        _check(bias.numel() == hc, f"bias {tuple(bias.shape)} vs HC={hc}")
    if node_mask is not None:
        _check(tuple(node_mask.shape) == (n,),
               f"node_mask {tuple(node_mask.shape)} != {(n,)}")
    drop_mode, thresh, keep_inv = 0, 0, 1.0
    if dmask is not None:
        _check(drop_seed is None, "dmask and drop_seed together")
        _check(tuple(dmask.shape) == (n, k + 1, heads),
               f"dmask {tuple(dmask.shape)} != {(n, k + 1, heads)}")
        dmask = dmask.to(f32).contiguous()
        drop_mode = 1
    elif drop_seed is not None:
        _check(drop_seed.dtype == torch.int64 and drop_seed.numel() == 1,
               "drop_seed must be one int64 element")
        drop_seed = drop_seed.contiguous()
        drop_mode = 2
        thresh, keep_inv = drop_threshold(keep_prob)
    from ._build import library

    wpb = library("ell_gat_fwd").ell_gat_fwd_warps_per_block(k, heads)
    _check(wpb >= 1, f"K={k} x heads={heads}: the slot weights do not fit "
           "in one warp's shared memory")

    def u8(t):
        return None if t is None else t.to(torch.bool).contiguous().view(
            torch.uint8)

    def cf(t):
        return None if t is None else t.to(f32).contiguous()

    kw = dict(
        xh=xh.contiguous(),
        att=torch.cat([att_src.reshape(1, hc), att_dst.reshape(1, hc)]
                      ).to(cd).contiguous(),
        nbr=nbr_src.to(torch.int32).contiguous(), nmask=u8(nbr_mask),
        el=cf(el), el_self=cf(el_self),
        bias=None if bias is None else bias.reshape(hc).to(cd).contiguous(),
        node_mask=u8(node_mask),
        n=n, k=k, heads=heads, c=c, negative_slope=float(negative_slope),
        has_self=bool(self_loop), drop_mode=drop_mode, dmask=dmask,
        seed=drop_seed, thresh=thresh, keep_inv=keep_inv, train=train,
        dtype=_DTYPE_CODE[cd])
    vec4 = c % 4 == 0 and all(_aligned(t) for t in (kw["xh"],) + (
        (kw["bias"],) if kw["bias"] is not None else ()))
    kw["vec"] = 4 if vec4 else 1
    return kw


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def call_kernel(*, xh, att, nbr, nmask, el, el_self, bias, node_mask, n, k,
                heads, c, negative_slope, has_self, vec, dtype, drop_mode=0,
                dmask=None, seed=None, thresh=0, keep_inv=1.0, train=False,
                dots=None):
    """Launch kernel C (its dots and aggregate kernels) on prepared inputs
    (``kernel_args``) on the current stream; returns out [N, HC] in xh's
    dtype. ``dots``: an f32 [N, 2 * heads] tensor on the card that gets
    the attention dots (a_src then a_dst), for kernel C' (else scratch).
    The only place that counts ``launches`` (inference form) and
    ``train_launches`` (training form)."""
    global launches, train_launches
    from ._build import library

    # torch's allocator aligns both to 256 bytes (16 needed for float4)
    out = torch.empty(n, heads * c, device=xh.device, dtype=xh.dtype)
    if dots is None:
        dots = torch.empty(n, 2 * heads, device=xh.device,
                           dtype=torch.float32)
    _check(tuple(dots.shape) == (n, 2 * heads) and dots.is_contiguous()
           and dots.dtype == torch.float32 and dots.device == xh.device,
           f"dots {tuple(dots.shape)} {dots.dtype}")
    lib = library("ell_gat_fwd")
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ell_gat_fwd(
            dtype, xh.data_ptr(), att.data_ptr(), nbr.data_ptr(),
            nmask.data_ptr(), _ptr(el), _ptr(el_self), _ptr(bias),
            _ptr(node_mask), dots.data_ptr(), out.data_ptr(), n, k, heads, c,
            negative_slope, int(has_self), vec, drop_mode, _ptr(dmask),
            _ptr(seed), thresh, keep_inv, stream)
    if err != 0:
        msg = lib.ell_gat_fwd_error_string(err).decode()
        raise RuntimeError(f"ell_gat_fwd kernels failed to launch: CUDA "
                           f"error {err} ({msg})")
    if train:
        train_launches += 1
    else:
        launches += 1
    return out


def _realigned(t: torch.Tensor) -> torch.Tensor:
    """t itself when its data starts on 16 bytes (the kernels' row
    chunks), else a fresh copy (the allocator aligns to 256)."""
    return t if _aligned(t) else t.clone()


def call_bwd_kernel(*, xh, att, nbr, nmask, el, el_self, node_mask, dmask,
                    seed, perm, row_ptr, g, n, k, heads, c, negative_slope,
                    has_self, drop_mode, thresh, keep_inv, dtype,
                    source_side: bool = True, dots=None):
    """Launch kernel C' (the attention dots unless ``dots`` brings the
    [N, 2 * heads] f32 ones kernel C computed for the same xh and att
    (``call_kernel(dots=...)``: the same bits), the destination pass, then
    kernel F in its mode (b) with the destination side added first) on the
    inputs kernel C was given (``kernel_args``), the cotangent ``g``
    [N, HC] in xh's dtype and the source-sorted slot tables. Returns (dxh
    [N, HC] in xh's dtype, alpha and dl [N * K, heads] (the dropped softmax
    weights, unnormalized in the bf16 form, and the logit cotangents, i.e.
    d el), d el_self [N, heads], partials [blocks, 3, HC] of d att_src,
    d att_dst and d bias), f32 but dxh. ``source_side=False`` leaves
    kernel F out (for timing the destination pass on its own): the first
    element is then what that pass writes for the destination side of dxh,
    dsc [N, 3, heads] f32 = (at_s, the rounded dl sum, the rounded dl_self)
    per node and head (kernel F's mode (b) forms its rows from them as
    at_s dy + dst_r att_dst + dls_r att_src). The only place
    that counts ``bwd_launches``, and kernel F's launches
    (``segment_reduce.launches``) of mode (b) within C'."""
    global bwd_launches
    from ._build import library

    hc = heads * c
    _check(tuple(g.shape) == (n, hc) and g.dtype == xh.dtype
           and g.is_contiguous(), f"cotangent {tuple(g.shape)} {g.dtype}")
    lowp = xh.dtype != torch.float32
    xh, g, att = _realigned(xh), _realigned(g), _realigned(att)
    vec = 4 if c % 4 == 0 else 1
    lib = library("ell_gat_bwd")
    dev = xh.device
    with torch.cuda.device(dev):
        blocks = lib.ell_gat_bwd_blocks(dtype, n, k, heads, c, vec)
    _check(blocks >= 1, f"K={k} x heads={heads}: the slot tables of one "
           "warp exceed the card's shared memory")
    f32 = dict(device=dev, dtype=torch.float32)
    if dots is not None:
        _check(tuple(dots.shape) == (n, 2 * heads) and dots.is_contiguous()
               and dots.dtype == torch.float32 and dots.device == dev,
               f"dots {tuple(dots.shape)} {dots.dtype}")
    scratch = torch.empty(n, 2 * heads, **f32) if dots is None else None
    alpha = torch.empty(n * k, heads, **f32)
    dl = torch.empty(n * k, heads, **f32)
    dsc = torch.empty(n, 3, heads, **f32)
    dxh = torch.empty(n, hc, device=dev, dtype=xh.dtype) if source_side \
        else None
    inv = torch.empty(n, heads, **f32) if lowp else None
    del_self = torch.empty(n, heads, **f32)
    part = torch.empty(blocks, 3, hc, **f32)
    with torch.cuda.device(dev):
        err = lib.ell_gat_bwd(
            dtype, xh.data_ptr(), att.data_ptr(), nbr.data_ptr(),
            nmask.data_ptr(), _ptr(el), _ptr(el_self), _ptr(node_mask),
            g.data_ptr(), drop_mode, _ptr(dmask), _ptr(seed), thresh,
            keep_inv, _ptr(perm if source_side else None),
            _ptr(row_ptr if source_side else None), _ptr(scratch),
            _ptr(dots), alpha.data_ptr(), dl.data_ptr(), _ptr(inv),
            dsc.data_ptr(), _ptr(dxh), del_self.data_ptr(), part.data_ptr(),
            n, k,
            heads, c, negative_slope, int(has_self), vec, blocks,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.ell_gat_bwd_error_string(err).decode()
        raise RuntimeError(f"ell_gat_bwd kernels failed to launch: CUDA "
                           f"error {err} ({msg})")
    bwd_launches += 1
    if not source_side:
        return dsc, alpha, dl, del_self, part
    segment_reduce.launches += 1
    return dxh, alpha, dl, del_self, part
