"""GAT layer on an ELL graph: CUDA kernel C (forward, inference form) and
its plain version.

Counterpart of ``bathymetric_gnn_tpu/ops/pallas/ell_gat_fused.py``'s
``ell_gat_fused_wide_pallas`` (the Pallas ``_kernel_v3``) as the JAX
``GATConvEllBanded`` calls it in eval mode: f32, no dropout. One PyG-exact
GAT layer on a destination-major ELL graph: the attention dots of xh, the
per-slot logits a_src[nbr] + a_dst + el and the self-loop logit, LeakyReLU,
the masked softmax over the live slots and the self loop, the weighted
gather-sum, + bias and the node mask. The TPU kernel's band/spill layout
exists because a TPU has no fast gather; the CUDA kernel reads ``nbr_src``
directly, so it takes the graph as ``ops/ell.coo_to_ell`` packs it.

Which implementation runs follows only the device of ``xh``: a CUDA tensor
launches the hand-written kernel (``csrc/ell_gat_fwd.cu``), a CPU tensor
runs ``ell_gat_reference``. There is no fallback between them: a CUDA
input the kernel does not take raises. The layer's backward (the TPU
kernel's ``_bwd_kernel_v3``, "C'" in ROADMAP.md's queue 2) is not ported:
under grad mode with an input that requires grad the layer raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ell import ell_gather, ell_masked_softmax

# Launches of kernel C in this process. Only ``call_kernel`` adds to it;
# callers reset it to 0 to count the launches of one run.
launches = 0

_MAX_HEADS = 8


def ell_gat_reference(xh, att_src, att_dst, nbr_src, nbr_mask, el=None,
                      el_self=None, *, self_loop: bool = True, bias=None,
                      node_mask=None, negative_slope: float = 0.2):
    """Plain PyTorch version of kernel C (the JAX ``GATConvELL`` math on a
    given xh), with the signature of ``ell_gat_fused``.

    xh [N, HC]; att_src, att_dst [..., heads, C]; nbr_src [N, K] int;
    nbr_mask [N, K] bool; el [N, K, heads] edge-logit terms or None;
    el_self [N, heads] or None (zeros) for the self loop, which
    ``self_loop`` turns on; bias [HC] or None; node_mask [N] bool or None.
    Returns [N, HC] f32.
    """
    f32 = torch.float32
    n, hc = xh.shape
    a_s = att_src.reshape(-1, att_src.shape[-1]).to(f32)
    a_d = att_dst.reshape(-1, att_dst.shape[-1]).to(f32)
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
    nbr_x = ell_gather(x3, nbr_src)                          # [N, K, h, C]
    nbr_x = torch.where(mask[..., None, None], nbr_x, torch.zeros_like(nbr_x))
    out = (nbr_x * wts[..., None]).sum(1)
    if w_self is not None:
        out = out + x3 * w_self[..., None]
    out = out.reshape(n, hc)
    if bias is not None:
        out = out + bias.to(f32)
    if node_mask is not None:
        out = torch.where(node_mask.to(torch.bool)[:, None], out,
                          torch.zeros_like(out))
    return out


def ell_gat_fused(xh, att_src, att_dst, nbr_src, nbr_mask, el=None,
                  el_self=None, *, self_loop: bool = True, bias=None,
                  node_mask=None, negative_slope: float = 0.2):
    """Inference GAT layer on an ELL graph (arguments as
    ``ell_gat_reference``); returns [N, HC] f32. A CUDA ``xh`` launches
    kernel C, a CPU ``xh`` runs the plain version.

    It has no backward: with grad mode on and an input that requires grad
    it raises (the backward, kernel C', is still to port)."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (xh, att_src, att_dst, el, el_self, bias)):
        raise RuntimeError(
            "ell_gat_fused has no backward: the backward of kernel C (C', "
            "ROADMAP.md queue 2) is not ported yet; call it under "
            "torch.no_grad()")
    args = (xh, att_src, att_dst, nbr_src, nbr_mask, el, el_self)
    kw = dict(self_loop=self_loop, bias=bias, node_mask=node_mask,
              negative_slope=negative_slope)
    if xh.device.type == "cuda":
        return call_kernel(**kernel_args(*args, **kw))
    if xh.device.type == "cpu":
        return ell_gat_reference(*args, **kw)
    raise ValueError(f"unsupported device {xh.device}")


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"ell_gat kernel: {msg}")


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def kernel_args(xh, att_src, att_dst, nbr_src, nbr_mask, el=None,
                el_self=None, *, self_loop: bool = True, bias=None,
                node_mask=None, negative_slope: float = 0.2) -> dict:
    """Check a CUDA call and prepare kernel C's inputs (f32 and int32
    contiguous tensors, uint8 masks, the attention vectors as one [2, HC]
    tensor, the dots scratch). Raises ValueError on anything the kernel
    does not take."""
    f32 = torch.float32
    _check(xh.dim() == 2, f"xh must be [N, HC], got {tuple(xh.shape)}")
    n, hc = xh.shape
    heads, c = att_src.shape[-2], att_src.shape[-1]
    _check(xh.dtype == f32, f"xh dtype {xh.dtype}: the kernel takes float32 "
           "only (the bf16 form is still to port)")
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
                           el_self, bias, node_mask) if t is not None]
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
                      ).to(f32).contiguous(),
        nbr=nbr_src.to(torch.int32).contiguous(), nmask=u8(nbr_mask),
        el=cf(el), el_self=cf(el_self),
        bias=None if bias is None else cf(bias.reshape(hc)),
        node_mask=u8(node_mask),
        n=n, k=k, heads=heads, c=c, negative_slope=float(negative_slope),
        has_self=bool(self_loop))
    vec4 = c % 4 == 0 and all(_aligned(t) for t in (kw["xh"],) + (
        (kw["bias"],) if kw["bias"] is not None else ()))
    kw["vec"] = 4 if vec4 else 1
    return kw


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def call_kernel(*, xh, att, nbr, nmask, el, el_self, bias, node_mask, n, k,
                heads, c, negative_slope, has_self, vec):
    """Launch kernel C (its dots and aggregate kernels) on prepared inputs
    (``kernel_args``) on the current stream; returns out [N, HC] f32. The
    only place that counts ``launches``."""
    global launches
    from ._build import library

    # torch's allocator aligns both to 256 bytes (16 needed for float4)
    out = torch.empty(n, heads * c, device=xh.device, dtype=torch.float32)
    dots = torch.empty(n, 2 * heads, device=xh.device, dtype=torch.float32)
    lib = library("ell_gat_fwd")
    with torch.cuda.device(xh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ell_gat_fwd(
            xh.data_ptr(), att.data_ptr(), nbr.data_ptr(), nmask.data_ptr(),
            _ptr(el), _ptr(el_self), _ptr(bias), _ptr(node_mask),
            dots.data_ptr(), out.data_ptr(), n, k, heads, c, negative_slope,
            int(has_self), vec, stream)
    if err != 0:
        msg = lib.ell_gat_fwd_error_string(err).decode()
        raise RuntimeError(f"ell_gat_fwd kernels failed to launch: CUDA "
                           f"error {err} ({msg})")
    launches += 1
    return out
