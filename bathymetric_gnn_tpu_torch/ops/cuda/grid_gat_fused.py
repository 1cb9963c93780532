"""Fused grid-GAT inference layer: CUDA kernel and its plain version.

Counterpart of ``bathymetric_gnn_tpu/ops/pallas/grid_gat_fused.py``'s
inference entry ``fused_grid_gat_infer`` and its Pallas ``_kernel``. One
8- (or 4-) connected GAT layer on dense [B, H, W, F] tiles:
x @ W and the attention dots, per-offset logits + premasked edge logits,
LeakyReLU, softmax over the neighbours and the self loop, the weighted
sum, + bias, an optional BatchNorm-affine (+ ReLU) epilogue, and the
validity mask.

Which implementation runs follows only the device of ``x``: a CUDA tensor
launches the hand-written kernel (``csrc/grid_gat_fwd.cu``), a CPU tensor
runs ``grid_gat_infer_reference``. There is no fallback between them: a
CUDA input the kernel does not take raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..edges import offsets_for_connectivity

NEG = -1e30

# Number of times the CUDA kernel has been launched in this process. Only
# the launch site below adds to it; callers reset it to 0 to count the
# launches of one run.
launches = 0

_KERNEL_HEADS = (1, 2, 4, 8)
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
        el = torch.einsum("bkhwf,fa->bkahw", ea, me)
        el = torch.where(nbm[:, :, None], el, torch.full_like(el, NEG))
        cnt = nbm.to(torch.float32).sum(1).clamp_min(1.0)[..., None]
        mean_attr = torch.where(nbm[..., None], ea,
                                torch.zeros_like(ea)).sum(1) / cnt
        el_self = torch.einsum("bhwf,fa->bahw", mean_attr, me)
    else:
        b, k, h, w = nbm.shape
        el = torch.where(nbm, 0.0, NEG)[:, :, None].expand(
            b, k, heads, h, w)
        el_self = torch.zeros(b, heads, h, w, device=nbm.device)
    wa = torch.cat([w_lin @ a_src_mat, w_lin @ a_dst_mat], dim=1)
    return (wa.to(compute_dtype), el.to(compute_dtype).contiguous(),
            el_self.to(compute_dtype).contiguous())


def _shift2(a: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
    """a_shifted[b, r, c] = a[b, r + dr, c + dc] (wraps; masked later)."""
    return torch.roll(a, shifts=(-dr, -dc), dims=(1, 2))


def grid_gat_infer_reference(x, w_lin, a_src_mat, a_dst_mat, m_edge, eattr,
                             nbr_mask, valid, bias, connectivity: int = 8,
                             negative_slope: float = 0.2,
                             use_edge: bool = True, *, bn_scale=None,
                             bn_bias=None, fuse_relu: bool = False,
                             compute_dtype=torch.float32):
    """Plain PyTorch version of the kernel (batched [B, H, W, F]).

    ``_reference_forward`` plus the epilogue and mask as ``_fused_forward``
    applies them. In bf16 it rounds where the kernel rounds: x, W,
    W@[a_src|a_dst], the edge logit terms and the output; everything else
    is f32. The attention dots are x @ (W @ a), the kernel's formulation,
    equal to (x @ W) @ a up to f32 rounding.
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

    def eh(wts):  # [B, H, W, heads] -> [B, H, W, HC]
        return torch.repeat_interleave(wts, c, dim=-1)

    acc = xh * eh(e_self / denom)
    for k, (dr, dc) in enumerate(offsets):
        acc = acc + _shift2(xh, dr, dc) * eh(exps[k] / denom)
    acc = acc + bias.to(f32).reshape(1, 1, 1, hc)
    if bn_scale is not None:
        acc = acc * bn_scale.to(f32) + bn_bias.to(f32)
    if fuse_relu:
        acc = torch.relu(acc)
    acc = acc * (valid > 0)[..., None]
    return acc.to(compute_dtype)


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
    and accumulation stay f32. A CUDA ``x`` launches the kernel, a CPU
    ``x`` runs the plain version. No autograd.
    """
    unbatched = x.dim() == 3
    if unbatched:
        x, eattr, nbr_mask, valid = (x[None], eattr[None], nbr_mask[None],
                                     valid[None])
    args = (x, w_lin, a_src_mat, a_dst_mat, m_edge, eattr, nbr_mask, valid,
            bias, connectivity, negative_slope, use_edge)
    kw = dict(bn_scale=bn_scale, bn_bias=bn_bias, fuse_relu=fuse_relu,
              compute_dtype=compute_dtype)
    if x.device.type == "cuda":
        out = call_kernel(**kernel_args(*args, **kw))
    elif x.device.type == "cpu":
        out = grid_gat_infer_reference(*args, **kw)
    else:
        raise ValueError(f"unsupported device {x.device}")
    return out[0] if unbatched else out


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"grid_gat_fwd kernel: {msg}")


def kernel_args(x, w_lin, a_src_mat, a_dst_mat, m_edge, eattr, nbr_mask,
                valid, bias, connectivity, negative_slope, use_edge, *,
                bn_scale, bn_bias, fuse_relu, compute_dtype) -> dict:
    """Check a batched CUDA call and prepare the kernel's own inputs
    (the edge precompute, casts, contiguous copies). Raises ValueError on
    anything the kernel does not take."""
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
               valid, bias] + [t for t in (bn_scale, bn_bias)
                               if t is not None]
    _check(all(t.device == dev for t in tensors),
           "all inputs must be on the device of x")

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
        fuse_relu=bool(fuse_relu))
    for name in ("x", "w", "wa", "el", "el_self", "valid", "bias",
                 "bn_scale", "bn_shift"):
        t = kw[name]
        want = dt if name in ("x", "w", "wa", "el", "el_self") else (
            torch.float32)
        _check(t.dtype == want and t.is_contiguous(),
               f"{name}: {t.dtype}, contiguous={t.is_contiguous()}")
    return kw


def call_kernel(*, x, w, wa, el, el_self, valid, bias, bn_scale, bn_shift,
                heads, connectivity, negative_slope, fuse_bn, fuse_relu):
    """Launch the kernel on prepared inputs (``kernel_args``) on the
    current stream; returns the output [B, H, W, HC]. The only place that
    counts ``launches``."""
    global launches
    from ._build import library

    b, h, wd, f_in = x.shape
    hc = w.shape[1]
    out = torch.empty(b, h, wd, hc, device=x.device, dtype=x.dtype)
    lib = library("grid_gat_fwd")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.grid_gat_fwd(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), wa.data_ptr(),
            el.data_ptr(), el_self.data_ptr(), valid.data_ptr(),
            bias.data_ptr(), bn_scale.data_ptr(), bn_shift.data_ptr(),
            out.data_ptr(), b, h, wd, f_in, hc, heads, connectivity,
            negative_slope, int(fuse_bn), int(fuse_relu), stream)
    if err != 0:
        msg = lib.grid_gat_cuda_error_string(err).decode()
        raise RuntimeError(f"grid_gat_fwd kernel launch failed: CUDA error "
                           f"{err} ({msg})")
    launches += 1
    return out
