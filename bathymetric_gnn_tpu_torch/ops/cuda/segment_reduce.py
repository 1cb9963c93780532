"""Sorted-segment row reduction: CUDA kernel F and its plain version.

Counterpart of ``bathymetric_gnn_tpu/ops/pallas/segment_reduce.py``'s
``segment_reduce_sorted`` (the Pallas ``_reduce_kernel``): the backward of
a row gather, ``out[j] = sum of ct[perm[s]]`` over the slots s of source
j's segment ``row_ptr[j] <= s < row_ptr[j + 1]``, taken in sorted order
with no scatter-add. The tables come from ``ops/ell.src_sorted_slots``
(the JAX package takes block-range tables from ``band_ell`` instead; the
port needs none).

``segment_reduce_sorted`` is the generic entry, mode (a) of the kernel
(``csrc/segment_reduce.cu``). Mode (b), where each row is formed in
registers from kernel C''s per-slot coefficients, runs inside kernel C''s
call (``ell_gat_fused``) on the training path; ``gat_rows`` launches it on
its own (to hold it against its plain version, ``gat_rows_reference``,
and to time it).

Which implementation runs follows only the device of ``ct``: a CUDA
tensor launches the kernel, a CPU tensor runs the plain version. There is
no fallback between them: a CUDA input the kernel does not take raises.
"""

from __future__ import annotations

import torch

from .grid_gat_fused import _DTYPE_CODE

# Launches of kernel F in this process, both modes: mode (a) here, mode (b)
# where kernel C''s call launches it (``ell_gat_fused.call_bwd_kernel``).
# Callers reset it to 0 to count the launches of one run.
launches = 0


def _segment_of_sorted(row_ptr: torch.Tensor, n: int) -> torch.Tensor:
    """The output row of each of the first row_ptr[n] sorted slots."""
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n, device=row_ptr.device), counts)


def segment_reduce_reference(ct: torch.Tensor, perm: torch.Tensor,
                             row_ptr: torch.Tensor, n: int) -> torch.Tensor:
    """Plain version of kernel F, mode (a): ``index_add_`` of the slots'
    rows into their segments. ct [S, F] float32 or bfloat16 (summed in
    f32); perm [>= row_ptr[n]] int; row_ptr [n + 1] int. Returns [n, F]
    f32."""
    live = perm[:int(row_ptr[n])].long()
    out = torch.zeros(n, ct.shape[1], device=ct.device, dtype=torch.float32)
    return out.index_add_(0, _segment_of_sorted(row_ptr, n),
                          ct.to(torch.float32)[live])


def segment_reduce_in_order(ct: torch.Tensor, perm: torch.Tensor,
                            row_ptr: torch.Tensor, n: int) -> torch.Tensor:
    """Kernel F's bits (mode a), for tests: each segment padded to the
    longest with zero rows, then summed slot by slot in ascending order
    from 0, one f32 add a slot, as the kernel adds (adding 0 leaves a sum
    unchanged, bit for bit). Arguments and result as
    ``segment_reduce_reference``; nothing on the main path calls it."""
    rp = row_ptr[:n + 1].long()
    lo, cnt = rp[:-1], rp[1:] - rp[:-1]
    rows = ct.to(torch.float32)
    out = torch.zeros(n, ct.shape[1], device=ct.device, dtype=torch.float32)
    p = perm.long()
    for t in range(int(cnt.max()) if n else 0):
        has = cnt > t
        slot = torch.where(has, lo + t, torch.zeros_like(lo))
        row = rows.index_select(0, p[slot])
        out = out + torch.where(has[:, None], row, torch.zeros_like(row))
    return out


def gat_rows_reference(alpha: torch.Tensor, dl: torch.Tensor,
                       dy: torch.Tensor, att_src: torch.Tensor,
                       perm: torch.Tensor, row_ptr: torch.Tensor, n: int,
                       k: int) -> torch.Tensor:
    """Plain version of kernel F, mode (b): for each source j the sum over
    its slots s (destination i = s // k) of alpha[s, h] * dy[i, h, :] +
    dl[s, h] * att_src[h, :]. alpha, dl [N * K, heads]; dy [N, HC];
    att_src [HC] (or [..., heads, C]). Returns [n, HC] f32."""
    heads = alpha.shape[1]
    hc = dy.shape[1]
    c = hc // heads
    live = perm[:int(row_ptr[n])].long()
    a = alpha[live].to(torch.float32)                        # [L, heads]
    d = dl[live].to(torch.float32)
    rows = (dy.to(torch.float32)[live // k].reshape(-1, heads, c)
            * a[..., None]
            + d[..., None] * att_src.reshape(heads, c).to(torch.float32))
    out = torch.zeros(n, hc, device=dy.device, dtype=torch.float32)
    return out.index_add_(0, _segment_of_sorted(row_ptr, n),
                          rows.reshape(-1, hc))


def segment_reduce_sorted(ct: torch.Tensor, perm: torch.Tensor,
                          row_ptr: torch.Tensor, n: int) -> torch.Tensor:
    """Sum of ``ct``'s rows into their sorted segments (arguments as
    ``segment_reduce_reference``); returns [n, F] f32. A CUDA ``ct``
    launches kernel F, a CPU ``ct`` runs the plain version."""
    if ct.device.type == "cuda":
        return call_kernel(ct, perm, row_ptr, n)
    if ct.device.type == "cpu":
        return segment_reduce_reference(ct, perm, row_ptr, n)
    raise ValueError(f"unsupported device {ct.device}")


def gat_rows(alpha: torch.Tensor, dl: torch.Tensor, dy: torch.Tensor,
             att_src: torch.Tensor, perm: torch.Tensor,
             row_ptr: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """Mode (b) on its own (arguments as ``gat_rows_reference``); returns
    [n, HC] f32. A CUDA ``dy`` launches kernel F, a CPU ``dy`` runs the
    plain version."""
    if dy.device.type == "cuda":
        return call_gat_rows_kernel(alpha, dl, dy, att_src, perm, row_ptr,
                                    n, k)
    if dy.device.type == "cpu":
        return gat_rows_reference(alpha, dl, dy, att_src, perm, row_ptr, n,
                                  k)
    raise ValueError(f"unsupported device {dy.device}")


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"segment_reduce kernel: {msg}")


def call_kernel(ct: torch.Tensor, perm: torch.Tensor, row_ptr: torch.Tensor,
                n: int) -> torch.Tensor:
    """Check a CUDA call and launch kernel F (mode (a)) on the current
    stream (ct float32 or bfloat16, out f32); the only place that counts
    mode (a)'s ``launches``.

    The kernel takes a few microseconds at the COO path's narrow rows, so
    the host's share of a call is kept small: the checks build their
    messages only when they fail, the stream is read as a raw handle, and
    the device is switched only when ct is not on the current one."""
    global launches
    from ._build import library

    if ct.dim() != 2 or ct.dtype not in _DTYPE_CODE:
        raise ValueError(f"segment_reduce kernel: ct must be [S, F] float32 "
                         f"or bfloat16, got {tuple(ct.shape)} {ct.dtype}")
    f = ct.shape[1]
    if n < 1 or f < 1:
        raise ValueError(f"segment_reduce kernel: n={n}, F={f}")
    if row_ptr.dim() != 1 or row_ptr.shape[0] != n + 1:
        raise ValueError(f"segment_reduce kernel: row_ptr "
                         f"{tuple(row_ptr.shape)} != {(n + 1,)}")
    dev = ct.device
    if perm.device != dev or row_ptr.device != dev:
        raise ValueError("segment_reduce kernel: all inputs must be on the "
                         "device of ct")
    if perm.numel() >= 2 ** 31:
        raise ValueError("segment_reduce kernel: perm too long for int32")
    ct = ct.contiguous()
    if perm.dtype != torch.int32:
        perm = perm.to(torch.int32)
    if row_ptr.dtype != torch.int32:
        row_ptr = row_ptr.to(torch.int32)
    perm, row_ptr = perm.contiguous(), row_ptr.contiguous()
    out = torch.empty(n, f, device=dev, dtype=torch.float32)
    vec = 4 if f % 4 == 0 and ct.data_ptr() % 16 == 0 else 1
    lib = library("segment_reduce")
    args = (_DTYPE_CODE[ct.dtype], ct.data_ptr(), perm.data_ptr(),
            row_ptr.data_ptr(), out.data_ptr(), n, f, vec,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if dev.index == torch.cuda.current_device():
        err = lib.segment_reduce_sorted(*args)
    else:
        with torch.cuda.device(dev):
            err = lib.segment_reduce_sorted(*args)
    if err != 0:
        msg = lib.segment_reduce_error_string(err).decode()
        raise RuntimeError(f"segment_reduce kernel failed to launch: CUDA "
                           f"error {err} ({msg})")
    launches += 1
    return out


def call_gat_rows_kernel(alpha, dl, dy, att_src, perm, row_ptr, n: int,
                         k: int) -> torch.Tensor:
    """Check a CUDA call and launch kernel F's mode (b) on its own on the
    current stream; counts ``launches``."""
    global launches
    from ._build import library

    f32 = torch.float32
    heads = alpha.shape[1]
    _check(dy.dim() == 2 and dy.shape[0] == n and dy.shape[1] % heads == 0,
           f"dy {tuple(dy.shape)} vs n={n}, heads={heads}")
    hc = dy.shape[1]
    _check(tuple(alpha.shape) == tuple(dl.shape) == (n * k, heads)
           and att_src.numel() == hc and tuple(row_ptr.shape) == (n + 1,),
           "alpha / dl [n * k, heads], att_src [HC], row_ptr [n + 1]")
    _check(all(t.device == dy.device for t in (alpha, dl, att_src, perm,
                                                row_ptr)),
           "all inputs must be on the device of dy")
    alpha, dl, dy = (t.to(f32).contiguous() for t in (alpha, dl, dy))
    att = att_src.reshape(hc).to(f32).contiguous()
    perm = perm.to(torch.int32).contiguous()
    row_ptr = row_ptr.to(torch.int32).contiguous()
    out = torch.empty(n, hc, device=dy.device, dtype=f32)
    c = hc // heads
    vec = 4 if c % 4 == 0 and all(t.data_ptr() % 16 == 0
                                  for t in (dy, att)) else 1
    lib = library("segment_reduce")
    with torch.cuda.device(dy.device):
        err = lib.segment_reduce_gat_rows(
            alpha.data_ptr(), dl.data_ptr(), dy.data_ptr(), att.data_ptr(),
            perm.data_ptr(), row_ptr.data_ptr(), out.data_ptr(), n, k, heads,
            c, vec, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.segment_reduce_error_string(err).decode()
        raise RuntimeError(f"segment_reduce (mode b) failed to launch: CUDA "
                           f"error {err} ({msg})")
    launches += 1
    return out
