"""Banded ELL layout (port of ``bathymetric_gnn_tpu/ops/ell_banded.py``):
the band/spill decomposition that kernels D, D' and E read.

Nodes are Morton/Hilbert ordered, so almost every k-NN edge joins nodes
whose indices differ by less than one band of ``R`` rows. Destinations are
taken in bands of R rows; an edge is **in-band** when its source lies in
the band's 3-band window (chunks t-1, t, t+1) and is then addressed by a
local window index ``loc = (src_chunk - dst_chunk + 1) * R + src % R`` in
[0, 3R). The few other edges (**spill**, ~1 % after Hilbert ordering) are
compacted into a flat COO list and into per-band tables. The band part's
softmax runs over the in-band slots and the self loop and emits each
row's statistics (max m, denominator D); the spills are folded in exactly
by renormalization, ``y = (y_band * D + sum e_s xh_s) / (D + sum e_s)``
with ``e_s = exp(min(l_s - m, 60))``.

``band_ell`` splits a (NumPy) ``EllGraph`` on the host, as the JAX
function does; ``BandedEll.to`` moves the result to a device. In place of
the JAX package's Pallas reducer tables (``spill_red_*``, the sorted key
arrays) it carries (perm, row_ptr) tables of ``ops/ell.sorted_segments``:
over the flat per-band spill entries by source and by destination (the
backward of the spill-row gathers, kernel F mode (a)), and over the
in-band slots by their window source (the source side of kernel D').
The wide-kernel fields (``loc_nb``, ``eattr_wide_t``, ``negmask_wide``)
are not ported: the port's kernel C reads ``nbr_src`` directly.

``banded_gat_band_part_xla``, ``banded_gat_spill_pass`` and
``banded_gat_spill_pass_flat`` are plain PyTorch (XLA outside any Pallas
kernel in the JAX package; ``index_add_`` takes the place of
``segment_sum``). ``gather_rows_reduce_bwd`` is a row gather whose
backward is ``ops/cuda/segment_reduce.segment_reduce_sorted``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .cuda import segment_reduce
from .ell import sorted_segments

NEG_BIG = -1e30  # pre-LeakyReLU "minus infinity" for dead slots


@dataclasses.dataclass
class BandedEll:
    """Band/spill decomposition of an EllGraph. NumPy arrays as
    ``band_ell`` builds it, tensors after ``to``.

    loc_t [K, N] int32: in-band local window index in [0, 3R), -1 for dead
    or spilled slots. spill_src / spill_dst / spill_slot [P] int32,
    spill_mask [P] bool: the flat spill list (P a power-of-two multiple of
    ``spill_pad``). eattr_t [K, Fe, N], mean_attr_t [Fe, N] (masked mean
    of the live incoming attributes), spill_eattr [P, Fe]. Per band:
    spill_src_b / spill_dst_b [T, S] int32 (0 pad), spill_dst_local_b
    [T, 1, S] int32 (row in the band, -1 pad), spill_eattr_b [T, S, Fe].
    negmask_t [K * heads, N] f32: 0 for in-band slots, NEG_BIG otherwise.
    spill_perm / spill_row_ptr and spill_perm_d / spill_row_ptr_d: the
    flat T * S spill entries grouped by source and by destination;
    band_perm / band_row_ptr: the N * K slots (slot = dst * K + k) with an
    in-band source, grouped by that source.
    """

    loc_t: object
    spill_src: object
    spill_dst: object
    spill_slot: object
    spill_mask: object
    eattr_t: object
    mean_attr_t: object
    spill_eattr: object
    spill_src_b: object
    spill_dst_b: object
    spill_dst_local_b: object
    spill_eattr_b: object
    negmask_t: object
    spill_perm: object
    spill_row_ptr: object
    spill_perm_d: object
    spill_row_ptr_d: object
    band_perm: object
    band_row_ptr: object
    band_rows: int

    @property
    def num_bands(self) -> int:
        return self.loc_t.shape[1] // self.band_rows

    def spill_fraction(self, g) -> float:
        live = float(np.asarray(g.nbr_mask).sum())
        return float(np.asarray(self.spill_mask).sum()) / max(live, 1.0)

    def to(self, device) -> "BandedEll":
        """The same decomposition as torch tensors on ``device``."""
        return BandedEll(**{
            f.name: (getattr(self, f.name) if f.name == "band_rows" else
                     torch.as_tensor(getattr(self, f.name)).to(device))
            for f in dataclasses.fields(self)})


def band_ell(g, band_rows: int = 128, spill_pad: int = 512,
             s_max: Optional[int] = None, heads: int = 4) -> BandedEll:
    """Host-side band/spill split of an EllGraph (Morton-ordered nodes),
    as the JAX ``band_ell``. N must be a multiple of ``band_rows``.
    ``s_max`` forces the per-band spill-table width (else the smallest
    power of two >= 64 that holds the fullest band); ``heads`` is the
    head count ``negmask_t`` is repeated for."""
    src = np.asarray(g.nbr_src)          # [N, K]
    mask = np.asarray(g.nbr_mask, bool)
    n, k = src.shape
    r = int(band_rows)
    if n % r != 0:
        raise ValueError(f"N={n} not a multiple of band_rows={r}")

    dst_chunk = (np.arange(n) // r)[:, None]
    j = src // r - dst_chunk + 1
    in_band = mask & (j >= 0) & (j <= 2)
    loc = np.where(in_band, j * r + src % r, -1).astype(np.int32)

    sd, sk = np.nonzero(mask & ~in_band)
    s = len(sd)
    pad = max(int(spill_pad), 1)
    while pad < s:
        pad *= 2
    spill_src = np.zeros(pad, np.int32)
    spill_dst = np.zeros(pad, np.int32)
    spill_slot = np.zeros(pad, np.int32)
    spill_m = np.zeros(pad, bool)
    spill_src[:s] = src[sd, sk]
    spill_dst[:s] = sd
    spill_slot[:s] = sk
    spill_m[:s] = True

    eattr = np.asarray(g.edge_attr, np.float32)           # [N, K, Fe]
    fe = eattr.shape[-1]
    cnt = np.maximum(mask.sum(1), 1.0)
    mean_attr = (eattr * mask[..., None]).sum(1) / cnt[:, None]
    spill_eattr = np.zeros((pad, fe), np.float32)
    spill_eattr[:s] = eattr[sd, sk]

    # band-major compacted spill lists (sd is sorted, so each band's run
    # is contiguous)
    t_count = n // r
    band_of = sd // r
    counts = np.bincount(band_of, minlength=t_count)
    if s_max is None:
        s_max = 64
        while s_max < int(counts.max() if len(counts) else 1):
            s_max *= 2
    elif len(counts) and int(counts.max()) > s_max:
        raise ValueError(f"forced s_max={s_max} < max per-band spill "
                         f"count {int(counts.max())}")
    spill_src_b = np.zeros((t_count, s_max), np.int32)
    spill_dst_b = np.zeros((t_count, s_max), np.int32)
    spill_dst_local_b = np.full((t_count, 1, s_max), -1, np.int32)
    spill_eattr_b = np.zeros((t_count, s_max, fe), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos_in_band = np.arange(s) - starts[band_of]
    spill_src_b[band_of, pos_in_band] = src[sd, sk]
    spill_dst_b[band_of, pos_in_band] = sd
    spill_dst_local_b[band_of, 0, pos_in_band] = sd % r
    spill_eattr_b[band_of, pos_in_band] = eattr[sd, sk]

    live_sp = spill_dst_local_b.reshape(-1) >= 0
    spill_perm, spill_row_ptr = sorted_segments(spill_src_b, live_sp, n)
    spill_perm_d, spill_row_ptr_d = sorted_segments(spill_dst_b, live_sp, n)
    gsrc = (dst_chunk + loc // r - 1) * r + loc % r
    band_perm, band_row_ptr = sorted_segments(gsrc, loc >= 0, n)

    return BandedEll(
        loc_t=np.ascontiguousarray(loc.T),
        spill_src=spill_src, spill_dst=spill_dst, spill_slot=spill_slot,
        spill_mask=spill_m,
        eattr_t=np.ascontiguousarray(eattr.transpose(1, 2, 0)),
        mean_attr_t=np.ascontiguousarray(mean_attr.T.astype(np.float32)),
        spill_eattr=spill_eattr,
        spill_src_b=spill_src_b, spill_dst_b=spill_dst_b,
        spill_dst_local_b=spill_dst_local_b, spill_eattr_b=spill_eattr_b,
        negmask_t=np.repeat(np.where(loc.T < 0, np.float32(NEG_BIG),
                                     np.float32(0.0)), heads, axis=0),
        spill_perm=spill_perm, spill_row_ptr=spill_row_ptr,
        spill_perm_d=spill_perm_d, spill_row_ptr_d=spill_row_ptr_d,
        band_perm=band_perm, band_row_ptr=band_row_ptr,
        band_rows=r,
    )


def window_sources(loc_t: torch.Tensor, band_rows: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(src, valid), both [K, N]: the global source of each slot's local
    window index (chunk i // R + loc // R - 1, row loc % R; 0 where not
    valid) and whether it has one (loc in [0, 3R) and the chunk inside the
    graph, as every slot that ``band_ell`` marks in-band)."""
    k, n = loc_t.shape
    r = band_rows
    loc = torch.as_tensor(loc_t).long()
    chunk = (torch.arange(n, device=loc.device)[None, :] // r
             + torch.div(loc, r, rounding_mode="floor") - 1)
    valid = (loc >= 0) & (loc < 3 * r) & (chunk >= 0) & (chunk < n // r)
    return torch.where(valid, chunk * r + loc % r, torch.zeros_like(loc)), \
        valid


def banded_window_source(banded: BandedEll) -> torch.Tensor:
    """[K, N] global source index each in-band slot refers to (0 for dead
    or spilled slots)."""
    return window_sources(banded.loc_t, banded.band_rows)[0]


def leaky_relu(v: torch.Tensor, slope: float) -> torch.Tensor:
    """LeakyReLU as the JAX package writes it (slope 1 at 0)."""
    return torch.where(v >= 0, v, slope * v)


def banded_gat_band_part_xla(xh, a_src, a_dst, el_e, el_self,
                             banded: BandedEll,
                             negative_slope: float = 0.2
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The band part of the layer in plain PyTorch. xh [N, H, C]; a_src,
    a_dst [N, H]; el_e [N, K, H] raw edge-attribute logits (dead slots are
    masked from loc); el_self [N, H] or None (no self loop). Returns
    (y_band [N, H, C] normalized over the in-band slots and the self loop,
    m [N, H], denom [N, H])."""
    loc = torch.as_tensor(banded.loc_t)
    in_band = (loc >= 0).T                                   # [N, K]
    gsrc = banded_window_source(banded).T.long()             # [N, K]
    n, k = gsrc.shape
    logits = el_e + a_dst[:, None, :] + a_src[gsrc.reshape(-1)].reshape(
        n, k, -1)
    logits = leaky_relu(logits, negative_slope)
    logits = torch.where(in_band[..., None], logits,
                         torch.full_like(logits, NEG_BIG))
    m = logits.max(dim=1).values
    if el_self is not None:
        self_logit = leaky_relu(a_src + a_dst + el_self, negative_slope)
        m = torch.maximum(m, self_logit)
    else:
        # all-masked rows: keep m finite (see the spill-pass renorm)
        m = m.clamp_min(-1e4)
    e = torch.exp(logits - m[:, None, :])
    e = torch.where(in_band[..., None], e, torch.zeros_like(e))
    denom = e.sum(1)
    if el_self is not None:
        e_self = torch.exp(self_logit - m)
        denom = denom + e_self
    denom = denom.clamp_min(1e-16)
    w_in = e / denom[:, None, :]
    nbr_x = xh[gsrc.reshape(-1)].reshape((n, k) + xh.shape[1:])
    y = (nbr_x * w_in[..., None]).sum(1)
    if el_self is not None:
        y = y + xh * (e_self / denom)[..., None]
    return y, m, denom


def banded_gat_spill_pass(y_band, m, denom, xh, a_src, a_dst, m_edge,
                          banded: BandedEll,
                          negative_slope: float = 0.2) -> torch.Tensor:
    """Fold the spilled edges into the band result exactly by
    renormalization: y = (y_band D + sum_s e_s xh_s) / (D + sum_s e_s),
    e_s = exp(min(l_s - m, 60)). Shapes as ``banded_gat_band_part_xla``;
    m_edge [Fe, H] or None (no edge features)."""
    s_src = torch.as_tensor(banded.spill_src).long()
    s_dst = torch.as_tensor(banded.spill_dst).long()
    logit = a_src[s_src] + a_dst[s_dst]
    if m_edge is not None:
        logit = logit + torch.as_tensor(banded.spill_eattr) @ m_edge
    logit = leaky_relu(logit, negative_slope)
    e_s = torch.exp(torch.clamp_max(logit - m[s_dst], 60.0))
    live = torch.as_tensor(banded.spill_mask)[:, None]
    e_s = torch.where(live, e_s, torch.zeros_like(e_s))      # [S, H]
    msg = xh[s_src] * e_s[..., None]                         # [S, H, C]
    n = xh.shape[0]
    sum_e = torch.zeros(n, e_s.shape[1], dtype=e_s.dtype,
                        device=e_s.device).index_add_(0, s_dst, e_s)
    sum_msg = torch.zeros((n,) + msg.shape[1:], dtype=msg.dtype,
                          device=msg.device).index_add_(0, s_dst, msg)
    return (y_band * denom[..., None] + sum_msg) / (denom + sum_e)[..., None]


def banded_gat_spill_pass_flat(y2, m, denom, xh2, ac, m_edge,
                               banded: BandedEll, heads: int,
                               negative_slope: float = 0.2) -> torch.Tensor:
    """The spill fold on flat arrays (the same math as
    ``banded_gat_spill_pass``), completing kernel E: y2 [N, HC] the
    UNNORMALIZED band sums, m and denom [N, H], xh2 [N, HC], ac [N, 2H]
    ([a_src | a_dst]). Returns the normalized layer output [N, HC]."""
    n, hc = xh2.shape
    c = hc // heads
    s_src = torch.as_tensor(banded.spill_src).long()
    s_dst = torch.as_tensor(banded.spill_dst).long()
    logit = ac[s_src, :heads] + ac[s_dst, heads:]
    if m_edge is not None:
        logit = logit + torch.as_tensor(banded.spill_eattr) @ m_edge
    logit = leaky_relu(logit, negative_slope)
    e_s = torch.exp(torch.clamp_max(logit - m[s_dst], 60.0))
    live = torch.as_tensor(banded.spill_mask)[:, None]
    e_s = torch.where(live, e_s, torch.zeros_like(e_s))      # [S, H]
    msg2 = xh2[s_src] * e_s.repeat_interleave(c, dim=1)      # [S, HC]
    sum_e = torch.zeros(n, heads, dtype=e_s.dtype,
                        device=e_s.device).index_add_(0, s_dst, e_s)
    sum_msg2 = torch.zeros(n, hc, dtype=msg2.dtype,
                           device=msg2.device).index_add_(0, s_dst, msg2)
    return (y2 + sum_msg2) / (denom + sum_e).repeat_interleave(c, dim=1)


class _GatherRowsReduceBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, perm, row_ptr):
        ctx.save_for_backward(perm, row_ptr)
        ctx.n = table.shape[0]
        ctx.dtype = table.dtype
        return table.index_select(0, idx.long())

    @staticmethod
    def backward(ctx, ct):
        perm, row_ptr = ctx.saved_tensors
        # ct keeps its dtype (bf16 for a bf16 table): kernel F reads it
        # and sums in f32; the result takes the table's dtype, as JAX's
        d_table = segment_reduce.segment_reduce_sorted(
            ct.contiguous(), perm, row_ptr, ctx.n)
        return d_table.to(ctx.dtype), None, None, None


def gather_rows_reduce_bwd(table: torch.Tensor, idx: torch.Tensor,
                           perm: torch.Tensor,
                           row_ptr: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (a row gather, table [N, F], idx [S]) whose backward
    sums the cotangent rows into their table rows over the sorted tables
    (perm, row_ptr) of ``idx`` (``BandedEll.spill_perm`` /
    ``spill_row_ptr`` or the destination pair): kernel F mode (a) on the
    card, ``index_add_`` on the CPU, never a scatter-add with atomics.
    Entries that the tables leave out (dead spills) get no gradient."""
    return _GatherRowsReduceBwd.apply(table, idx, perm, row_ptr)
