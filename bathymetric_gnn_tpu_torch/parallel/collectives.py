"""Differentiable collectives of the port's sharded paths (``torch.distributed``).

The JAX package gets these from ``jax.lax.psum`` and ``jax.lax.ppermute``
under ``shard_map``, whose transposes autodiff derives:

- ``all_reduce_sum``: psum; its backward is again an all-reduce sum (the
  transpose of psum), which the exact sharded steps rely on
  (``parallel/data_parallel.py``, ``parallel/halo.py``);
- ``halo_rows_split`` / ``exchange_halo_rows``: the neighbour exchange of
  boundary rows along a chain of ranks (ppermute to r + 1 and r - 1);
  its backward sends each received row's gradient back to its owner,
  which adds it onto the boundary rows it sent (the transpose of
  ppermute). ``HaloExchange`` issues the exchange without waiting, so
  that work with no halo dependency runs while it is in flight;
- ``all_gather_rows``: the sharded forwards' outputs, concatenated on
  every rank (no gradient).

Transport. On an NCCL group the tensors move from the card as they are,
on NCCL's own stream. On a gloo group the point-to-point ops and the
gathers take only host tensors, so these functions copy the rows they send
to the host and the rows they receive back to the tensor's device, on
that group only; the compute stays where it was. A group of one rank, or
a rank with no neighbour, makes no call at all.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]
Groups = Union[Group, Sequence[Group]]


def _staged(group: Group, t: torch.Tensor) -> bool:
    """True where ``t`` must go through the host: a device tensor on a
    gloo group (see the module docstring)."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


def _all_reduce_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """In-place sum of ``t`` over ``group`` (through the host on gloo)."""
    if _staged(group, t):
        h = t.cpu()
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.contiguous().clone(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, groups: Groups) -> torch.Tensor:
    """psum over ``groups`` (one group, or several summed in turn, as
    ``jax.lax.psum`` over a tuple of axes); differentiable, its backward
    the same sum of the cotangents."""
    if groups is None or isinstance(groups, dist.ProcessGroup):
        groups = (groups,)
    for g in groups:
        x = _AllReduceSum.apply(x, g)
    return x


def all_reduce_mean_(tensors: Sequence[torch.Tensor], group: Group) -> None:
    """pmean in place of each tensor (no gradient): one all-reduce of the
    tensors flattened into one buffer."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    _all_reduce_(flat, group)
    flat /= dist.get_world_size(group)
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def all_gather_rows(x: torch.Tensor, group: Group,
                    dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along ``dim`` in
    rank order, on every rank (no gradient)."""
    n = dist.get_world_size(group)
    if n == 1:
        return x
    src = x.contiguous()
    staged = _staged(group, src)
    if staged:
        src = src.cpu()
    if src.dtype == torch.bool:
        src = src.to(torch.uint8)
    outs = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(outs, src, group=group)
    out = torch.cat(outs, dim=dim)
    return out.to(x.device, x.dtype)


class HaloExchange:
    """One boundary-row exchange in flight: rank r's last ``halo`` rows
    (along ``dim``) to r + 1 and its first ``halo`` rows to r - 1, the
    neighbours' rows into (from_above, from_below). ``wait`` returns them
    (zeros where there is no neighbour), differentiable in ``x``."""

    def __init__(self, x: torch.Tensor, halo: int, group: Group,
                 dim: int = 0):
        if x.shape[dim] < halo:
            raise ValueError(f"{x.shape[dim]} rows along dim {dim} < halo "
                             f"{halo}")
        self.x, self.halo, self.group, self.dim = x, halo, group, dim
        self.n, self.r = dist.get_world_size(group), dist.get_rank(group)
        xd = x.detach()
        self.works, self.bufs = _issue(
            [(xd.narrow(dim, xd.shape[dim] - halo, halo), self.r + 1),
             (xd.narrow(dim, 0, halo), self.r - 1)],
            group, self.n, self.r)

    def wait(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return _HaloRows.apply(self.x, self)


def _issue(sends, group: Group, n: int, r: int):
    """Post, without waiting, the sends [(rows, to rank)] and the receives
    of the same shapes from the same ranks (send to r + 1 pairs with the
    receive from r + 1); ranks outside [0, n) are skipped. Returns (works,
    receive buffers by peer)."""
    ops, bufs = [], {}
    for rows, peer in sends:
        if not 0 <= peer < n:
            continue
        rows = rows.contiguous()
        if _staged(group, rows):
            rows = rows.cpu()
        if rows.dtype == torch.bool:
            rows = rows.to(torch.uint8)
        buf = torch.empty_like(rows)
        gpeer = dist.get_global_rank(group, peer) if group is not None \
            else peer
        ops += [dist.P2POp(dist.isend, rows, gpeer, group),
                dist.P2POp(dist.irecv, buf, gpeer, group)]
        bufs[peer] = buf
    # batch_isend_irecv([]) raises: with no neighbour, no call at all
    works = dist.batch_isend_irecv(ops) if ops else []
    return works, bufs


def _landed(bufs, peer, like: torch.Tensor) -> torch.Tensor:
    """The rows received from ``peer`` (zeros of ``like``'s shape where
    there is none), on ``like``'s device and dtype."""
    if peer not in bufs:
        return torch.zeros_like(like)
    return bufs[peer].to(like.device, like.dtype)


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ex: HaloExchange):
        for w in ex.works:
            w.wait()
        like = x.narrow(ex.dim, 0, ex.halo)
        ctx.ex = ex
        ctx.shape = x.shape
        return (_landed(ex.bufs, ex.r - 1, like),
                _landed(ex.bufs, ex.r + 1, like))

    @staticmethod
    def backward(ctx, g_above, g_below):
        ex = ctx.ex
        ex.x = None
        # from_above came from r - 1's last rows: its gradient goes back
        # to r - 1; from_below's to r + 1. What r receives adds onto its
        # own boundary rows: from r + 1 onto the last rows, from r - 1
        # onto the first.
        works, bufs = _issue([(g_above, ex.r - 1), (g_below, ex.r + 1)],
                             ex.group, ex.n, ex.r)
        for w in works:
            w.wait()
        dx = torch.zeros(ctx.shape, dtype=g_above.dtype,
                         device=g_above.device)
        h, d, L = ex.halo, ex.dim, ctx.shape[ex.dim]
        if ex.r + 1 in bufs:
            dx.narrow(d, L - h, h).add_(_landed(bufs, ex.r + 1,
                                                g_below))
        if ex.r - 1 in bufs:
            dx.narrow(d, 0, h).add_(_landed(bufs, ex.r - 1,
                                            g_above))
        return dx, None


def halo_rows_split(x: torch.Tensor, halo: int, group: Group,
                    dim: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Neighbour boundary rows (from_above, from_below), each ``halo``
    rows along ``dim``: rank r receives r - 1's last rows and r + 1's
    first rows; a missing neighbour (the global border) gives zeros."""
    return HaloExchange(x, halo, group, dim).wait()


def exchange_halo_rows(x: torch.Tensor, halo: int, group: Group,
                       dim: int = 0) -> torch.Tensor:
    """``x`` [L, ...] extended to [L + 2 * halo, ...] along ``dim`` with
    the neighbours' rows (zeros at the global border)."""
    fa, fb = halo_rows_split(x, halo, group, dim)
    return torch.cat([fa, x, fb], dim=dim)
