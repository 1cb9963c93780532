"""Gradient clipping and AdamW with optax's semantics, with no host sync.

The JAX trainers use ``optax.chain(clip_by_global_norm(max_norm),
inject_hyperparams(adamw)(learning_rate, weight_decay))``. torch's own
versions differ: ``clip_grad_norm_`` scales by max_norm / (norm + 1e-6)
whenever it is called, and ``torch.optim.AdamW`` decays the weights
before the Adam step (p *= 1 - lr * wd) where optax adds wd * p to the
update. These follow optax exactly:

- clip: g unchanged if ||g|| < max_norm, else (g / ||g||) * max_norm, with
  ||g|| the global L2 norm over all leaves;
- AdamW: mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu, count += 1,
  u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count) + eps_root) + eps)
  + wd * p, p += -lr * u, for every parameter (no mask), with the
  learning rate passed to each step (``inject_hyperparams``).

Both are sync-free: nothing in them copies between host and device or
waits for the card, so the host goes on queueing while the card works.
They run as ``torch._foreach_*`` ops over the leaves grouped by device
and dtype: a fixed number of multi-tensor launches a group, whatever the
number of leaves, each op one rounding of the formulas above, in their
order. The clip's norm (each leaf's squares summed in f64) and its
decision stay on the device (masked fills give the divisor and the
factor); AdamW's bias corrections are f32 values computed on the host
and filled into device scalars (a fill, not a copy). A leaf whose
gradient is laid out unlike its parameter goes alone, through the same
ops. While a profiler session runs, ``utils/prof.TRACER`` counts the
leaves AdamW steps each way (``optim.multi_tensor_leaves``,
``optim.per_leaf_leaves``).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from ..utils import prof

F32 = torch.float32


def _cast(ts: List[torch.Tensor], dtype: torch.dtype) -> List[torch.Tensor]:
    """``ts`` in ``dtype``: themselves when they are, else new tensors
    filled by one multi-tensor copy."""
    if all(t.dtype == dtype for t in ts):
        return ts
    out = [torch.empty_like(t, dtype=dtype) for t in ts]
    torch._foreach_copy_(out, ts)
    return out


def _groups(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor]
            ) -> Tuple[List[List[int]], int]:
    """The leaves' indices in the lists the multi-tensor ops take, grouped
    by their parameter's device and dtype, and how many leaves went alone,
    each in a list of its own: those whose gradient is not laid out as
    their parameter (the kernels take lists of equal strides)."""
    groups: Dict[Tuple, List[int]] = {}
    alone = []
    for i, (p, g) in enumerate(zip(params, grads)):
        if g.layout != torch.strided or g.stride() != p.stride():
            alone.append([i])
        else:
            groups.setdefault((p.device, p.dtype), []).append(i)
    return list(groups.values()) + alone, len(alone)


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Clip ``grads`` in place as ``optax.clip_by_global_norm``; returns the
    global norm before clipping, a device tensor (no host sync)."""
    grads = list(grads)
    groups = _groups(grads, grads)[0]
    norms = []
    for idx in groups:
        # each leaf's squares summed in f64: the f32 norm comes out
        # within half an ulp of the exact one, whatever the sums' order
        norms += torch._foreach_norm([grads[i] for i in idx], 2,
                                     dtype=torch.float64)
    norm = torch.linalg.vector_norm(torch.stack(norms)).to(F32)
    keep = norm < max_norm
    # (g / norm) * max_norm in two roundings, as optax; a kept g is
    # divided and multiplied by 1 (no NaN at norm 0). Both factors are
    # filled on the device, so no host scalar is copied there
    div = norm.masked_fill(keep, 1.0)
    mul = torch.full_like(norm, max_norm).masked_fill_(keep, 1.0)
    for idx in groups:
        gs = [grads[i] for i in idx]
        torch._foreach_div_(gs, div.to(gs[0].dtype))   # in g's dtype
        torch._foreach_mul_(gs, mul)
    return norm


class AdamW:
    """``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) over a list
    of parameters, f32 moments (``mu``, ``nu``: a tensor a leaf, in the
    parameters' order)."""

    def __init__(self, params: Sequence[torch.Tensor],
                 weight_decay: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0):
        self.params: List[torch.Tensor] = list(params)
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.mu = [torch.zeros_like(p, dtype=F32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=F32) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        self.count += 1
        bc1 = (1 - torch.tensor(self.b1, dtype=F32) ** self.count).item()
        bc2 = (1 - torch.tensor(self.b2, dtype=F32) ** self.count).item()
        grads = list(grads)
        groups, alone = _groups(self.params, grads)
        for idx in groups:
            self._update(idx, grads, bc1, bc2, lr)
        prof.TRACER.count("optim.multi_tensor_leaves",
                          len(self.params) - alone)
        prof.TRACER.count("optim.per_leaf_leaves", alone)

    def _update(self, idx: List[int], grads: List[torch.Tensor],
                bc1: float, bc2: float, lr: float) -> None:
        """The step of the leaves ``idx``, one foreach op a rounding."""
        ps = [self.params[i] for i in idx]
        mu = [self.mu[i] for i in idx]
        nu = [self.nu[i] for i in idx]
        g = _cast([grads[i] for i in idx], F32)
        t = torch._foreach_mul(g, 1 - self.b1)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, t)
        t = torch._foreach_mul(g, g)
        torch._foreach_mul_(t, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, t)
        # a divisor on the device: the CUDA foreach division by a host
        # scalar multiplies by its reciprocal, one rounding more
        dev = mu[0].device
        u = torch._foreach_div(mu, torch.full((), bc1, dtype=F32, device=dev))
        v = torch._foreach_div(nu, torch.full((), bc2, dtype=F32, device=dev))
        torch._foreach_add_(v, self.eps_root)
        torch._foreach_sqrt_(v)
        torch._foreach_add_(v, self.eps)
        torch._foreach_div_(u, v)
        torch._foreach_add_(
            u, _cast(torch._foreach_mul(ps, self.weight_decay), F32))
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(ps, _cast(u, ps[0].dtype))

    def state_dict(self) -> Dict:
        return {"mu": [t.cpu() for t in self.mu],
                "nu": [t.cpu() for t in self.nu], "count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            dst.copy_(src)
        self.count = int(state["count"])


class SGD:
    """``optax.sgd`` (no momentum) over a list of parameters: p += -lr * g,
    with the learning rate passed to each step. With a clip norm no
    gradient reaches, a parameter's change is -lr times its gradient,
    which the sharded steps' parity tests read as the gradient."""

    def __init__(self, params: Sequence[torch.Tensor]):
        self.params: List[torch.Tensor] = list(params)
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        self.count += 1
        for p, g in zip(self.params, grads):
            p.add_((g.to(torch.float32) * -lr).to(p.dtype))

    def state_dict(self) -> Dict:
        return {"count": self.count}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
