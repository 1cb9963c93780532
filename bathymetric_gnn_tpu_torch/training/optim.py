"""Gradient clipping and AdamW with optax's semantics.

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
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch


@torch.no_grad()
def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Clip ``grads`` in place as ``optax.clip_by_global_norm``; returns the
    global norm before clipping. Stays on the device (no host sync)."""
    norm = torch.sqrt(sum(g.to(torch.float32).square().sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm))
    return norm


class AdamW:
    """``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) over a list
    of parameters, f32 moments."""

    def __init__(self, params: Sequence[torch.Tensor],
                 weight_decay: float = 1e-4, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8, eps_root: float = 0.0):
        self.params: List[torch.Tensor] = list(params)
        self.weight_decay = weight_decay
        self.b1, self.b2, self.eps, self.eps_root = b1, b2, eps, eps_root
        self.mu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        self.count += 1
        f32 = torch.float32
        bc1 = 1 - torch.tensor(self.b1, dtype=f32) ** self.count
        bc2 = 1 - torch.tensor(self.b2, dtype=f32) ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = g.to(f32)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * g.square() + self.b2 * nu)
            u = (mu / bc1.to(mu.device)) / (
                torch.sqrt(nu / bc2.to(nu.device) + self.eps_root)
                + self.eps)
            u = u + self.weight_decay * p
            p.add_((u * -lr).to(p.dtype))

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
