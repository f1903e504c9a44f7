"""AdamW (decoupled weight decay) as an init/update pair over dicts of
tensors (``repro.optim.adamw``).

The reference's defaults, not ``torch.optim.AdamW``'s: ``b2 = 0.95``,
``weight_decay = 0.1``, decay only on leaves with ``ndim >= 2`` (matrices),
and the decay term inside the learning-rate product:
``p ← p − lr · (m̂ / (√v̂ + eps) + wd · p)``.  Moments stay float32 whatever
the parameters' dtype; the update is cast back to it.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class AdamWState(NamedTuple):
    step: int
    mu: dict         # like params (float32)
    nu: dict         # like params (float32)


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tree.values()))


def clip_by_global_norm(tree: dict, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in tree.items()}, norm


def adamw(lr, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, mask: dict | None = None):
    """lr: float or callable(step) -> float.  mask: {name: bool}, True where
    weight decay applies (default: leaves with ndim >= 2)."""

    def init(params: dict) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
        return AdamWState(step=0, mu={k: zeros(p) for k, p in params.items()},
                          nu={k: zeros(p) for k, p in params.items()})

    @torch.no_grad()
    def update(grads: dict, state: AdamWState, params: dict):
        step = state.step + 1
        lr_t = lr(step) if callable(lr) else lr
        c1, c2 = 1 - b1 ** step, 1 - b2 ** step
        updates, mu, nu = {}, {}, {}
        for k, p in params.items():
            g = grads[k].float()
            m = b1 * state.mu[k] + (1 - b1) * g
            v = b2 * state.nu[k] + (1 - b2) * g.square()
            u = (m / c1) / (torch.sqrt(v / c2) + eps)
            if (mask[k] if mask is not None else p.ndim >= 2):
                u = u + weight_decay * p.float()
            updates[k] = (-lr_t * u).to(p.dtype)
            mu[k], nu[k] = m, v
        return updates, AdamWState(step=step, mu=mu, nu=nu)

    return init, update


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}
