"""AdamW (decoupled weight decay) and SGD as init/update pairs over dicts of
tensors (``repro.optim.adamw``).

The reference's defaults, not ``torch.optim.AdamW``'s: ``b2 = 0.95``,
``weight_decay = 0.1``, decay only on leaves with ``ndim >= 2`` (matrices),
and the decay term inside the learning-rate product:
``p ← p − lr · (m̂ / (√v̂ + eps) + wd · p)``.  Moments stay float32 whatever
the parameters' dtype; the update is cast back to it.

Over a mesh, parameters and moments are ``sharding.ShardedArray`` leaves
and gradients per-position blocks: ``global_norm_blocks`` counts each
distinct block once, and ``update_blocks`` runs an update on each distinct
block in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.sharding import shard_map as sm


class AdamWState(NamedTuple):
    step: int
    mu: dict         # like params (float32)
    nu: dict         # like params (float32)


def global_norm(tree: dict) -> torch.Tensor:
    return torch.sqrt(sum(x.float().square().sum() for x in tree.values()))


def _owns(mesh, pos, spec) -> bool:
    """Whether ``pos`` is rank 0 along every mesh axis ``spec`` leaves its
    leaf replicated on: one position of each distinct block."""
    return sm.axis_index(mesh, pos, sm.replicated_axes(spec, mesh)) == 0


def global_norm_blocks(grads: dict, specs: dict, mesh) -> dict:
    """The global norm of gradients held as {name: {position: block}},
    laid out by ``specs`` {name: spec}: each position sums the squares of
    the blocks it owns (``_owns``), so a block replicated over an axis
    counts once, not once a replica; one psum over the mesh → {position:
    norm}."""
    sq = {pos: sum((g[pos].float().square().sum() for k, g in grads.items()
                    if _owns(mesh, pos, specs[k])),
                   torch.zeros((), device=mesh.devices[pos]))
          for pos in sm.positions(mesh)}
    sq = sm.psum(sq, mesh.axis_names, mesh)
    return {p: torch.sqrt(t) for p, t in sq.items()}


@torch.no_grad()
def update_blocks(update, grads: dict, state: AdamWState, params: dict,
                  scale: dict) -> AdamWState:
    """``update`` (an ``adamw`` update) over sharded leaves: ``params`` and
    the moments {name: ``ShardedArray``} laid out alike, ``grads`` {name:
    {position: block}}, ``scale`` {position: the clipping factor}.  Each
    distinct block is updated once, in place (positions holding one block
    on one device share it); the moments are written in place too."""
    for k, leaf in params.items():
        seen: set = set()
        for pos, p in leaf.blocks.items():
            if id(p) in seen:
                continue
            seen.add(id(p))
            g = grads[k][pos]
            g = (g.float() * scale[pos]).to(g.dtype)
            mu, nu = state.mu[k].blocks[pos], state.nu[k].blocks[pos]
            upd, new = update({k: g}, AdamWState(state.step, {k: mu},
                                                 {k: nu}), {k: p})
            mu.copy_(new.mu[k])
            nu.copy_(new.nu[k])
            p.add_(upd[k].to(p.dtype))
    return AdamWState(state.step + 1, state.mu, state.nu)


def clip_by_global_norm(tree: dict, max_norm: float):
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in tree.items()}, norm


def adamw(lr, *, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1, mask: dict | None = None):
    """lr: float or callable(step) -> float.  mask: {name: bool}, or a
    callable (name, param) -> bool, True where weight decay applies
    (default: leaves with ndim >= 2)."""

    def decays(k, p) -> bool:
        if mask is None:
            return p.ndim >= 2
        return mask(k, p) if callable(mask) else mask[k]

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
            if decays(k, p):
                u = u + weight_decay * p.float()
            updates[k] = (-lr_t * u).to(p.dtype)
            mu[k], nu[k] = m, v
        return updates, AdamWState(step=step, mu=mu, nu=nu)

    return init, update


def sgd(lr, *, momentum: float = 0.0):
    """Plain SGD, with a float32 momentum buffer when ``momentum`` is set.
    State: {"step": int[, "mom": like params]}."""

    def init(params: dict) -> dict:
        if momentum:
            return {"step": 0, "mom": {k: torch.zeros_like(
                p, dtype=torch.float32) for k, p in params.items()}}
        return {"step": 0}

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict):
        lr_t = lr(state["step"] + 1) if callable(lr) else lr
        step = state["step"] + 1
        if momentum:
            mom = {k: momentum * state["mom"][k] + grads[k].float()
                   for k in params}
            updates = {k: (-lr_t * mom[k]).to(p.dtype)
                       for k, p in params.items()}
            return updates, {"step": step, "mom": mom}
        updates = {k: (-lr_t * grads[k]).to(p.dtype)
                   for k, p in params.items()}
        return updates, {"step": step}

    return init, update


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}
