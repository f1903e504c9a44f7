"""KV slot pool: one shared cache tree, S decode slots, per-slot positions
(the dense half of ``repro.serving.slots``).

``write_slot`` merges a single-request cache leaf (batch 1) into the pool
leaf at a slot by finding the batch axis structurally — the axis where the
pool is slot-sized and the single-request leaf is 1 — and copies it there
in place, where the reference rebuilds the pool array.  The pool's "index"
leaf is a (slots,) int32 vector of per-slot absolute positions.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import LM


def _pad_to_pool(pool, one):
    """Zero-pad ``one`` up to the pool's size on every non-batch axis (the
    batch axis is the one where one == 1 and the pool differs)."""
    if pool.dim() != one.dim():
        return one
    batch_ax = next((ax for ax in range(pool.dim())
                     if one.shape[ax] == 1 and pool.shape[ax] != 1), None)
    pad = []
    for ax in reversed(range(pool.dim())):      # F.pad lists the last axis first
        short = pool.shape[ax] - one.shape[ax]
        pad += [0, short if ax != batch_ax and short > 0 else 0]
    return F.pad(one, pad) if any(pad) else one


def write_slot(pool, one, slot: int):
    """Copy one batch-1 cache leaf into the pool leaf at ``slot``, in place;
    returns the pool leaf.  Identical shapes (a 1-slot pool) overwrite the
    whole leaf."""
    if pool.dim() == 0:
        pool.copy_(torch.maximum(pool, one.to(pool.dtype)))
        return pool
    one = _pad_to_pool(pool, one)
    if pool.shape == one.shape:
        pool.copy_(one)
        return pool
    for ax in range(pool.dim()):
        if one.shape[ax] == 1 and pool.shape[ax] != one.shape[ax]:
            pool.narrow(ax, slot, 1).copy_(one)
            return pool
    return pool


def _write_tree(pool, one, slot: int):
    for key, leaf in pool.items():
        if isinstance(leaf, dict):
            _write_tree(leaf, one[key], slot)
        else:
            write_slot(leaf, one[key], slot)


class SlotPool:
    """The engine's shared decode cache with slot-granular writes."""

    def __init__(self, cfg, slots: int, max_seq: int, device="cuda"):
        device = resolve_device(device)
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.cache = LM.init_cache(cfg, slots, max_seq, device=device)
        # per-slot absolute positions replace the scalar index leaf
        self.cache["index"] = torch.zeros(slots, dtype=torch.int32,
                                          device=device)

    @property
    def index(self) -> torch.Tensor:
        return self.cache["index"]

    def write(self, one, slot: int, *, index=None):
        """Write a batch-1 cache tree (from prefill) into ``slot``; the
        slot's position is set to ``index`` (default: the one-cache's own)."""
        _write_tree({k: v for k, v in self.cache.items() if k != "index"},
                    one, slot)
        self.set_slot_index(slot, one["index"] if index is None else index)

    def set_index(self, values):
        self.cache["index"] = torch.tensor(values, dtype=torch.int32,
                                           device=self.cache["index"].device)

    def set_slot_index(self, slot: int, pos):
        self.cache["index"][slot] = int(pos)


def make_pool(cfg, slots: int, max_seq: int, *, pool: str = "dense",
              device="cuda"):
    """Pool factory: ``pool`` ∈ {"dense", "paged"}."""
    if pool == "paged":
        raise NotImplementedError("the paged pool waits for slice B2 of the "
                                  "port")
    if pool != "dense":
        raise ValueError(f"unknown pool {pool!r}")
    return SlotPool(cfg, slots, max_seq, device=device)
