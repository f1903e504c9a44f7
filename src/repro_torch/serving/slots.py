"""KV slot pool: one shared cache tree, S decode slots, per-slot positions
(``repro.serving.slots``).

``write_slot`` merges a single-request cache leaf (batch 1) into the pool
leaf at a slot by finding the batch axis structurally — the axis where the
pool is slot-sized and the single-request leaf is 1 — and copies it there
in place, where the reference rebuilds the pool array.  The pool's "index"
leaf is a (slots,) int32 vector of per-slot absolute positions.

``PagedSlotPool`` replaces the dense per-slot ring with a block-table pool:
every *pageable* cache leaf (logical "cache_seq" axis sized max_seq — i.e.
full-attention K/V) is re-laid as (A, NB, block, KV, hd) physical blocks
shared by all slots, a (slots, nk) "block_tbl" cache entry names each
slot's blocks, and blocks are refcounted with prefix sharing: admission of
a prompt whose block-aligned prefix is already resident maps the shared
blocks read-only and skips that part of prefill entirely.  The allocator
runs on the host, as in the reference; its edits of the device tree are
in-place copies (``index_copy_`` over the block axis, block-to-block
copies, table-row copies) where the reference rebuilds the arrays.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models import LM


def _pad_to_pool(pool, one):
    """Zero-pad ``one`` up to the pool's size on every non-batch axis (the
    batch axis is the one where one == 1 and the pool differs).  An
    enc-dec prefill's cross K/V, (L, 1, S_enc, KV, hd), meet a max_seq-long
    pool: the pad rows lie past the row's cross_len, which decode masks, so
    zeros are exact."""
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


# ---------------------------------------------------------------------------
# paged pool: block-granular allocation + refcounted prefix sharing
# ---------------------------------------------------------------------------


def _map_tree(fn, tree, *rest):
    """fn over the leaves of nested dicts of equal structure (a cache tree,
    or a spec tree whose leaves are (shape, dtype, axes) tuples)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _tree_leaves(v)]
    return [tree]


def _pageable(shape, axes, max_seq: int) -> bool:
    """A leaf pages iff it has a logical "cache_seq" axis sized max_seq —
    full-attention K/V.  A sliding-window ring (cache_seq == window <
    max_seq) is already bounded and wraps, so it stays dense."""
    return "cache_seq" in axes and shape[axes.index("cache_seq")] == max_seq


def paged_cache_spec(cfg, slots: int, max_seq: int, *, block_size: int,
                     num_blocks: int):
    """LM.cache_spec with pageable leaves re-laid as block pools.

    Pageable (A, slots, max_seq, KV, hd) leaves become
    (A, num_blocks, block_size, KV, hd) with logical axes
    ("layers", "cache_blocks", None, "kv_heads", None).  Adds the
    (slots, nk) int32 "block_tbl" leaf when any leaf pages."""
    if max_seq % block_size:
        raise ValueError(f"block_size={block_size} must divide "
                         f"max_seq={max_seq}")
    nk = max_seq // block_size

    def one(leaf):
        shape, dtype, axes = leaf
        if not _pageable(shape, axes, max_seq):
            return leaf
        b_ax, s_ax = axes.index("batch"), axes.index("cache_seq")
        if s_ax != b_ax + 1:
            raise ValueError(f"pageable leaf axes {axes}: cache_seq must "
                             f"follow batch")
        return (shape[:b_ax] + (num_blocks, block_size) + shape[s_ax + 1:],
                dtype, axes[:b_ax] + ("cache_blocks", None) + axes[s_ax + 1:])

    base = LM.cache_spec(cfg, slots, max_seq)
    spec = _map_tree(one, base)
    spec["index"] = ((slots,), torch.int32, ("batch",))
    if any(_pageable(s, ax, max_seq) for s, _, ax in _tree_leaves(base)):
        spec["block_tbl"] = ((slots, nk), torch.int32, ("batch", None))
    return spec


def pool_geometry(slots: int, max_seq: int, *, block_size: int | None = None,
                  num_blocks: int | None = None,
                  partitions: int = 1) -> tuple[int, int]:
    """Resolve (block_size, num_blocks): the default block is the largest
    divisor of max_seq <= 8 (max_seq=12 → 6), the default pool holds every
    slot at max_seq plus one trash block per partition."""
    if block_size is None:
        bk = next(d for d in range(min(8, max_seq), 0, -1)
                  if max_seq % d == 0)
    else:
        bk = block_size
        if max_seq % bk != 0:
            raise ValueError(
                f"block_size={bk} must divide max_seq={max_seq} "
                f"(pass a block_size that divides max_seq, or omit it)")
    if slots % partitions:
        raise ValueError(f"{partitions} partitions do not divide {slots} "
                         f"slots")
    nk = max_seq // bk
    if num_blocks is None:
        num_blocks = partitions * (slots // partitions * nk + 1)
    if num_blocks % partitions:
        raise ValueError(f"{partitions} partitions do not divide "
                         f"{num_blocks} blocks")
    return bk, num_blocks


def _prefix_key(prompt: np.ndarray, n: int, extra: bytes = b"") -> bytes:
    """Content hash of the first ``n`` prompt tokens — the prefix registry
    key (O(1) in size however long the shared prompt).  ``extra`` is mixed
    in for families whose prefix K/V depends on more than the token ids (a
    VLM's patches): two prompts with the same ids and different extra
    bytes never alias."""
    return hashlib.sha1(
        extra + np.ascontiguousarray(prompt[:n], dtype=np.int64).tobytes()
    ).digest()


class PagedSlotPool(SlotPool):
    """Block-table pool: pageable K/V leaves live in a shared physical block
    pool; each slot's (nk,) table row names its blocks; blocks are
    refcounted and prompt prefixes are shared copy-on-write.

    Layout / allocator invariants:
      - the pool is split into ``partitions`` contiguous ranges; slot s
        draws only from partition ``s * partitions // slots``
      - the FIRST block of each partition is that partition's *trash*
        block: inactive slots' table rows point at it, so their garbage
        decode writes land somewhere no live table row reads
      - a block's refcount = #slot tables naming it + 1 if the prefix
        registry holds it; it returns to the free list at zero
      - admission maps registered prefix blocks read-only (refcount++) and
        allocates private blocks for the rest; the engine only writes
        positions >= the shared prefix, so shared blocks are never written
        (``ensure_private`` forks a copy-on-write duplicate for a client
        that does need to write into a shared block)
    """

    def __init__(self, cfg, slots: int, max_seq: int, *,
                 block_size: int | None = None,
                 num_blocks: int | None = None, partitions: int = 1,
                 device="cuda"):
        device = resolve_device(device)
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        bk, num_blocks = pool_geometry(slots, max_seq, block_size=block_size,
                                       num_blocks=num_blocks,
                                       partitions=partitions)
        self.block_size = bk
        self.nk = max_seq // bk
        self.partitions = partitions
        self.num_blocks = num_blocks
        self.nb_local = num_blocks // partitions
        if self.nb_local < self.nk + 1:
            raise ValueError("need at least one slot's worth of blocks + "
                             "trash per partition")

        spec = paged_cache_spec(cfg, slots, max_seq, block_size=bk,
                                num_blocks=num_blocks)
        self._paged_leaf = _map_tree(
            lambda s: "cache_blocks" in s[2],
            {k: v for k, v in spec.items() if k not in ("index", "block_tbl")})
        self.cache = _map_tree(
            lambda s: torch.zeros(s[0], dtype=s[1], device=device), spec)

        # host-side allocator state
        self.trash = [p * self.nb_local for p in range(partitions)]
        self.free: list[list[int]] = [
            [p * self.nb_local + i for i in range(1, self.nb_local)]
            for p in range(partitions)]
        self.refcount = np.zeros(num_blocks, np.int64)
        self.tables = np.zeros((slots, self.nk), np.int32)
        for s in range(slots):
            self.tables[s, :] = self.trash[self._partition(s)]
        self.slot_blocks: list[list[int]] = [[] for _ in range(slots)]
        # per-partition prefix registry: key → block id, LRU-ordered.
        # Sharing needs the whole per-slot decode state in pageable leaves
        # (+ index): recurrent state or cross K/V encodes the prefix
        # outside the blocks.
        paged = _tree_leaves(self._paged_leaf)
        self.can_share = (cfg.ssm is None and cfg.hybrid is None
                          and not cfg.enc_dec and any(paged) and all(paged))
        self.registry: list[OrderedDict] = [OrderedDict()
                                            for _ in range(partitions)]
        # prefix-cache counters (EngineStats.lifetime)
        self.n_admits = 0
        self.n_prefix_hits = 0
        self.tokens_shared = 0
        self._sync_tables()

    # ------------------------------------------------------------- layout

    @property
    def is_paged(self) -> bool:
        return "block_tbl" in self.cache

    def _partition(self, slot: int) -> int:
        return slot * self.partitions // self.slots

    def _block_partition(self, block: int) -> int:
        return block // self.nb_local

    def _sync_tables(self, slot: int | None = None):
        """Copy the host table (or one slot's row) into the device leaf."""
        if "block_tbl" not in self.cache:
            return
        tbl = self.cache["block_tbl"]
        if slot is None:
            tbl.copy_(torch.from_numpy(self.tables))
        else:
            tbl[slot].copy_(torch.from_numpy(self.tables[slot]))

    # ------------------------------------------------------------- alloc

    def blocks_needed(self, total_len: int) -> int:
        return -(-min(total_len, self.max_seq) // self.block_size)

    def lookup_prefix(self, slot: int, prompt: np.ndarray, *,
                      extra: bytes = b""):
        """→ (n_hit_blocks, [block ids]) for the longest registered
        block-aligned prefix of ``prompt`` on this slot's partition, capped
        at (P-1)//bk blocks so at least one prompt token streams through
        the engine (its logits give the first sampled token)."""
        if not self.can_share:
            return 0, []
        reg = self.registry[self._partition(slot)]
        hit: list[int] = []
        for j in range((len(prompt) - 1) // self.block_size):
            key = _prefix_key(prompt, (j + 1) * self.block_size, extra)
            blk = reg.get(key)
            if blk is None:
                break
            reg.move_to_end(key)       # LRU touch
            hit.append(blk)
        return len(hit), hit

    def _reclaim(self, part: int, need: int):
        """LRU-evict registry-only blocks (refcount == 1) until the
        partition's free list can cover ``need`` private blocks."""
        reg = self.registry[part]
        while len(self.free[part]) < need:
            victim = next((k for k, b in reg.items()
                           if self.refcount[b] == 1), None)
            if victim is None:
                break
            blk = reg.pop(victim)
            self.refcount[blk] -= 1
            self.free[part].append(blk)

    def can_admit(self, slot: int, prompt: np.ndarray, gen_len: int, *,
                  extra: bytes = b"") -> bool:
        part = self._partition(slot)
        h, hit = self.lookup_prefix(slot, prompt, extra=extra)
        need = self.blocks_needed(len(prompt) + gen_len) - h
        # the hit blocks are NOT evictable for this admission: admit_slot
        # pins them before reclaiming
        hit_set = set(hit)
        evictable = sum(1 for b in self.registry[part].values()
                        if self.refcount[b] == 1 and b not in hit_set)
        return len(self.free[part]) + evictable >= need

    def admit_slot(self, slot: int, prompt: np.ndarray, gen_len: int, *,
                   extra: bytes = b"") -> int:
        """Build the slot's table row: shared prefix blocks mapped read-only
        (refcount++), private blocks allocated for the rest, remaining table
        entries parked on the trash block.  Returns the number of prompt
        TOKENS already resident (0 → the caller runs a full prefill)."""
        part = self._partition(slot)
        if self.slot_blocks[slot]:
            raise ValueError(f"slot {slot} not released")
        h, shared = self.lookup_prefix(slot, prompt, extra=extra)
        n_priv = self.blocks_needed(len(prompt) + gen_len) - h
        # pin the hit blocks BEFORE reclaiming: a registry-only hit block
        # (refcount 1) would otherwise be evictable, and the private pops
        # below could hand it out again as a writable block of this row
        for blk in shared:
            self.refcount[blk] += 1
        self._reclaim(part, n_priv)
        if len(self.free[part]) < n_priv:
            for blk in shared:         # roll the pins back; admission failed
                self.refcount[blk] -= 1
            raise AssertionError(
                f"partition {part} exhausted ({n_priv} blocks needed)")
        row = np.full(self.nk, self.trash[part], np.int32)
        row[:h] = shared
        priv = [self.free[part].pop() for _ in range(n_priv)]
        for j, blk in enumerate(priv):
            self.refcount[blk] += 1
            row[h + j] = blk
        self.tables[slot] = row
        self.slot_blocks[slot] = shared + priv
        self._sync_tables(slot)
        self.n_admits += 1
        if h:
            self.n_prefix_hits += 1
            self.tokens_shared += h * self.block_size
        return h * self.block_size

    def register_block(self, slot: int, j: int, prompt: np.ndarray, *,
                       extra: bytes = b""):
        """Publish the slot's j-th block (fully written with
        prompt[:(j+1)·bk]) into the prefix registry, which holds its own
        reference, so the block survives the slot's release."""
        if not self.can_share:
            return
        part = self._partition(slot)
        blk = int(self.tables[slot, j])
        if blk == self.trash[part]:
            return
        key = _prefix_key(prompt, (j + 1) * self.block_size, extra)
        reg = self.registry[part]
        if key in reg:
            return
        reg[key] = blk
        self.refcount[blk] += 1

    def ensure_private(self, slot: int, j: int):
        """Copy-on-write fork: if the slot's j-th block is shared (refcount
        > 1), copy it into a fresh block in every pageable leaf and repoint
        the table row.  The serving engine never needs this (it only writes
        past the shared prefix)."""
        part = self._partition(slot)
        blk = int(self.tables[slot, j])
        if blk == self.trash[part] or self.refcount[blk] <= 1:
            return blk
        self._reclaim(part, 1)
        if not self.free[part]:
            raise AssertionError(f"partition {part} exhausted (COW fork)")
        new = self.free[part].pop()

        def copy(leaf, paged):
            if paged:      # pageable leaves are (A, NB, bk, KV, hd)
                leaf[:, new].copy_(leaf[:, blk])

        _map_tree(copy, {k: self.cache[k] for k in self._paged_leaf},
                  self._paged_leaf)
        self.refcount[new] += 1
        self.refcount[blk] -= 1
        self.slot_blocks[slot][self.slot_blocks[slot].index(blk)] = new
        self.tables[slot, j] = new
        self._sync_tables(slot)
        return new

    def release(self, slot: int):
        """Drop the slot's references; blocks whose refcount reaches zero
        return to their partition's free list.  Registered prefix blocks
        survive (the registry's own reference keeps them resident)."""
        for blk in self.slot_blocks[slot]:
            self.refcount[blk] -= 1
            if self.refcount[blk] == 0:
                self.free[self._block_partition(blk)].append(blk)
        self.slot_blocks[slot] = []
        self.tables[slot, :] = self.trash[self._partition(slot)]
        self._sync_tables(slot)

    def release_registry(self):
        """Drop every prefix-registry reference: with all slots released,
        every refcount returns to zero."""
        for reg in self.registry:
            for blk in reg.values():
                self.refcount[blk] -= 1
                if self.refcount[blk] == 0:
                    self.free[self._block_partition(blk)].append(blk)
            reg.clear()

    # ------------------------------------------------------------- write

    def write(self, one, slot: int, *, index=None):
        """Write a batch-1 DENSE cache tree (from prefill) into ``slot``:
        dense leaves merge as in SlotPool; pageable leaves are cut into
        bk-token chunks and copied into the slot's allocated blocks (never
        shared ones: on a prefix hit the engine runs no prefill)."""
        n_alloc = len(self.slot_blocks[slot])
        device = self.cache["index"].device
        tgt = torch.as_tensor(self.tables[slot, :n_alloc], dtype=torch.long,
                              device=device)

        def write_leaf(pool, o, paged):
            if not paged:
                write_slot(pool, o, slot)
                return
            o = _pad_to_pool_seq(o, self.max_seq)
            # (A, 1, Smax, KV, hd) → (A, nk, bk, KV, hd) chunks
            chunks = o[:, 0].reshape((o.shape[0], self.nk, self.block_size)
                                     + tuple(o.shape[3:]))
            pool.index_copy_(1, tgt, chunks[:, :n_alloc].to(pool.dtype))

        _map_tree(write_leaf, {k: self.cache[k] for k in self._paged_leaf},
                  {k: one[k] for k in self._paged_leaf}, self._paged_leaf)
        self.set_slot_index(slot, one["index"] if index is None else index)


def _pad_to_pool_seq(one, max_seq: int):
    """Zero-pad a batch-1 prefill leaf's seq axis (axis 2 of
    (A, 1, S, KV, hd)) up to max_seq so it cuts into nk whole blocks."""
    short = max_seq - one.shape[2]
    if short > 0:
        one = F.pad(one, (0, 0, 0, 0, 0, short))
    return one


def make_pool(cfg, slots: int, max_seq: int, *, pool: str = "dense",
              block_size: int | None = None, num_blocks: int | None = None,
              partitions: int = 1, device="cuda"):
    """Pool factory: ``pool`` ∈ {"dense", "paged"}."""
    if pool == "paged":
        return PagedSlotPool(cfg, slots, max_seq, block_size=block_size,
                             num_blocks=num_blocks, partitions=partitions,
                             device=device)
    if pool != "dense":
        raise ValueError(f"unknown pool {pool!r}")
    return SlotPool(cfg, slots, max_seq, device=device)
