"""K1 decode attention and K5 paged decode attention, each also with the
row's new K/V write (K2, K6) folded into its launch, and K2 ring-slot and
K6 paged cache writes standalone.

K1 replaces ``repro/kernels/decode_attention.py::decode_attention_bkgd``,
K2 ``cache_ring_update_bs``, K5 ``decode_attention_paged_bkgd`` and K6
``cache_paged_update_bs``.  The CUDA kernels live in
``csrc/decode_attention.cu``, whose head note says what bounds them on the
H100 and what their design does about it.  K1 and K5 are one partial
kernel with two key-address policies (16-byte vector loads straight into
registers, one online softmax per lane group, no atomics), one split plan
and one combine kernel.  ``decode_attention_write`` and
``decode_attention_paged_write`` launch its instance that first writes
the row's new K and V into the caches and then attends with them: what
``Attention.decode`` runs, two launches fewer a layer than K2, K2, K1,
and bitwise equal to them (outputs and caches; paged: active rows, and
the pool outside trash blocks).  K2 and K6 share one row-write body, a
thread per 16-byte vector; serving no longer launches them.

Each wrapper runs its kernel on CUDA tensors and its plain PyTorch version
(``repro_torch.kernels.ref``) on CPU tensors; ``launches`` counts kernel
launches.  ``cost`` and ``row_write_cost`` are the FLOPs and HBM bytes of
one launch, which a cost counter records for each call (``region``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _lib, ref
from repro_torch.kernels.region import Cost, counted, per_row_list

DEC_TILE = 64            # split granule: splits are whole tiles of keys
BLOCKS_PER_SM = 2        # split-K target: about this many blocks per SM
MAX_SPLIT_LEN = 4096     # keys one block walks at most
GMAX = 8                 # query heads a block holds in registers


def split_plan(B: int, KV: int, Smax: int, sm_count: int) -> tuple[int, int]:
    """(split_len, n_splits): cut Smax into tile-aligned splits so that the
    B*KV*n_splits blocks come to about BLOCKS_PER_SM blocks per SM, each
    split at most MAX_SPLIT_LEN keys.  Planned from shapes alone, never
    from the index, and shared by K1 and K5 (their bitwise equality rests
    on it)."""
    max_splits = math.ceil(Smax / DEC_TILE)
    want = math.ceil(BLOCKS_PER_SM * sm_count / max(B * KV, 1))
    n = min(max_splits, max(1, want, math.ceil(Smax / MAX_SPLIT_LEN)))
    split_len = math.ceil(math.ceil(Smax / n) / DEC_TILE) * DEC_TILE
    return split_len, math.ceil(Smax / split_len)


def cost(B: int, H: int, KV: int, hd: int, live: int, *, itemsize: int = 2,
         blocks: int = 0, new_itemsize: int = 0) -> Cost:
    """One K1 launch (K5: ``blocks`` table entries read) over ``live`` keys
    in all, the rows' horizons min(index + 1, Smax) summed: q read and the
    output written, each live K and V row read once, the index read; with
    ``new_itemsize`` (the write instances) the new K and V rows read and
    written into the caches.  FLOPs: q.k and p.v, 2 a (key, head, dim)
    each; transcendentals: one exp a (key, head)."""
    nbytes = (2 * B * H * hd * itemsize + 2 * live * KV * hd * itemsize
              + blocks * 4 + B * 4)
    if new_itemsize:
        nbytes += 2 * B * KV * hd * (new_itemsize + itemsize)
    return Cost(4 * live * H * hd, nbytes, live * H)


def row_write_cost(B: int, KV: int, hd: int, *, itemsize: int = 2,
                   new_itemsize: int = 2, paged: bool = False) -> Cost:
    """One K2 (K6: ``paged``) launch: B new (KV, hd) rows read and written
    into the cache, and the slot (block and offset) of each row read."""
    return Cost(0, B * KV * hd * (new_itemsize + itemsize)
                + B * (8 if paged else 4))


def _horizons(index, B: int, Smax: int) -> list[int]:
    return [min(i + 1, Smax) for i in per_row_list(index, B)]


def _dense_cost(q, k_cache, index, new=None) -> Cost:
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    return cost(B, H, KV, hd, sum(_horizons(index, B, Smax)),
                itemsize=k_cache.element_size(),
                new_itemsize=new.element_size() if new is not None else 0)


def _paged_cost(q, k_cache, tbl, index, new=None) -> Cost:
    B, _, H, hd = q.shape
    bk, KV = k_cache.shape[1], k_cache.shape[2]
    live = _horizons(index, B, tbl.shape[-1] * bk)
    return cost(B, H, KV, hd, sum(live), itemsize=k_cache.element_size(),
                blocks=sum(-(-n // bk) for n in live),
                new_itemsize=new.element_size() if new is not None else 0)


class Geometry(NamedTuple):
    """How csrc/decode_attention.cu lays one call out: ``lanes_per_row``
    lanes hold 16 bytes of a key row each, a block takes ``gmax`` query
    heads (``gchunks`` blocks per KV head), and Smax is cut by
    ``split_plan``."""
    lanes_per_row: int
    gmax: int
    gchunks: int
    split_len: int
    n_splits: int


def geometry(B: int, H: int, KV: int, hd: int, Smax: int, dtype,
             sm_count: int) -> Geometry:
    """The launch layout of K1 and K5 (one function for both); raises for
    an hd wider than a warp's 32 lanes of 16 bytes."""
    per16 = 16 // torch.empty((), dtype=dtype).element_size()
    lanes = math.ceil(hd / per16)
    if lanes > 32:
        raise ValueError(f"hd {hd} in {dtype}: at most {32 * per16}")
    G = H // KV
    gmax = min(GMAX, 1 << (G - 1).bit_length())
    gchunks = math.ceil(G / gmax)
    split_len, n_splits = split_plan(B, KV * gchunks, Smax, sm_count)
    return Geometry(1 << (lanes - 1).bit_length(), gmax, gchunks, split_len,
                    n_splits)


def _check_dense(q, k_cache, v_cache):
    """(KV, Smax) of a K1 call; raises on what the kernel does not take."""
    B, one, H, hd = q.shape
    _, Smax, KV, _ = k_cache.shape
    if (one != 1 or k_cache.shape != (B, Smax, KV, hd)
            or v_cache.shape != k_cache.shape or H % KV):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
                         f"v {tuple(v_cache.shape)}")
    _check_layout(q, k_cache, v_cache)
    if not (k_cache.is_cuda and v_cache.is_cuda):
        raise ValueError("q and the caches must lie on one CUDA device")
    return KV, Smax


def _check_paged(q, k_cache, v_cache, tbl):
    """(KV, bk, table args) of a K5 call; raises on what the kernel does not
    take."""
    B, one, H, hd = q.shape
    NB, bk, KV, _ = k_cache.shape
    nk = tbl.shape[-1]
    if (one != 1 or k_cache.shape != (NB, bk, KV, hd)
            or v_cache.shape != k_cache.shape or H % KV
            or tuple(tbl.shape) != (B, nk)):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
                         f"v {tuple(v_cache.shape)} tbl {tuple(tbl.shape)}")
    _check_layout(q, k_cache, v_cache)
    if not (k_cache.is_cuda and v_cache.is_cuda and tbl.is_cuda):
        raise ValueError("q, the pools and the table must lie on one CUDA "
                         "device")
    tbl = tbl.to(torch.int32)
    if tbl.stride(1) != 1:
        tbl = tbl.contiguous()
    return KV, nk * bk, (tbl, tbl.stride(0), bk)


def _check_layout(q, k_cache, v_cache):
    if (q.stride(3) != 1 or k_cache.stride(3) != 1
            or k_cache.stride() != v_cache.stride()):
        raise ValueError("head_dim must be contiguous and K/V strides equal")


def _new_rows(k_new, v_new, q, KV):
    """The write instance's arguments for the new rows (B, KV, hd): both
    pointers, their row and head strides (shared), their dtype code."""
    B, _, _, hd = q.shape
    if tuple(k_new.shape) != (B, KV, hd) or v_new.shape != k_new.shape:
        raise ValueError(f"new rows k {tuple(k_new.shape)} v "
                         f"{tuple(v_new.shape)}, expected {(B, KV, hd)}")
    if k_new.stride(2) != 1 or k_new.stride() != v_new.stride():
        raise ValueError("the new rows' head_dim must be contiguous and "
                         "their strides equal")
    if not (k_new.is_cuda and v_new.is_cuda):
        raise ValueError("the new rows must lie on q's CUDA device")
    return (k_new.data_ptr(), v_new.data_ptr(), k_new.stride(0),
            k_new.stride(1), _lib.dtype_code(k_new, v_new))


_NO_WRITE = (None, None, 0, 0, 0)


def _launch(name, q, k_cache, v_cache, index, KV, Smax, table, new_rows):
    """Shared body of the K1 and K5 wrappers: plan, allocate, launch.
    ``table``: () dense, (tbl, row stride, bk) paged; ``new_rows``:
    ``_NO_WRITE`` or ``_new_rows(...)``."""
    B, _, H, hd = q.shape
    code = _lib.dtype_code(q, k_cache, v_cache)
    idx = _lib.per_row(index, q, torch.int32)
    geo = geometry(B, H, KV, hd, Smax, q.dtype,
                   _lib.sm_count(q.device.index or 0))
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    n = geo.n_splits if geo.n_splits > 1 else 0    # one split writes out
    part_acc = torch.empty((B, H, n, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, H, n, 2), dtype=torch.float32, device=q.device)
    table_args = (table[0].data_ptr(), *table[1:]) if table else ()
    _lib.launch(name, q, q.data_ptr(), q.stride(0), q.stride(2),
                k_cache.data_ptr(), v_cache.data_ptr(), k_cache.stride(0),
                k_cache.stride(1), k_cache.stride(2), *table_args,
                idx.data_ptr(), *new_rows, out.data_ptr(),
                part_acc.data_ptr(), part_ml.data_ptr(), code, B, KV, H // KV,
                hd, geo.gmax, geo.lanes_per_row.bit_length() - 1, Smax,
                geo.split_len, geo.n_splits,
                int(_lib.rows_16b(hd, q, k_cache, v_cache)))
    return out


@counted("decode_attention",
         lambda q, k_cache, v_cache, index: _dense_cost(q, k_cache, index))
def decode_attention(q, k_cache, v_cache, index):
    """q: (B, 1, H, hd); caches: (B, Smax, KV, hd), read in place through
    strides; index: int or (B,) — row b sees slots <= index[b] (all of them
    once index[b] >= Smax) → (B, 1, H, hd) in q's dtype."""
    if not q.is_cuda:
        return ref.decode_attention_ref(q, k_cache, v_cache, index)
    KV, Smax = _check_dense(q, k_cache, v_cache)
    out = _launch("rt_decode_attention", q, k_cache, v_cache, index, KV,
                  Smax, (), _NO_WRITE)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


@counted("decode_attention_write",
         lambda q, k_new, v_new, k_cache, v_cache, index: _dense_cost(
             q, k_cache, index, k_new))
def decode_attention_write(q, k_new, v_new, k_cache, v_cache, index):
    """``cache_ring_update`` of k_new and v_new (B, KV, hd) into slot
    index[b] % Smax of row b, in place, cast to the cache dtype, then
    ``decode_attention(q, k_cache, v_cache, index)``, in one launch and bit
    for bit → (B, 1, H, hd).  index[b] >= 0."""
    if not q.is_cuda:
        return ref.decode_attention_write_ref(q, k_new, v_new, k_cache,
                                              v_cache, index)
    KV, Smax = _check_dense(q, k_cache, v_cache)
    out = _launch("rt_decode_attention", q, k_cache, v_cache, index, KV,
                  Smax, (), _new_rows(k_new, v_new, q, KV))
    decode_attention_write.launches += 1
    return out


decode_attention_write.launches = 0


@counted("decode_attention_paged",
         lambda q, k_cache, v_cache, tbl, index: _paged_cost(
             q, k_cache, tbl, index))
def decode_attention_paged(q, k_cache, v_cache, tbl, index):
    """q: (B, 1, H, hd); caches: (NB, bk, KV, hd) block pools, read in place
    through strides; tbl: (B, nk) block ids in [0, NB) — row b's logical
    key t lives at ``pool[tbl[b, t // bk], t % bk]``; index: int or (B,) —
    row b sees logical keys <= index[b] (all nk·bk once index[b] >= nk·bk)
    → (B, 1, H, hd) in q's dtype."""
    if not q.is_cuda:
        return ref.decode_attention_paged_ref(q, k_cache, v_cache, tbl, index)
    KV, Smax, table = _check_paged(q, k_cache, v_cache, tbl)
    out = _launch("rt_decode_attention_paged", q, k_cache, v_cache, index,
                  KV, Smax, table, _NO_WRITE)
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0


@counted("decode_attention_paged_write",
         lambda q, k_new, v_new, k_cache, v_cache, tbl, index: _paged_cost(
             q, k_cache, tbl, index, k_new))
def decode_attention_paged_write(q, k_new, v_new, k_cache, v_cache, tbl,
                                 index):
    """``cache_paged_update`` of k_new and v_new (B, KV, hd) into logical
    key rpos = index[b] % (nk·bk) of row b, ``pool[tbl[b, rpos // bk],
    rpos % bk]``, in place, cast to the pool dtype, then
    ``decode_attention_paged(q, k_cache, v_cache, tbl, index)``, in one
    launch → (B, 1, H, hd).  Bit for bit on rows whose target is their own
    block; rows that share a target (inactive rows on the trash block)
    collide, and their outputs are undefined.  index[b] >= 0."""
    if not q.is_cuda:
        return ref.decode_attention_paged_write_ref(q, k_new, v_new, k_cache,
                                                    v_cache, tbl, index)
    KV, Smax, table = _check_paged(q, k_cache, v_cache, tbl)
    out = _launch("rt_decode_attention_paged", q, k_cache, v_cache, index,
                  KV, Smax, table, _new_rows(k_new, v_new, q, KV))
    decode_attention_paged_write.launches += 1
    return out


decode_attention_paged_write.launches = 0


def _check_rows(cache, new, B, KV, hd):
    if tuple(new.shape) != (B, KV, hd):
        raise ValueError(f"new {tuple(new.shape)} for cache "
                         f"{tuple(cache.shape)}")
    if (cache.stride(3) != 1 or cache.stride(2) != hd
            or new.stride(2) != 1 or new.stride(1) != hd):
        raise ValueError("each (KV, hd) row must be contiguous")
    if not new.is_cuda:
        raise ValueError("cache and new must lie on one CUDA device")


def _rows_vec(cache, new) -> bool:
    """Every (KV*hd,) row of the cache starts on 16 bytes, and every row of
    new on the bytes one thread reads of it (16 bytes of cache elements'
    worth, at most 16 at once): the row kernel may move them a vector at a
    time."""
    per16 = 16 // cache.element_size()
    step = min(16, per16 * new.element_size())
    return (cache.data_ptr() % 16 == 0
            and all(st % per16 == 0 for st in cache.stride()[:2])
            and new.data_ptr() % step == 0
            and new.stride(0) * new.element_size() % step == 0)


@counted("cache_ring_update",
         lambda cache, new, slot: row_write_cost(
             new.shape[0], cache.shape[2], cache.shape[3],
             itemsize=cache.element_size(), new_itemsize=new.element_size()))
def cache_ring_update(cache, new, slot):
    """Write ``new[b]`` (B, KV, hd) into ``cache[b, slot[b]]`` of the
    (B, Smax, KV, hd) cache, in place, cast to the cache dtype; returns the
    cache."""
    if not cache.is_cuda:
        return ref.cache_ring_update_ref(cache, new, slot)
    B, Smax, KV, hd = cache.shape
    _check_rows(cache, new, B, KV, hd)
    slots = _lib.per_row(slot, cache, torch.int32)
    _lib.launch("rt_cache_ring_update", cache, cache.data_ptr(),
                _lib.dtype_code(cache), cache.stride(0), cache.stride(1),
                new.data_ptr(), _lib.dtype_code(new), new.stride(0),
                slots.data_ptr(), B, Smax, KV * hd,
                int(_rows_vec(cache, new)))
    cache_ring_update.launches += 1
    return cache


cache_ring_update.launches = 0


@counted("cache_paged_update",
         lambda cache, new, blk, off: row_write_cost(
             new.shape[0], cache.shape[2], cache.shape[3],
             itemsize=cache.element_size(), new_itemsize=new.element_size(),
             paged=True))
def cache_paged_update(cache, new, blk, off):
    """Write ``new[b]`` (B, KV, hd) into ``cache[blk[b], off[b]]`` of the
    (NB, bk, KV, hd) block pool, in place, cast to the pool dtype; returns
    the pool.  Rows naming the same (blk, off) collide: which lands is
    undefined (inactive slots all write their partition's trash block)."""
    if not cache.is_cuda:
        return ref.cache_paged_update_ref(cache, new, blk, off)
    NB, bk, KV, hd = cache.shape
    B = new.shape[0]
    _check_rows(cache, new, B, KV, hd)
    blks = _lib.per_row(blk, new, torch.int32)
    offs = _lib.per_row(off, new, torch.int32)
    _lib.launch("rt_cache_paged_update", cache, cache.data_ptr(),
                _lib.dtype_code(cache), cache.stride(0), cache.stride(1),
                new.data_ptr(), _lib.dtype_code(new), new.stride(0),
                blks.data_ptr(), offs.data_ptr(), B, NB, bk, KV * hd,
                int(_rows_vec(cache, new)))
    cache_paged_update.launches += 1
    return cache


cache_paged_update.launches = 0
