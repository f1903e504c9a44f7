"""K1 decode attention, K2 ring-slot cache write, K5 paged decode attention
and K6 paged cache write.

K1 replaces ``repro/kernels/decode_attention.py::decode_attention_bkgd``,
K2 ``cache_ring_update_bs``, K5 ``decode_attention_paged_bkgd`` and K6
``cache_paged_update_bs``.  The CUDA kernels live in
``csrc/decode_attention.cu``, whose head note says what bounds them on the
H100 and what their design does about it.  K1 and K5 are one partial
kernel with two key-address policies, one split plan and one combine
kernel; K2 and K6 one row-write body.

Each wrapper runs its kernel on CUDA tensors and its plain PyTorch version
(``repro_torch.kernels.ref``) on CPU tensors; ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.kernels import _lib, ref

DEC_TILE = 64            # keys per shared-memory tile, as in the CUDA source
BLOCKS_PER_SM = 4        # split-K target: this many blocks per SM


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def split_plan(B: int, KV: int, Smax: int, sm_count: int) -> tuple[int, int]:
    """(split_len, n_splits): cut Smax into tile-aligned splits so that the
    B*KV*n_splits blocks fill about BLOCKS_PER_SM blocks per SM."""
    max_splits = math.ceil(Smax / DEC_TILE)
    want = math.ceil(BLOCKS_PER_SM * sm_count / max(B * KV, 1))
    n = min(max_splits, max(1, want))
    split_len = math.ceil(math.ceil(Smax / n) / DEC_TILE) * DEC_TILE
    return split_len, math.ceil(Smax / split_len)


def decode_attention(q, k_cache, v_cache, index):
    """q: (B, 1, H, hd); caches: (B, Smax, KV, hd), read in place through
    strides; index: int or (B,) — row b sees slots <= index[b] (all of them
    once index[b] >= Smax) → (B, 1, H, hd) in q's dtype."""
    if not q.is_cuda:
        return ref.decode_attention_ref(q, k_cache, v_cache, index)
    B, one, H, hd = q.shape
    _, Smax, KV, _ = k_cache.shape
    if (one != 1 or k_cache.shape != (B, Smax, KV, hd)
            or v_cache.shape != k_cache.shape or H % KV):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
                         f"v {tuple(v_cache.shape)}")
    if (q.stride(3) != 1 or k_cache.stride(3) != 1
            or k_cache.stride() != v_cache.stride()):
        raise ValueError("head_dim must be contiguous and K/V strides equal")
    if not (k_cache.is_cuda and v_cache.is_cuda):
        raise ValueError("q and the caches must lie on one CUDA device")
    code = _lib.dtype_code(q, k_cache, v_cache)
    idx = _lib.per_row(index, q, torch.int32)
    G = H // KV
    split_len, n_splits = split_plan(B, KV, Smax,
                                     _sm_count(q.device.index or 0))
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((B, KV, n_splits, G, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, KV, n_splits, G, 2), dtype=torch.float32,
                          device=q.device)
    err = _lib.load().rt_decode_attention(
        q.data_ptr(), q.stride(0), q.stride(2), k_cache.data_ptr(),
        v_cache.data_ptr(), k_cache.stride(0), k_cache.stride(1),
        k_cache.stride(2), idx.data_ptr(), out.data_ptr(),
        part_acc.data_ptr(), part_ml.data_ptr(), code, B, KV, G, hd, Smax,
        split_len, n_splits, _lib.stream_ptr(q))
    _lib.check(err, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_paged(q, k_cache, v_cache, tbl, index):
    """q: (B, 1, H, hd); caches: (NB, bk, KV, hd) block pools, read in place
    through strides; tbl: (B, nk) block ids in [0, NB) — row b's logical
    key t lives at ``pool[tbl[b, t // bk], t % bk]``; index: int or (B,) —
    row b sees logical keys <= index[b] (all nk·bk once index[b] >= nk·bk)
    → (B, 1, H, hd) in q's dtype."""
    if not q.is_cuda:
        return ref.decode_attention_paged_ref(q, k_cache, v_cache, tbl, index)
    B, one, H, hd = q.shape
    NB, bk, KV, _ = k_cache.shape
    nk = tbl.shape[-1]
    if (one != 1 or k_cache.shape != (NB, bk, KV, hd)
            or v_cache.shape != k_cache.shape or H % KV
            or tuple(tbl.shape) != (B, nk)):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k_cache.shape)} "
                         f"v {tuple(v_cache.shape)} tbl {tuple(tbl.shape)}")
    if (q.stride(3) != 1 or k_cache.stride(3) != 1
            or k_cache.stride() != v_cache.stride()):
        raise ValueError("head_dim must be contiguous and K/V strides equal")
    if not (k_cache.is_cuda and v_cache.is_cuda and tbl.is_cuda):
        raise ValueError("q, the pools and the table must lie on one CUDA "
                         "device")
    code = _lib.dtype_code(q, k_cache, v_cache)
    idx = _lib.per_row(index, q, torch.int32)
    tbl = tbl.to(torch.int32)
    if tbl.stride(1) != 1:
        tbl = tbl.contiguous()
    G, Smax = H // KV, nk * bk
    split_len, n_splits = split_plan(B, KV, Smax,
                                     _sm_count(q.device.index or 0))
    out = torch.empty((B, 1, H, hd), dtype=q.dtype, device=q.device)
    part_acc = torch.empty((B, KV, n_splits, G, hd), dtype=torch.float32,
                           device=q.device)
    part_ml = torch.empty((B, KV, n_splits, G, 2), dtype=torch.float32,
                          device=q.device)
    err = _lib.load().rt_decode_attention_paged(
        q.data_ptr(), q.stride(0), q.stride(2), k_cache.data_ptr(),
        v_cache.data_ptr(), k_cache.stride(0), k_cache.stride(1),
        k_cache.stride(2), tbl.data_ptr(), tbl.stride(0), bk, idx.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), code, B, KV,
        G, hd, Smax, split_len, n_splits, _lib.stream_ptr(q))
    _lib.check(err, "decode_attention_paged")
    decode_attention_paged.launches += 1
    return out


decode_attention_paged.launches = 0


def cache_ring_update(cache, new, slot):
    """Write ``new[b]`` (B, KV, hd) into ``cache[b, slot[b]]`` of the
    (B, Smax, KV, hd) cache, in place, cast to the cache dtype; returns the
    cache."""
    if not cache.is_cuda:
        return ref.cache_ring_update_ref(cache, new, slot)
    B, Smax, KV, hd = cache.shape
    if tuple(new.shape) != (B, KV, hd):
        raise ValueError(f"new {tuple(new.shape)} for cache "
                         f"{tuple(cache.shape)}")
    if (cache.stride(3) != 1 or cache.stride(2) != hd
            or new.stride(2) != 1 or new.stride(1) != hd):
        raise ValueError("each (KV, hd) row must be contiguous")
    if not new.is_cuda:
        raise ValueError("cache and new must lie on one CUDA device")
    code_c, code_n = _lib.dtype_code(cache), _lib.dtype_code(new)
    slots = _lib.per_row(slot, cache, torch.int32)
    err = _lib.load().rt_cache_ring_update(
        cache.data_ptr(), code_c, cache.stride(0), cache.stride(1),
        new.data_ptr(), code_n, new.stride(0), slots.data_ptr(), B, Smax,
        KV * hd, _lib.stream_ptr(cache))
    _lib.check(err, "cache_ring_update")
    cache_ring_update.launches += 1
    return cache


cache_ring_update.launches = 0


def cache_paged_update(cache, new, blk, off):
    """Write ``new[b]`` (B, KV, hd) into ``cache[blk[b], off[b]]`` of the
    (NB, bk, KV, hd) block pool, in place, cast to the pool dtype; returns
    the pool.  Rows naming the same (blk, off) collide: which lands is
    undefined (inactive slots all write their partition's trash block)."""
    if not cache.is_cuda:
        return ref.cache_paged_update_ref(cache, new, blk, off)
    NB, bk, KV, hd = cache.shape
    B = new.shape[0]
    if tuple(new.shape) != (B, KV, hd):
        raise ValueError(f"new {tuple(new.shape)} for pool "
                         f"{tuple(cache.shape)}")
    if (cache.stride(3) != 1 or cache.stride(2) != hd
            or new.stride(2) != 1 or new.stride(1) != hd):
        raise ValueError("each (KV, hd) row must be contiguous")
    if not new.is_cuda:
        raise ValueError("pool and new must lie on one CUDA device")
    code_c, code_n = _lib.dtype_code(cache), _lib.dtype_code(new)
    blks = _lib.per_row(blk, new, torch.int32)
    offs = _lib.per_row(off, new, torch.int32)
    err = _lib.load().rt_cache_paged_update(
        cache.data_ptr(), code_c, cache.stride(0), cache.stride(1),
        new.data_ptr(), code_n, new.stride(0), blks.data_ptr(),
        offs.data_ptr(), B, NB, bk, KV * hd, _lib.stream_ptr(cache))
    _lib.check(err, "cache_paged_update")
    cache_paged_update.launches += 1
    return cache


cache_paged_update.launches = 0
