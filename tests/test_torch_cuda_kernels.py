"""Each CUDA kernel of the port against its plain PyTorch version, on the
card (marked ``cuda``; skips where there is no card).  Imports no JAX, so
it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda_kernels.py

Tolerances: attention atol = rtol = 1e-4 in float32 and 2e-2 in bf16 (the
plain version rounds its normalised probabilities to the value dtype, the
decode kernels keep them in float32 and the prefill kernel rounds the
unnormalised ones to bf16 for its tensor-core product); the paged kernel
equal to the dense one bitwise under an identity table, and two identical
decode calls equal bitwise; the ring-slot and paged writes and greedy sampling exact
(bitwise equal to torch.argmax at every split plan); the sampler's hash bits
bitwise and its noise within 1e-6; the SSD scan (float32) atol = rtol =
3e-4, the reference's own, and two identical calls of either equal bitwise.
Decode with the row write folded in equal, output and caches, to the row
writes and the decode one after the other, bitwise (paged: active rows,
and the pool outside the trash block); ``top_k`` sampling on the card equal
to the same plain call on the CPU.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sample as smp
from repro_torch.kernels import ssm_scan as ssp
from repro_torch.kernels.sample import sample_noise


def _qkv(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    return q, k, v


def _mixed_index(B, Smax, seed):
    rng = np.random.default_rng(seed)
    fresh = rng.integers(0, Smax, size=B)
    wrapped = rng.integers(Smax, 4 * Smax, size=B)
    return np.where(np.arange(B) % 2 == 0, fresh, wrapped).astype(np.int32)


def _index(regime, B, Smax, seed):
    """Decode indices: every row fresh (slot <= index < Smax), every row
    wrapped (index >= Smax: all slots live), every row at index 0 (one live
    key), or alternating fresh and wrapped."""
    rng = np.random.default_rng(seed)
    if regime == "fresh":
        return rng.integers(0, Smax, size=B).astype(np.int32)
    if regime == "wrapped":
        return rng.integers(Smax, 4 * Smax, size=B).astype(np.int32)
    if regime == "zero":
        return np.zeros(B, np.int32)
    return _mixed_index(B, Smax, seed)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["mixed", "fresh", "wrapped", "zero"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,Smax,KV,G,hd", [(8, 1024, 2, 8, 128),
                                            (3, 100, 2, 2, 16),
                                            (2, 4096, 8, 4, 80),
                                            (8, 1024, 32, 1, 80),
                                            (2, 1000, 4, 5, 64),
                                            (2, 300, 1, 16, 128),
                                            (3, 50, 2, 2, 10),
                                            (8, 1024, 16, 1, 128),
                                            (8, 2048, 4, 7, 128),
                                            (8, 1024, 16, 1, 64)])
def test_decode_attention_kernel_matches_plain(cuda, dtype, tol, B, Smax, KV,
                                               G, hd, regime):
    """Smax 100, 1000, 300 and 50 are not multiples of the 64-key tile; G 5
    and 16 leave a block's register heads part-empty or take two blocks, and
    so does qwen2-vl-7b's G 7 (28 heads over 4 KV heads); hd 10 is read
    element by element; seamless-m4t-medium's hd 64 at G 1."""
    q, kc, vc = (torch.from_numpy(a).to(cuda, dtype)
                 for a in _qkv(B + hd, B, 1, Smax, KV * G, KV, hd))
    index = torch.as_tensor(_index(regime, B, Smax, seed=B), device=cuda)
    out = ops.decode_attention(q, kc, vc, index)
    want = ref.decode_attention_ref(q, kc, vc, index)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


# K4 cases (Sq, H, KV, hd, window): the sweep over Sq, hd, G and the window
# (KV 2; Sq 15/16/17 straddle a warp's 16 rows, 200 and 1000 ragged block
# tiles), then shapes of the configs (h2o-danube's G 4, zamba2's 32 heads,
# olmoe-1b-7b's 16 heads of 128 with G 1, qwen2-vl-7b's and seamless's).
FLASH_CASES = [(Sq, 2 * G, 2, hd, window)
               for Sq in (1, 15, 16, 17, 64, 200, 1000)
               for hd in (8, 16, 64, 80, 128)
               for G in (1, 2, 8)
               for window in (None, 64)] + [
    (200, 32, 8, 80, 64), (37, 4, 2, 8, None), (200, 32, 32, 80, None),
    (200, 16, 16, 128, None), (64, 16, 16, 128, None),
    # qwen2-vl-7b's prefill: 1024 patch positions + 200 text tokens, G 7
    # (1224 is no multiple of the 64-key tile); seamless's decoder, hd 64
    (1224, 28, 4, 128, None), (200, 16, 16, 64, None)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Sq,H,KV,hd,window", FLASH_CASES)
def test_flash_attention_kernel_matches_plain(cuda, dtype, tol, Sq, H, KV, hd,
                                              window):
    """bf16 runs the tensor-core body (hd padded to 16), float32 the exact
    FMA body."""
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _qkv(Sq + hd, 1, Sq, Sq, H, KV, hd))
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_attention_kernels_read_unaligned_rows(cuda, dtype, tol):
    """Rows that do not start on 16-byte boundaries (views into a wider
    tensor, row pitch hd + 1) take the element-by-element loads of K4 and
    K1: the same results as the plain versions."""
    B, S, H, KV, hd = 2, 100, 8, 2, 64
    rng = np.random.default_rng(11)
    wide = lambda *shape: torch.from_numpy(rng.standard_normal(
        shape[:-1] + (shape[-1] + 1,), dtype=np.float32)).to(
            cuda, dtype)[..., :shape[-1]]
    q, k, v = wide(B, S, H, hd), wide(B, S, KV, hd), wide(B, S, KV, hd)
    assert q.stride(2) == hd + 1
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=True).float(),
        ref.flash_attention_ref(q, k, v, causal=True).float(),
        atol=tol, rtol=tol)
    qd = q[:, :1]
    index = torch.as_tensor(_mixed_index(B, S, seed=3), device=cuda)
    torch.testing.assert_close(
        ops.decode_attention(qd, k, v, index).float(),
        ref.decode_attention_ref(qd, k, v, index).float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_smem_reckoning_matches_the_source(cuda, dtype):
    """The wrapper's shared-memory reckoning is the CUDA source's own."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import smem_bytes
    lib = _lib.load()
    for hd in range(1, 257):
        assert (lib.rt_flash_smem_bytes(_lib.DTYPE_CODES[dtype], hd)
                == smem_bytes(dtype, hd)), hd


@pytest.mark.cuda
@pytest.mark.parametrize("new_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_ring_update_kernel_is_exact(cuda, dtype, new_dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    cache = torch.randn(8, 1024, 2, 128, generator=g, device=cuda).to(dtype)
    new = torch.randn(8, 2, 128, generator=g, device=cuda).to(new_dtype)
    slot = torch.tensor([0, 5, 1023, 77, 512, 3, 900, 64], dtype=torch.int32,
                        device=cuda)
    want = ref.cache_ring_update_ref(cache.clone(), new, slot)
    ops.cache_ring_update(cache, new, slot)
    assert torch.equal(cache, want)


def _paged_inputs(cuda, dtype, B, nk, bk, KV, G, hd, seed):
    """A pool of B*nk + 1 blocks (block 0 the trash block), a shuffled
    table and mixed / wrapped indices."""
    rng = np.random.default_rng(seed)
    NB = B * nk + 1
    q = rng.standard_normal((B, 1, KV * G, hd), dtype=np.float32)
    k = rng.standard_normal((NB, bk, KV, hd), dtype=np.float32)
    v = rng.standard_normal((NB, bk, KV, hd), dtype=np.float32)
    tbl = (1 + rng.permutation(B * nk)).reshape(B, nk).astype(np.int32)
    index = _mixed_index(B, nk * bk, seed)
    t = lambda a, dt=dtype: torch.from_numpy(a).to(cuda, dt)
    return (t(q), t(k), t(v), t(tbl, torch.int32), t(index, torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("regime", ["mixed", "fresh", "wrapped", "zero"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bk", [4, 6, 8, 16, 64])
def test_decode_attention_paged_kernel_matches_plain(cuda, dtype, tol, bk,
                                                     regime):
    """nk * bk = 1020 (bk 6) is not a multiple of the 64-key tile."""
    B, KV, G, hd = 8, 2, 8, 128
    nk = max(1, 1024 // bk)
    q, kp, vp, tbl, _ = _paged_inputs(cuda, dtype, B, nk, bk, KV, G, hd,
                                      seed=bk)
    index = torch.as_tensor(_index(regime, B, nk * bk, seed=bk), device=cuda)
    out = ops.decode_attention_paged(q, kp, vp, tbl, index)
    want = ref.decode_attention_paged_ref(q, kp, vp, tbl, index)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_decode_attention_paged_kernel_at_zamba2_heads(cuda, dtype, tol):
    """zamba2's shared attention: 32 heads, one per KV head (G = 1), hd 80."""
    B, KV, G, hd, bk, nk = 8, 32, 1, 80, 8, 128
    q, kp, vp, tbl, index = _paged_inputs(cuda, dtype, B, nk, bk, KV, G, hd,
                                          seed=80)
    out = ops.decode_attention_paged(q, kp, vp, tbl, index)
    want = ref.decode_attention_paged_ref(q, kp, vp, tbl, index)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("KV,G,hd,nk", [(4, 7, 128, 256), (16, 1, 64, 128)])
def test_decode_attention_paged_kernel_at_new_heads(cuda, dtype, tol, KV, G,
                                                    hd, nk):
    """qwen2-vl-7b's 28 heads over 4 KV heads (G 7) through a 2048-key
    table, and seamless-m4t-medium's 16 heads of 64 (G 1)."""
    B, bk = 8, 8
    q, kp, vp, tbl, index = _paged_inputs(cuda, dtype, B, nk, bk, KV, G, hd,
                                          seed=G + hd)
    out = ops.decode_attention_paged(q, kp, vp, tbl, index)
    want = ref.decode_attention_paged_ref(q, kp, vp, tbl, index)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bk", [6, 8])
def test_decode_attention_paged_kernel_equals_dense_bitwise(cuda, dtype, bk):
    """Lay a dense (B, Smax, KV, hd) ring into the pool under an identity
    table: the paged kernel reproduces the dense kernel exactly."""
    B, KV, G, hd, nk = 8, 2, 8, 128, 128
    Smax = nk * bk
    q, kc, vc = (torch.from_numpy(a).to(cuda, dtype)
                 for a in _qkv(bk, B, 1, Smax, KV * G, KV, hd))
    index = torch.as_tensor(_mixed_index(B, Smax, seed=bk), device=cuda)
    tbl = torch.arange(B * nk, dtype=torch.int32, device=cuda).reshape(B, nk)
    dense = ops.decode_attention(q, kc, vc, index)
    paged = ops.decode_attention_paged(q, kc.reshape(B * nk, bk, KV, hd),
                                       vc.reshape(B * nk, bk, KV, hd), tbl,
                                       index)
    assert torch.equal(dense, paged)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KV,G,hd,bk,nk", [(8, 2, 8, 128, 8, 128),
                                             (8, 32, 1, 80, 8, 128)])
def test_decode_attention_kernels_are_deterministic(cuda, dtype, B, KV, G, hd,
                                                    bk, nk):
    """Two identical K1 calls, and two identical K5 calls, give bitwise
    equal outputs (the splits merge in a fixed order, without atomics)."""
    q, kp, vp, tbl, index = _paged_inputs(cuda, dtype, B, nk, bk, KV, G, hd,
                                          seed=hd)
    kc, vc = (p[1:].reshape(B, nk * bk, KV, hd) for p in (kp, vp))
    assert torch.equal(ops.decode_attention(q, kc, vc, index),
                       ops.decode_attention(q, kc, vc, index))
    assert torch.equal(ops.decode_attention_paged(q, kp, vp, tbl, index),
                       ops.decode_attention_paged(q, kp, vp, tbl, index))


@pytest.mark.cuda
@pytest.mark.parametrize("new_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cache_paged_update_kernel_is_exact(cuda, dtype, new_dtype):
    g = torch.Generator(device=cuda).manual_seed(1)
    cache = torch.randn(1025, 8, 2, 128, generator=g, device=cuda).to(dtype)
    new = torch.randn(8, 2, 128, generator=g, device=cuda).to(new_dtype)
    blk = torch.tensor([1, 1024, 7, 500, 33, 1, 900, 64], dtype=torch.int32,
                       device=cuda)
    off = torch.tensor([0, 7, 3, 5, 1, 6, 2, 4], dtype=torch.int32,
                       device=cuda)
    want = ref.cache_paged_update_ref(cache.clone(), new, blk, off)
    ops.cache_paged_update(cache, new, blk, off)
    assert torch.equal(cache, want)


@pytest.mark.cuda
def test_fused_sample_kernel_matches_plain(cuda):
    B, V = 8, 151936
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.standard_normal((B, V), dtype=np.float32))
    logits[0, [3, V - 2]] = logits[0].max() + 1.0      # tie: first index wins
    logits = logits.to(cuda)
    seed, rid, pos = (torch.from_numpy(rng.integers(
        -2**31, 2**31 - 1, size=B, dtype=np.int64).astype(np.int32)).to(cuda)
        for _ in range(3))
    greedy = torch.zeros(B, device=cuda)
    assert torch.equal(ops.fused_sample(logits, seed, rid, pos, greedy),
                       ref.fused_sample_ref(logits, seed, rid, pos, greedy))
    # top-k runs the plain version on the card, as the reference routes it
    # to its oracle: the CPU's tokens
    temp = torch.tensor([0.0, 0.7, 1.0, 0.0, 1.3, 0.5, 2.0, 0.7],
                        device=cuda)
    for k in (1, 5, 50):
        got = ops.fused_sample(logits, seed, rid, pos, temp, top_k=k)
        assert got.is_cuda
        assert torch.equal(got.cpu(), ref.fused_sample_ref(
            logits.cpu(), seed.cpu(), rid.cpu(), pos.cpu(), temp.cpu(),
            top_k=k))
    bits, g = sample_noise(seed, rid, pos, V)
    want_bits = ref.sample_bits(seed.cpu(), rid.cpu(), pos.cpu(), V)
    assert torch.equal(bits.cpu(), want_bits)
    torch.testing.assert_close(g.cpu(), ref.gumbel_noise(want_bits),
                               rtol=1e-6, atol=1e-6)


def _row_write_inputs(cuda, dtype, new_dtype, shape, pitch, seed):
    """A (B, S, KV, hd) cache and (B, KV, hd) new rows in the given dtypes;
    pitch > hd lays each (KV, hd) row out with a wider pitch, so no row
    starts on 16 bytes."""
    B, S, KV, hd = shape
    rng = np.random.default_rng(seed)
    cache = torch.from_numpy(rng.standard_normal(
        (B, S, KV * pitch), dtype=np.float32)).to(cuda, dtype)
    if pitch == hd:
        new = torch.from_numpy(rng.standard_normal(
            (B, KV, hd), dtype=np.float32)).to(cuda, new_dtype)
        return cache.view(B, S, KV, hd), new
    new = torch.from_numpy(rng.standard_normal(
        (B, KV * pitch + 1), dtype=np.float32)).to(cuda, new_dtype)
    return cache[..., :KV * hd].view(B, S, KV, hd), \
        new[:, 1:KV * hd + 1].view(B, KV, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("new_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,pitch", [((8, 1024, 32, 80), 80),
                                         ((8, 1024, 2, 128), 128),
                                         ((3, 50, 1, 10), 10),
                                         ((4, 64, 2, 64), 65)])
def test_row_writes_take_any_row(cuda, dtype, new_dtype, shape, pitch):
    """K2 and K6 a 16-byte vector a thread: zamba2's (32, 80) rows, qwen's
    (2, 128), a row of 10 elements (a partial vector) and rows off 16-byte
    boundaries (element loads and stores), exact in every dtype pair."""
    B, S, KV, hd = shape
    cache, new = _row_write_inputs(cuda, dtype, new_dtype, shape, pitch,
                                   seed=hd)
    if pitch != hd:
        assert not dec._rows_vec(cache, new)
    slot = torch.arange(B, dtype=torch.int32, device=cuda) * 7 % S
    want = ref.cache_ring_update_ref(cache.clone(), new, slot)
    ops.cache_ring_update(cache, new, slot)
    assert torch.equal(cache, want)
    pool = cache.reshape(B * S // 2, 2, KV, hd) if pitch == hd else cache
    blk = (torch.arange(B, dtype=torch.int32, device=cuda) * 5 + 1) % \
        pool.shape[0]
    off = torch.arange(B, dtype=torch.int32, device=cuda) % pool.shape[1]
    want = ref.cache_paged_update_ref(pool.clone(), new, blk, off)
    ops.cache_paged_update(pool, new, blk, off)
    assert torch.equal(pool, want)


def _write_index(B, Smax, seed):
    """Mixed fresh and wrapped rows, with row 0 writing key 0 (split 0),
    row 1 key Smax - 1 (the last split) and row 2 wrapped onto key 5."""
    index = _mixed_index(B, Smax, seed)
    index[:3] = [0, Smax - 1, 2 * Smax + 5][:B]
    return index


def _split_plan_forced(monkeypatch, split_len):
    """K1/K5 under the default plan (None), one split, or 64-key splits."""
    if split_len == "one":
        monkeypatch.setattr(dec, "split_plan", lambda B, KV, Smax, sm: (
            -(-Smax // dec.DEC_TILE) * dec.DEC_TILE, 1))
    elif split_len is not None:
        monkeypatch.setattr(dec, "split_plan", lambda B, KV, Smax, sm: (
            split_len, -(-Smax // split_len)))


@pytest.mark.cuda
@pytest.mark.parametrize("split_len", [None, "one", 64])
@pytest.mark.parametrize("new_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Smax,KV,G,hd", [(8, 1024, 2, 8, 128),
                                            (8, 1024, 32, 1, 80),
                                            (4, 300, 2, 16, 128),
                                            (3, 100, 4, 1, 80),
                                            (8, 1024, 16, 1, 128),
                                            (8, 2048, 4, 7, 128),
                                            (8, 1024, 16, 1, 64)])
def test_decode_attention_write_equals_unfused_bitwise(
        cuda, monkeypatch, dtype, new_dtype, split_len, B, Smax, KV, G, hd):
    """The write instance of K1 against K2, K2, K1: output and both caches
    bitwise, G 1, 7 (a block's eighth register head empty: a load or store
    past the mask would touch the next KV head), 8 and 16 (two blocks a KV
    head cover the written key), hd 64, 80 and 128, one split and many."""
    _split_plan_forced(monkeypatch, split_len)
    q, kc, vc = (torch.from_numpy(a).to(cuda, dtype)
                 for a in _qkv(Smax + G, B, 1, Smax, KV * G, KV, hd))
    _, kn, vn = (torch.from_numpy(a[:, 0]).to(cuda, new_dtype)
                 for a in _qkv(hd, B, 1, 1, KV, KV, hd))
    index = torch.as_tensor(_write_index(B, Smax, seed=G), device=cuda)
    kf, vf = kc.clone(), vc.clone()
    out = ops.decode_attention_write(q, kn, vn, kf, vf, index)
    slot = torch.remainder(index, Smax)
    ops.cache_ring_update(kc, kn, slot)
    ops.cache_ring_update(vc, vn, slot)
    assert torch.equal(out, ops.decode_attention(q, kc, vc, index))
    assert torch.equal(kf, kc) and torch.equal(vf, vc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_write_unaligned_rows_equal_unfused(cuda, dtype):
    """q, caches and new rows off 16-byte boundaries (q at row pitch
    hd + 1, the rest one element past an aligned start): element loads and
    stores, still bitwise."""
    B, Smax, KV, G, hd = 3, 200, 2, 4, 64
    rng = np.random.default_rng(21)
    q = torch.from_numpy(rng.standard_normal(
        (B, 1, KV * G, hd + 1), dtype=np.float32)).to(cuda, dtype)[..., :hd]

    def shifted(*shape):
        flat = torch.from_numpy(rng.standard_normal(
            math.prod(shape) + 1, dtype=np.float32)).to(cuda, dtype)
        return flat[1:].view(shape)

    kc, vc = shifted(B, Smax, KV, hd), shifted(B, Smax, KV, hd)
    kn, vn = shifted(B, KV, hd), shifted(B, KV, hd)
    assert kc.data_ptr() % 16 and kn.data_ptr() % 16
    index = torch.as_tensor(_write_index(B, Smax, seed=5), device=cuda)
    kf, vf = kc.clone(), vc.clone()
    out = ops.decode_attention_write(q, kn, vn, kf, vf, index)
    slot = torch.remainder(index, Smax)
    ops.cache_ring_update(kc, kn, slot)
    ops.cache_ring_update(vc, vn, slot)
    assert torch.equal(out, ops.decode_attention(q, kc, vc, index))
    assert torch.equal(kf, kc) and torch.equal(vf, vc)


def _paged_write_unfused(q, kn, vn, kp, vp, tbl, index):
    """K6, K6, K5 on the pools in place, as the model ran them before."""
    B, nk = tbl.shape
    bk = kp.shape[1]
    rpos = torch.remainder(index, nk * bk)
    blk = tbl[torch.arange(B, device=tbl.device), (rpos // bk).long()]
    ops.cache_paged_update(kp, kn, blk, rpos % bk)
    ops.cache_paged_update(vp, vn, blk, rpos % bk)
    return ops.decode_attention_paged(q, kp, vp, tbl, index)


@pytest.mark.cuda
@pytest.mark.parametrize("split_len", [None, "one"])
@pytest.mark.parametrize("new_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bk", [1, 8])
@pytest.mark.parametrize("KV,G,hd", [(2, 8, 128), (32, 1, 80), (2, 16, 128),
                                     (16, 1, 128), (4, 7, 128), (16, 1, 64)])
def test_decode_attention_paged_write_equals_unfused_bitwise(
        cuda, monkeypatch, dtype, new_dtype, split_len, bk, KV, G, hd):
    """The write instance of K5 against K6, K6, K5 through a shuffled
    table: output and both pools bitwise."""
    _split_plan_forced(monkeypatch, split_len)
    B = 8
    nk = 1024 // bk
    q, kp, vp, tbl, _ = _paged_inputs(cuda, dtype, B, nk, bk, KV, G, hd,
                                      seed=bk + G)
    _, kn, vn = (torch.from_numpy(a[:, 0]).to(cuda, new_dtype)
                 for a in _qkv(hd, B, 1, 1, KV, KV, hd))
    index = torch.as_tensor(_write_index(B, nk * bk, seed=bk), device=cuda)
    kf, vf = kp.clone(), vp.clone()
    out = ops.decode_attention_paged_write(q, kn, vn, kf, vf, tbl, index)
    assert torch.equal(out, _paged_write_unfused(q, kn, vn, kp, vp, tbl,
                                                 index))
    assert torch.equal(kf, kp) and torch.equal(vf, vp)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_write_inactive_rows_on_the_trash_block(cuda, dtype):
    """Rows 5..7 are inactive: their table rows all name the trash block 0,
    so their writes collide there.  Active rows' outputs and every pool
    block but the trash block equal the unfused path bitwise."""
    B, KV, G, hd, bk, nk = 8, 2, 8, 128, 8, 128
    q, kp, vp, tbl, _ = _paged_inputs(cuda, dtype, B, nk, bk, KV, G, hd,
                                      seed=99)
    tbl[5:] = 0
    _, kn, vn = (torch.from_numpy(a[:, 0]).to(cuda, dtype)
                 for a in _qkv(7, B, 1, 1, KV, KV, hd))
    index = torch.as_tensor(_write_index(B, nk * bk, seed=3), device=cuda)
    index[5:] = torch.tensor([0, 8, 700], dtype=torch.int32)  # 5, 6 collide
    kf, vf = kp.clone(), vp.clone()
    out = ops.decode_attention_paged_write(q, kn, vn, kf, vf, tbl, index)
    want = _paged_write_unfused(q, kn, vn, kp, vp, tbl, index)
    assert torch.equal(out[:5], want[:5])
    assert torch.equal(kf[1:], kp[1:]) and torch.equal(vf[1:], vp[1:])


def _counters(rng, B, cuda):
    return tuple(torch.from_numpy(rng.integers(
        -2**31, 2**31 - 1, size=B, dtype=np.int64).astype(np.int32)).to(cuda)
        for _ in range(3))


def _sample(monkeypatch, split_len, *args):
    """fused_sample under a forced split plan of ``split_len`` columns a
    range (None: its own plan)."""
    with monkeypatch.context() as m:
        if split_len is not None:
            m.setattr(smp, "split_plan",
                      lambda B, V, sm: (split_len, -(-V // split_len)))
        return smp.fused_sample(*args)


def _split_lens(V):
    """The default plan and forced ones: one vector a split, a few, the
    served plans' 1000 and 4608, and one split for the whole row."""
    return (None, 4, 64, 1000, 4608, -(-V // 4) * 4)


@pytest.mark.cuda
@pytest.mark.parametrize("V", [1, 3, 4, 1000, 32000, 50304, 65024, 151936,
                               151937, 152064, 256206])
def test_fused_sample_greedy_equals_argmax_for_every_split(cuda, monkeypatch, V):
    """Greedy tokens bitwise equal to torch.argmax and to the plain version
    whatever the split plan (the pair order is total)."""
    B = 8
    rng = np.random.default_rng(V)
    logits = torch.from_numpy(rng.standard_normal((B, V), dtype=np.float32))
    if V > 1:      # a repeated maximum in one row
        logits[1, [V // 3, V - 1]] = logits[1].max() + 1.0
    logits = logits.to(cuda)
    seed, rid, pos = _counters(rng, B, cuda)
    greedy = torch.zeros(B, device=cuda)
    want = torch.argmax(logits, dim=1).to(torch.int32)
    assert torch.equal(ref.fused_sample_ref(logits, seed, rid, pos, greedy),
                       want)
    assert torch.equal(ops.fused_sample(logits, seed, rid, pos, greedy), want)
    for split_len in _split_lens(V):
        got = _sample(monkeypatch, split_len, logits, seed, rid, pos, greedy)
        assert torch.equal(got, want), split_len


@pytest.mark.cuda
@pytest.mark.parametrize("split_len", [4, 8, 1000, 4608])
def test_fused_sample_ties_across_a_split_boundary(cuda, monkeypatch, split_len):
    """Equal maxima on both sides of a split boundary, in one split, in
    distant splits and three at once: the first index wins every time."""
    B, V = 6, 151936
    rng = np.random.default_rng(split_len)
    logits = torch.from_numpy(rng.standard_normal((B, V), dtype=np.float32))
    k = 3 * split_len                          # a split boundary
    ties = [(k - 1, k), (k, k + 1), (k - 1, V - 1), (0, k), (k + 1, k, k - 1),
            (V - 1, k)]
    for b, cols in enumerate(ties):
        logits[b, list(cols)] = logits[b].max() + 1.0
    logits = logits.to(cuda)
    seed, rid, pos = _counters(rng, B, cuda)
    greedy = torch.zeros(B, device=cuda)
    want = torch.tensor([min(c) for c in ties], dtype=torch.int32,
                        device=cuda)
    assert torch.equal(torch.argmax(logits, dim=1).to(torch.int32), want)
    for sl in (None, split_len):
        got = _sample(monkeypatch, sl, logits, seed, rid, pos, greedy)
        assert torch.equal(got, want), sl


@pytest.mark.cuda
def test_fused_sample_nan_and_all_inf_rows(cuda, monkeypatch):
    """NaN above everything (the first NaN wins), an all -inf row takes
    index 0, as torch.argmax does."""
    B, V = 5, 32000
    rng = np.random.default_rng(9)
    logits = torch.from_numpy(rng.standard_normal((B, V), dtype=np.float32))
    logits[0, [17000, 20000, 3]] = float("nan")
    logits[1] = float("-inf")
    logits[2, 5] = float("nan")
    logits[3] = float("-inf")
    logits[3, V - 1] = -1e30
    logits[4, [100, 31000]] = float("inf")
    logits = logits.to(cuda)
    seed, rid, pos = _counters(rng, B, cuda)
    greedy = torch.zeros(B, device=cuda)
    want = torch.argmax(logits, dim=1).to(torch.int32)
    assert want.tolist() == [3, 0, 5, V - 1, 100]
    assert torch.equal(torch.argmax(logits.cpu(), dim=1).to(torch.int32),
                       want.cpu())
    for split_len in (None, 4, 1000, 32000):
        got = _sample(monkeypatch, split_len, logits, seed, rid, pos, greedy)
        assert torch.equal(got, want), split_len


def _gumbel_max_ok(logits, got, seed, rid, pos, t):
    """The token holds the maximum of logits / t + g (g from the plain
    version), up to a near-tie that a last-ulp difference in g can flip."""
    V = logits.shape[1]
    g = ref.gumbel_noise(ref.sample_bits(seed.cpu(), rid.cpu(), pos.cpu(), V))
    score = logits.float().cpu() / t + g
    best = score.max(dim=1).values
    at = score.gather(1, got.long().cpu()[:, None])[:, 0]
    return bool(torch.all(at >= best - 1e-5 * best.abs()))


@pytest.mark.cuda
def test_fused_sample_reads_unaligned_rows(cuda, monkeypatch):
    """Row views whose start is not on 16 bytes (an odd row stride, an
    offset base) take the kernel's element loads, greedy and sampled."""
    B, V = 4, 32000
    rng = np.random.default_rng(11)
    base = torch.from_numpy(rng.standard_normal((B, V + 1),
                                                dtype=np.float32)).to(cuda)
    seed, rid, pos = _counters(rng, B, cuda)
    greedy, temp = torch.zeros(B, device=cuda), torch.full((B,), 0.9,
                                                           device=cuda)
    for view in (base[:, :V], base[:, 1:]):
        assert view.stride(0) == V + 1
        want = torch.argmax(view, dim=1).to(torch.int32)
        for split_len in (None, 4, 1000):
            assert torch.equal(_sample(monkeypatch, split_len, view, seed,
                                       rid, pos, greedy), want)
            got = _sample(monkeypatch, split_len, view, seed, rid, pos, temp)
            assert _gumbel_max_ok(view, got, seed, rid, pos, 0.9)


@pytest.mark.cuda
@pytest.mark.parametrize("V", [32000, 50304, 65024, 151936, 152064,
                               256206])
def test_fused_sample_is_deterministic(cuda, monkeypatch, V):
    """Two identical calls give the same tokens, greedy and sampled, and
    the sampled token is the Gumbel max at every split plan."""
    B = 8
    rng = np.random.default_rng(V + 1)
    logits = torch.from_numpy(rng.standard_normal(
        (B, V), dtype=np.float32)).to(cuda)
    seed, rid, pos = _counters(rng, B, cuda)
    temp = torch.tensor([0.0, 0.7, 1.0, 0.0, 1.3, 0.5, 2.0, 0.7],
                        device=cuda)
    first = ops.fused_sample(logits, seed, rid, pos, temp)
    assert torch.equal(first, ops.fused_sample(logits, seed, rid, pos, temp))
    for split_len in _split_lens(V):
        got = _sample(monkeypatch, split_len, logits, seed, rid, pos, temp)
        assert torch.equal(got, _sample(monkeypatch, split_len, logits, seed,
                                        rid, pos, temp))
        rows = temp > 0
        assert torch.equal(got[~rows], torch.argmax(logits[~rows], dim=1)
                           .to(torch.int32))
        assert _gumbel_max_ok(logits[rows], got[rows], seed[rows], rid[rows],
                              pos[rows], temp[rows].cpu()[:, None])


def _scan_inputs(B, L, H, hd, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, hd), dtype=np.float32)
    dt = np.logaddexp(rng.standard_normal((B, L, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, L, H, N), dtype=np.float32)
    C = rng.standard_normal((B, L, H, N), dtype=np.float32)
    return x, dt, A, Bm, C


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,hd,N,chunk", [
    (1, 200, 80, 64, 64, 128),      # zamba2-2.7b's prefill: ragged
    (2, 256, 80, 64, 64, 128),      # aligned
    (1, 100, 2, 8, 4, 64),          # the reference's ragged case
    (2, 64, 4, 16, 8, 32),
    (2, 130, 3, 40, 16, 128),       # hd not a multiple of 32
    (1, 1, 4, 16, 8, 128),          # one token
    (1, 63, 4, 64, 64, 128),        # one chunk, ragged
    (1, 64, 80, 64, 64, 128),       # zamba2's chunked prefill: one chunk
    (1, 65, 4, 64, 64, 128),        # one token into a second chunk
    (1, 129, 4, 64, 64, 128),
    (1, 1000, 4, 64, 64, 128),
    (1, 2048, 80, 64, 64, 128),     # a long prompt: 32 chunks
    (2, 150, 3, 40, 8, 128),        # hd and N not multiples of 16
    (1, 97, 2, 10, 6, 64),          # rows not on 16 bytes: element copies
    (1, 130, 2, 128, 128, 128),     # the widest tiles
    (2, 77, 3, 8, 8, 10),           # zamba2's smoke widths, a short chunk
])
def test_ssm_scan_kernel_matches_plain(cuda, B, L, H, hd, N, chunk):
    """y and the final state within atol = rtol = 3e-4 (the reference's
    Pallas-vs-oracle tolerance: chunked and sequential sums round
    differently)."""
    args = [torch.from_numpy(a).to(cuda)
            for a in _scan_inputs(B, L, H, hd, N, seed=L + H)]
    before = ops.ssm_scan.launches
    y = ops.ssm_scan(*args, chunk=chunk)
    y2, h = ops.ssm_scan(*args, chunk=chunk, return_state=True)
    assert ops.ssm_scan.launches == before + 2
    want_y, want_h = ref.ssm_scan_ref(*args, return_state=True)
    torch.testing.assert_close(y, want_y, atol=3e-4, rtol=3e-4)
    assert torch.equal(y, y2)
    torch.testing.assert_close(h, want_h, atol=3e-4, rtol=3e-4)


@pytest.mark.cuda
def test_ssm_scan_kernel_reads_the_model_layout(cuda):
    """x, B and C as views into one (B, L, di + 2N) conv output, as Mamba2
    hands them over: strides, not copies."""
    Bsz, L, H, hd, N = 2, 150, 8, 64, 64
    di = H * hd
    rng = np.random.default_rng(5)
    conv = torch.from_numpy(rng.standard_normal(
        (Bsz, L, di + 2 * N), dtype=np.float32)).to(cuda)
    x = conv[..., :di].reshape(Bsz, L, H, hd)
    Bm = conv[..., di:di + N][:, :, None, :].expand(Bsz, L, H, N)
    C = conv[..., di + N:][:, :, None, :].expand(Bsz, L, H, N)
    assert not x.is_contiguous() and Bm.stride(2) == 0
    _, dt, A, _, _ = (torch.from_numpy(a).to(cuda)
                      for a in _scan_inputs(Bsz, L, H, hd, N, seed=6))
    y, h = ops.ssm_scan(x, dt, A, Bm, C, return_state=True)
    want_y, want_h = ref.ssm_scan_ref(x, dt, A, Bm, C, return_state=True)
    torch.testing.assert_close(y, want_y, atol=3e-4, rtol=3e-4)
    torch.testing.assert_close(h, want_h, atol=3e-4, rtol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [64, 200])
def test_ssm_scan_kernel_takes_one_group_for_every_head(cuda, L):
    """B and C with a head stride of 0 (Mamba2 with one group hands them
    over so) equal the same values copied per head."""
    Bsz, H, hd, N = 2, 8, 64, 64
    x, dt, A, _, _ = (torch.from_numpy(a).to(cuda)
                      for a in _scan_inputs(Bsz, L, H, hd, N, seed=L))
    rng = np.random.default_rng(L + 1)
    Bg, Cg = (torch.from_numpy(rng.standard_normal(
        (Bsz, L, 1, N), dtype=np.float32)).to(cuda) for _ in range(2))
    Bv, Cv = Bg.expand(Bsz, L, H, N), Cg.expand(Bsz, L, H, N)
    assert Bv.stride(2) == 0
    y, h = ops.ssm_scan(x, dt, A, Bv, Cv, return_state=True)
    y2, h2 = ops.ssm_scan(x, dt, A, Bv.contiguous(), Cv.contiguous(),
                          return_state=True)
    assert torch.equal(y, y2) and torch.equal(h, h2)
    want_y, want_h = ref.ssm_scan_ref(x, dt, A, Bv, Cv, return_state=True)
    torch.testing.assert_close(y, want_y, atol=3e-4, rtol=3e-4)
    torch.testing.assert_close(h, want_h, atol=3e-4, rtol=3e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("L", [64, 200, 2048])
def test_ssm_scan_kernel_is_deterministic(cuda, L):
    """Two identical calls give bitwise-equal y and final state."""
    args = [torch.from_numpy(a).to(cuda)
            for a in _scan_inputs(1, L, 80, 64, 64, seed=3)]
    y, h = ops.ssm_scan(*args, return_state=True)
    y2, h2 = ops.ssm_scan(*args, return_state=True)
    assert torch.equal(y, y2) and torch.equal(h, h2)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["flash_attention", "ssm_scan"])
def test_prefill_kernels_refuse_inputs_that_need_a_gradient(cuda, kernel):
    """The kernels fill their outputs through ctypes, which autograd cannot
    see: with grad enabled and an input that requires it the call raises,
    under ``torch.no_grad`` (as serving runs) it launches, and the same
    call on the CPU runs the differentiable plain version."""
    from repro_torch.kernels._lib import NoBackwardError
    if kernel == "flash_attention":
        args = [torch.from_numpy(a).to(cuda)
                for a in _qkv(1, 1, 16, 16, 4, 2, 64)]
        call = lambda *a: ops.flash_attention(*a, causal=True)
    else:
        args = [torch.from_numpy(a).to(cuda)
                for a in _scan_inputs(1, 64, 4, 64, 64, seed=1)]
        call = ops.ssm_scan
    args[0].requires_grad_(True)
    before = ops.launch_counts()[kernel]
    with pytest.raises(NoBackwardError, match="no backward"):
        call(*args)
    assert ops.launch_counts()[kernel] == before
    with torch.no_grad():
        call(*args)
    assert ops.launch_counts()[kernel] == before + 1
    cpu = [a.detach().cpu().requires_grad_(a.requires_grad) for a in args]
    call(*cpu).sum().backward()
    assert cpu[0].grad is not None


@pytest.mark.cuda
def test_ssm_scan_smem_reckoning_matches_the_source(cuda):
    """The wrapper's shared-memory reckoning is the CUDA source's own."""
    from repro_torch.kernels import _lib
    lib = _lib.load()
    for hd in range(1, ssp.MAX_WIDTH + 1):
        for N in (1, 4, 8, 13, 64, 128):
            state, out = ssp.smem_bytes(hd, N)
            assert lib.rt_ssm_smem_bytes(0, hd, N) == state, (hd, N)
            assert lib.rt_ssm_smem_bytes(1, hd, N) == out, (hd, N)


# ------------------------------------------- MoE and Mamba1 layers on the card


def _olmoe_moe(device, dtype, capacity_factor=1.25, d_ff=1024):
    """olmoe-1b-7b's MoE layer (64 experts, top 8, d 2048), weights from a
    seed."""
    from repro_torch.models import MoECfg
    from repro_torch.models.moe import MoE
    g = torch.Generator(device=device).manual_seed(0)
    mcfg = MoECfg(n_experts=64, top_k=8, d_ff_expert=d_ff,
                  capacity_factor=capacity_factor)
    return MoE(2048, mcfg, dtype=dtype, generator=g, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("N", [8, 200])
@pytest.mark.parametrize("capacity_factor", [1.25, 8.0])
def test_moe_is_repeatable_on_the_card(cuda, N, capacity_factor):
    """bf16 at olmoe's width: two identical calls bitwise equal, output and
    aux (the combine sums in a fixed order, no atomics), all on the card;
    tokens drop at N = 200 with the published capacity factor 1.25 and
    never with E/K = 8."""
    moe = _olmoe_moe(cuda, torch.bfloat16, capacity_factor)
    g = torch.Generator(device=cuda).manual_seed(N)
    x = torch.randn(1, N, 2048, generator=g, device=cuda).to(torch.bfloat16)
    with torch.no_grad():
        y, aux = moe(x)
        y2, aux2 = moe(x)
    assert y.device == x.device and y.dtype == torch.bfloat16
    assert all(v.device == x.device for v in aux.values())
    assert torch.equal(y, y2)
    assert all(torch.equal(aux[k], aux2[k]) for k in aux)
    drops = aux["drop_frac"].item()
    assert drops > 0 if (N == 200 and capacity_factor == 1.25) else drops == 0


@pytest.mark.cuda
def test_moe_on_the_card_matches_the_cpu(cuda):
    """float32, 200 tokens at capacity factor 1.25: the card routes and
    drops exactly as the CPU does, y within 1e-4."""
    import copy
    moe = _olmoe_moe("cpu", torch.float32, d_ff=128)
    gpu = copy.deepcopy(moe).to(cuda)
    x = torch.randn(200, 2048, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        p, e, _, _ = moe.route(x)
        gp, ge, _, _ = gpu.route(x.to(cuda))
        y, dropped, counts = moe.dispatch_compute_combine(x, e, p, 31)
        gy, gdropped, gcounts = gpu.dispatch_compute_combine(
            x.to(cuda), ge, gp, 31)
    assert torch.equal(ge.cpu(), e) and bool(dropped.any())
    assert torch.equal(gdropped.cpu(), dropped)
    assert torch.equal(gcounts.cpu(), counts)
    torch.testing.assert_close(gy.cpu(), y, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_mamba1_on_the_card_matches_the_cpu(cuda):
    """One falcon-mamba-7b layer at full width in float32, a 200-token
    prompt: output and final state within 1e-4 of the CPU's, then one
    decode step; two identical calls on the card bitwise equal."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models.mamba import Mamba1
    cfg = get_config("falcon-mamba-7b", n_layers=1, dtype="float32")
    m = Mamba1(cfg, generator=torch.Generator().manual_seed(0))
    gm = copy.deepcopy(m).to(cuda)
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(1, 200, cfg.d_model, generator=gen)
    x1 = torch.randn(1, 1, cfg.d_model, generator=gen)
    with torch.no_grad():
        y, st = m(x, return_state=True)
        gy, gst = gm(x.to(cuda), return_state=True)
        gy2, _ = gm(x.to(cuda), return_state=True)
        assert torch.equal(gy, gy2)
        torch.testing.assert_close(gy.cpu(), y, atol=1e-4, rtol=1e-4)
        for n in ("h", "conv"):
            torch.testing.assert_close(gst[n].cpu(), st[n], atol=1e-4,
                                       rtol=1e-4)
        st = {n: v.contiguous() for n, v in st.items()}
        gst = {n: v.contiguous() for n, v in gst.items()}
        d, _ = m.decode(x1, st)
        gd, _ = gm.decode(x1.to(cuda), gst)
    torch.testing.assert_close(gd.cpu(), d, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(gst["h"].cpu(), st["h"], atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_cross_decoder_block_on_the_card_matches_the_cpu(cuda):
    """One seamless-m4t-medium decoder layer at full width in float32: one
    decode step of 8 rows at their own positions over a 1024-long self
    ring (K1's write instance) and a cross pool whose rows hold encoder
    lengths 128 to 1024 (plain masked attention): output, self cache and
    the untouched cross pool within 1e-4 of the CPU's."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models.blocks import CrossDecoderBlock
    from repro_torch.models.rotary import rope_angles, text_positions
    cfg = get_config("seamless-m4t-medium", n_layers=1, dtype="float32")
    blk = CrossDecoderBlock(cfg, generator=torch.Generator().manual_seed(0))
    gblk = copy.deepcopy(blk).to(cuda)
    B, Smax, KV, hd = 8, 1024, cfg.n_kv_heads, cfg.hd
    gen = torch.Generator().manual_seed(3)
    state = {"self": {n: torch.randn(B, Smax, KV, hd, generator=gen)
                      for n in ("k", "v")},
             "cross": {n: torch.randn(B, Smax, KV, hd, generator=gen)
                       for n in ("k", "v")}}
    x = torch.randn(B, 1, cfg.d_model, generator=gen)
    index = torch.tensor([0, 5, 200, 511, 1023, 77, 640, 300],
                         dtype=torch.int32)
    cross_len = torch.tensor([128, 1024, 333, 700, 129, 512, 1000, 256],
                             dtype=torch.int32)
    gstate = {k: {n: v.to(cuda) for n, v in t.items()}
              for k, t in state.items()}
    angles = rope_angles(text_positions(B, 1, index), hd, cfg.rope_theta)
    with torch.no_grad():
        y, _ = blk.decode(x, state, index, angles=angles,
                          cross_len=cross_len)
        before = ops.launch_counts()["decode_attention_write"]
        gy, _ = gblk.decode(x.to(cuda), gstate, index.to(cuda),
                            angles=angles.to(cuda),
                            cross_len=cross_len.to(cuda))
    assert ops.launch_counts()["decode_attention_write"] == before + 1
    torch.testing.assert_close(gy.cpu(), y, atol=1e-4, rtol=1e-4)
    for k in ("self", "cross"):
        for n in ("k", "v"):
            torch.testing.assert_close(gstate[k][n].cpu(), state[k][n],
                                       atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-2.7b", "olmoe-1b-7b",
                                  "falcon-mamba-7b", "qwen2-vl-7b",
                                  "seamless-m4t-medium"])
def test_train_route_gradients_on_the_card_match_the_cpu(cuda, arch):
    """One train-route forward and backward (``steps.loss_and_grads``: the
    loss of ``LM.forward(..., train=True)``) at smoke width in float32, 64
    tokens: the loss within 1e-4 relative and every gradient leaf within
    1e-4 of its largest magnitude of the CPU's, and no kernel launched (K4
    and K7 stay on the serve route)."""
    import copy
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import steps
    from repro_torch.models.transformer import LM
    cfg = get_smoke_config(arch)
    model = LM(cfg, device="cpu")
    gmodel = copy.deepcopy(model).to(cuda)
    gen = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 64), generator=gen),
             "labels": torch.randint(0, cfg.vocab, (2, 64), generator=gen)}
    if cfg.family == "vlm":
        batch["patches"] = torch.randn(2, cfg.n_vision_patches, cfg.d_model,
                                       generator=gen)
    if cfg.enc_dec:
        batch["frames"] = torch.randn(2, 64, cfg.d_model, generator=gen)
    (loss, _), grads = steps.loss_and_grads(model, batch)
    before = ops.launch_counts()
    (gloss, _), ggrads = steps.loss_and_grads(
        gmodel, {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert ops.launch_counts() == before
    assert abs(float(gloss) - float(loss)) <= 1e-4 * abs(float(loss))
    for k, g in grads.items():
        top = float(g.abs().max())
        err = float((ggrads[k].cpu() - g).abs().max())
        assert err <= 1e-4 * max(top, 1e-30), (k, err, top)


@pytest.mark.cuda
def test_engine_takes_a_model_built_on_the_card(cuda):
    """A model built with device="cuda" lies on cuda:0; an engine asked for
    "cuda" takes it (a trained model serves at once)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.transformer import LM
    from repro_torch.serving.engine import EngineCore
    cfg = get_smoke_config("qwen2.5-3b")
    model = LM(cfg, device="cuda")
    assert model.device == torch.device("cuda", 0)
    assert EngineCore(cfg, 16, params=model, device="cuda").params is model
    with pytest.raises(ValueError, match="params on"):
        EngineCore(cfg, 16, params=LM(cfg, device="cpu"), device="cuda")
