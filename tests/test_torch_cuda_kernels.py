"""Each CUDA kernel of the port against its plain PyTorch version, on the
card (marked ``cuda``; skips where there is no card).  Imports no JAX, so
it runs on a machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \\
        tests/test_torch_cuda_kernels.py

Tolerances: attention atol = rtol = 1e-4 in float32 and 2e-2 in bf16 (the
plain version rounds its probabilities to the value dtype, the kernels keep
them in float32); the paged kernel equal to the dense one bitwise under an
identity table; the ring-slot and paged writes and greedy sampling exact;
the sampler's hash bits bitwise and its noise within 1e-6; the SSD scan
(float32) atol = rtol = 3e-4, the reference's own.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,Smax,KV,G,hd", [(8, 1024, 2, 8, 128),
                                            (3, 100, 2, 2, 16),
                                            (2, 4096, 8, 4, 80),
                                            (8, 1024, 32, 1, 80)])
def test_decode_attention_kernel_matches_plain(cuda, dtype, tol, B, Smax, KV,
                                               G, hd):
    q, kc, vc = (torch.from_numpy(a).to(cuda, dtype)
                 for a in _qkv(B + hd, B, 1, Smax, KV * G, KV, hd))
    index = torch.as_tensor(_mixed_index(B, Smax, seed=B), device=cuda)
    out = ops.decode_attention(q, kc, vc, index)
    want = ref.decode_attention_ref(q, kc, vc, index)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("Sq,H,KV,hd,window", [(200, 16, 2, 128, None),
                                               (64, 16, 2, 128, None),
                                               (200, 32, 8, 80, 64),
                                               (37, 4, 2, 8, None),
                                               (200, 32, 32, 80, None)])
def test_flash_attention_kernel_matches_plain(cuda, dtype, tol, Sq, H, KV, hd,
                                              window):
    q, k, v = (torch.from_numpy(a).to(cuda, dtype)
               for a in _qkv(Sq + hd, 1, Sq, Sq, H, KV, hd))
    out = ops.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


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
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("bk", [4, 6, 8, 16, 64])
def test_decode_attention_paged_kernel_matches_plain(cuda, dtype, tol, bk):
    B, KV, G, hd = 8, 2, 8, 128
    nk = max(1, 1024 // bk)
    q, kp, vp, tbl, index = _paged_inputs(cuda, dtype, B, nk, bk, KV, G, hd,
                                          seed=bk)
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
    with pytest.raises(NotImplementedError, match="top-k"):
        ops.fused_sample(logits, seed, rid, pos, greedy, top_k=5)
    bits, g = sample_noise(seed, rid, pos, V)
    want_bits = ref.sample_bits(seed.cpu(), rid.cpu(), pos.cpu(), V)
    assert torch.equal(bits.cpu(), want_bits)
    torch.testing.assert_close(g.cpu(), ref.gumbel_noise(want_bits),
                               rtol=1e-6, atol=1e-6)


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
