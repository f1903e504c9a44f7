"""The port's four serving kernels against the JAX reference.

On the CPU each wrapper of ``repro_torch.kernels.ops`` runs its plain PyTorch
version; those are held against the JAX oracles (``repro.kernels.ref``) and
the Pallas kernels in interpret mode, on the same numpy inputs: attention
within atol = rtol = 1e-5 in float32 (2e-2 against the Pallas kernel over
bf16 caches, which keeps its probabilities in float32 where the oracles
round them to bf16), the ring-slot scatter and greedy sampling exactly,
the sampler's hash bits bitwise and its Gumbel noise within 1e-6.  Decode
with the row write folded in (``decode_attention_write``) against the
reference's two ``cache_ring_update`` calls and ``decode_attention``: the
caches exactly.

``test_torch_cuda_kernels.py`` holds each CUDA kernel against its plain
version on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sample as jsample

from repro_torch.kernels import ops, ref
from repro_torch.kernels.sample import sample_noise

ATOL = RTOL = 1e-5


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _qkv(seed, B, Sq, Sk, H, KV, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, H, hd), dtype=np.float32)
    k = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    v = rng.standard_normal((B, Sk, KV, hd), dtype=np.float32)
    return q, k, v


def _index(regime, B, Smax, seed):
    rng = np.random.default_rng(seed)
    if regime == "zeros":
        return np.zeros(B, np.int32)
    if regime == "fresh":
        return rng.integers(0, Smax, size=B).astype(np.int32)
    if regime == "wrapped":
        return rng.integers(Smax, 4 * Smax, size=B).astype(np.int32)
    fresh = rng.integers(0, Smax, size=B)
    wrapped = rng.integers(Smax, 4 * Smax, size=B)
    return np.where(np.arange(B) % 2 == 0, fresh, wrapped).astype(np.int32)


# ---------------------------------------------------------------- K1 decode


@pytest.mark.parametrize("B,Smax,KV,G,hd,regime", [
    (1, 128, 1, 4, 16, "zeros"),
    (4, 128, 2, 1, 32, "wrapped"),
    (4, 256, 2, 4, 32, "mixed"),
    (3, 256, 2, 8, 16, "mixed"),
    (2, 100, 2, 2, 16, "mixed"),         # ragged Smax: the oracle's domain
    (2, 128, 2, 2, 16, "scalar"),
])
def test_decode_attention_plain_matches_reference(B, Smax, KV, G, hd, regime):
    q, kc, vc = _qkv(B * Smax + G, B, 1, Smax, KV * G, KV, hd)
    if regime == "scalar":
        index = 77
    else:
        index = _index(regime, B, Smax, seed=Smax + hd)
    out = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                               torch.from_numpy(vc), torch.as_tensor(index))
    want = jref.decode_attention_ref(q, kc, vc, jnp.asarray(index))
    np.testing.assert_allclose(out.numpy(), _np(want), atol=ATOL, rtol=RTOL)
    if Smax % 64 == 0:
        pallas = jops.decode_attention(q, kc, vc, jnp.asarray(index),
                                       block_k=64, interpret=True)
        np.testing.assert_allclose(out.numpy(), _np(pallas), atol=ATOL,
                                   rtol=RTOL)


# ------------------------------------------- K1 with the K2 write folded in


@pytest.mark.parametrize("cache_dtype,tol", [("float32", ATOL),
                                             ("bfloat16", 2e-2)])
@pytest.mark.parametrize("regime", ["fresh", "wrapped", "mixed", "scalar"])
def test_decode_attention_write_plain_matches_reference(regime, cache_dtype,
                                                        tol):
    """Index below Smax, wrapped past it, mixed per row, one int for all."""
    B, Smax, KV, G, hd = 4, 128, 2, 4, 32
    q, kc, vc = _qkv(Smax + hd, B, 1, Smax, KV * G, KV, hd)
    rng = np.random.default_rng(7)
    kn, vn = (rng.standard_normal((B, KV, hd), dtype=np.float32)
              for _ in range(2))
    index = 150 if regime == "scalar" else _index(regime, B, Smax, seed=B)
    dt = getattr(torch, cache_dtype)
    tk, tv = (torch.from_numpy(c).to(dt) for c in (kc, vc))
    before = tk.clone(), tv.clone()
    out = ops.decode_attention_write(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn), tk,
        tv, torch.as_tensor(index))
    # what the port ran before the fold, one call after another
    uk, uv = before
    slot = torch.remainder(torch.as_tensor(index).expand(B), Smax)
    ops.cache_ring_update(uk, torch.from_numpy(kn), slot)
    ops.cache_ring_update(uv, torch.from_numpy(vn), slot)
    assert torch.equal(out, ops.decode_attention(torch.from_numpy(q), uk, uv,
                                                 torch.as_tensor(index)))
    assert torch.equal(tk, uk) and torch.equal(tv, uv)
    # the reference: two ring writes (Pallas), then decode
    jslot = jnp.asarray(slot.numpy())
    jk = jops.cache_ring_update(jnp.asarray(kc).astype(cache_dtype),
                                jnp.asarray(kn), jslot, interpret=True)
    jv = jops.cache_ring_update(jnp.asarray(vc).astype(cache_dtype),
                                jnp.asarray(vn), jslot, interpret=True)
    np.testing.assert_array_equal(tk.float().numpy(), _np(jk))
    np.testing.assert_array_equal(tv.float().numpy(), _np(jv))
    jidx = jnp.asarray(index)
    np.testing.assert_allclose(
        out.numpy(), _np(jref.decode_attention_ref(q, jk, jv, jidx)),
        atol=ATOL, rtol=RTOL)
    pallas = jops.decode_attention(q, jk, jv, jidx, block_k=64,
                                   interpret=True)
    np.testing.assert_allclose(out.numpy(), _np(pallas), atol=tol, rtol=tol)


# ---------------------------------------------------------------- K4 flash


@pytest.mark.parametrize("B,Sq,H,KV,hd,window", [
    (1, 64, 4, 2, 16, None),
    (2, 64, 8, 2, 32, 8),
    (1, 50, 4, 1, 16, None),             # ragged Sq: the oracle's domain
    (1, 37, 4, 2, 80, 16),
])
def test_flash_attention_plain_matches_reference(B, Sq, H, KV, hd, window):
    q, k, v = _qkv(Sq + H + hd, B, Sq, Sq, H, KV, hd)
    out = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True, window=window)
    want = jref.flash_attention_ref(q, k, v, causal=True, window=window)
    np.testing.assert_allclose(out.numpy(), _np(want), atol=ATOL, rtol=RTOL)
    if Sq % 32 == 0:
        pallas = jops.flash_attention(q, k, v, causal=True, window=window,
                                      block_q=32, block_k=32, interpret=True)
        np.testing.assert_allclose(out.numpy(), _np(pallas), atol=ATOL,
                                   rtol=RTOL)


# ------------------------------------------------------- K2 ring-slot write


@pytest.mark.parametrize("B,Smax,KV,hd,cache_dtype", [
    (2, 24, 2, 8, "float32"),
    (4, 128, 2, 32, "float32"),
    (3, 24, 1, 32, "bfloat16"),          # float32 rows cast into the cache
])
def test_cache_ring_update_plain_is_exact(B, Smax, KV, hd, cache_dtype):
    rng = np.random.default_rng(B + Smax)
    cache = rng.standard_normal((B, Smax, KV, hd), dtype=np.float32)
    new = rng.standard_normal((B, KV, hd), dtype=np.float32)
    slot = rng.integers(0, Smax, size=B).astype(np.int32)
    jc = jnp.asarray(cache).astype(cache_dtype)
    tc = torch.from_numpy(cache).to(getattr(torch, cache_dtype))
    out = ops.cache_ring_update(tc, torch.from_numpy(new),
                                torch.from_numpy(slot))
    assert out is tc                                   # written in place
    want = jref.cache_ring_update_ref(jc, jnp.asarray(new), slot)
    pallas = jops.cache_ring_update(jc, jnp.asarray(new), jnp.asarray(slot),
                                    interpret=True)
    np.testing.assert_array_equal(tc.float().numpy(), _np(want))
    np.testing.assert_array_equal(tc.float().numpy(), _np(pallas))


# ---------------------------------------------------------------- K3 sample


def _sample_inputs(B, V, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, V), dtype=np.float32)
    logits[0, [3, V - 2]] = logits[0].max() + 1.0      # tie: first index wins
    s, r, p = (rng.integers(-2**31, 2**31 - 1, size=B, dtype=np.int64)
               .astype(np.int32) for _ in range(3))
    return logits, s, r, p


@pytest.mark.parametrize("B,V", [(4, 128), (3, 1000)])
def test_fused_sample_plain_matches_reference(B, V):
    logits, seed, rid, pos = _sample_inputs(B, V, seed=V)
    temp = np.where(np.arange(B) % 2 == 0, 0.0, 0.7).astype(np.float32)
    args = [torch.from_numpy(a) for a in (logits, seed, rid, pos, temp)]
    out = ops.fused_sample(*args).numpy()
    want = np.asarray(jref.fused_sample_ref(logits, seed, rid, pos, temp))
    pallas = np.asarray(jops.fused_sample(logits, seed, rid, pos, temp,
                                          interpret=True))
    np.testing.assert_array_equal(out, want)
    np.testing.assert_array_equal(out, pallas)
    assert out[0] == 3
    greedy = ops.fused_sample(args[0], *args[1:4],
                              torch.zeros(B, dtype=torch.float32)).numpy()
    np.testing.assert_array_equal(greedy, logits.argmax(axis=1))
    topk = ops.fused_sample(*args, top_k=5).numpy()
    np.testing.assert_array_equal(
        topk, np.asarray(jref.fused_sample_ref(logits, seed, rid, pos, temp,
                                               top_k=5)))


def test_sample_hash_bits_bitwise_and_noise_close():
    B, V = 3, 4096
    _, seed, rid, pos = _sample_inputs(B, V, seed=1)
    key = jsample._mix(jnp.uint32(jsample.GOLDEN) ^ jsample._u32(seed))
    key = jsample._mix(key ^ jsample._u32(rid))
    key = jsample._mix(key ^ jsample._u32(pos))
    want_bits = np.asarray(jsample._mix(
        key[:, None] ^ jnp.arange(V, dtype=jnp.uint32)[None, :]))
    want_u = ((want_bits >> 8).astype(np.float32) + 0.5) * (1.0 / (1 << 24))
    want_g = np.asarray(-jnp.log(-jnp.log(jnp.asarray(want_u))))
    bits, g = sample_noise(torch.from_numpy(seed), torch.from_numpy(rid),
                           torch.from_numpy(pos), V)
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32), want_bits)
    # an absolute floor: near g = 0 one ulp of the inner log is a large
    # relative error
    np.testing.assert_allclose(g.numpy(), want_g, rtol=1e-6, atol=1e-6)
