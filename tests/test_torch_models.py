"""The port's dense model against the JAX reference, at bridged weights.

The reference's parameters (``LM.init`` at a fixed key) go through
``repro_torch.models.bridge`` so both sides hold the same weights; inputs
are made with numpy.  On the smoke configs of qwen2.5-3b, qwen2.5-14b and
h2o-danube-1.8b (float32; danube's window of 8 makes its ring wrap) every
layer and the whole model agree within rtol = 1e-4, atol = 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import LM as RefLM
from repro.models.attention import Attention as RefAttention
from repro.models.blocks import DecoderBlock as RefDecoderBlock
from repro.models.rotary import apply_rope as ref_apply_rope
from repro.models.rotary import rope_angles as ref_rope_angles
from repro.nn import RMSNorm as RefRMSNorm
from repro.serving.transport import decode_config, encode_config

from repro_torch.configs import get_smoke_config
from repro_torch.models.bridge import from_reference
from repro_torch.models.rotary import apply_rope, rope_angles
from repro_torch.models.steps import (
    cache_axes, cache_structs, make_chunked_prefill_step, make_prefill_step,
)

ARCHS = ["qwen2.5-3b", "qwen2.5-14b", "h2o-danube-1.8b"]
RTOL, ATOL = 1e-4, 1e-5
MAX_SEQ = 24
B, S = 2, 12


def close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


@functools.lru_cache(maxsize=None)
def pair(arch):
    """(reference cfg, reference params, port model) at the same weights."""
    rcfg = ref_smoke_config(arch)
    params = jax.jit(lambda key: RefLM.init(key, rcfg)[0])(
        jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    return rcfg, params, from_reference(params, get_smoke_config(arch),
                                        device="cpu")


def layer0(params):
    return jax.tree.map(lambda p: p[0], params["blocks"])


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _angles(rcfg, batch, seq, start):
    pos = np.arange(seq, dtype=np.int32)[None] + np.reshape(start, (-1, 1))
    pos = np.broadcast_to(pos, (batch, seq))
    return (ref_rope_angles(jnp.asarray(pos), rcfg.hd, rcfg.rope_theta),
            rope_angles(torch.tensor(pos), rcfg.hd,
                        rcfg.rope_theta))


def test_config_round_trips_through_reference_codec():
    for arch in ARCHS:
        cfg = get_smoke_config(arch)
        assert decode_config(encode_config(cfg)) == ref_smoke_config(arch)
        assert dataclasses.asdict(cfg) == encode_config(ref_smoke_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_rmsnorm_and_rope_match(arch):
    rcfg, params, model = pair(arch)
    x = _x((B, S, rcfg.d_model), 1)
    want = RefRMSNorm.apply(layer0(params)["ln1"], x, eps=rcfg.norm_eps)
    close(model.blocks[0].ln1(torch.from_numpy(x)), want)
    xh = _x((B, S, rcfg.n_heads, rcfg.hd), 2)
    ja, ta = _angles(rcfg, B, S, np.array([0, 40]))
    close(ta, ja)
    close(apply_rope(torch.from_numpy(xh), ta), ref_apply_rope(xh, ja))


@pytest.mark.parametrize("arch", ARCHS)
def test_attention_and_block_match(arch):
    rcfg, params, model = pair(arch)
    lp = layer0(params)
    x = _x((B, S, rcfg.d_model), 3)
    ja, ta = _angles(rcfg, B, S, 0)
    want = RefAttention.apply(lp["attn"], x, rcfg, angles=ja, causal=True,
                              window=rcfg.sliding_window)
    close(model.blocks[0].attn(torch.from_numpy(x), angles=ta,
                               window=rcfg.sliding_window), want)
    want_blk, _ = RefDecoderBlock.apply(lp, x, rcfg, angles=ja)
    close(model.blocks[0](torch.from_numpy(x), angles=ta), want_blk)

    # one-token decode, every row at its own position (one ring-wrapped)
    Smax = RefAttention.cache_len(rcfg, MAX_SEQ)
    kv_shape = (B, Smax, rcfg.n_kv_heads, rcfg.hd)
    cache = {"k": _x(kv_shape, 4), "v": _x(kv_shape, 5)}
    index = np.array([3, Smax + 5], np.int32)
    x1 = _x((B, 1, rcfg.d_model), 6)
    ja, ta = _angles(rcfg, B, 1, index)
    tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    jcache = {n: jnp.asarray(c) for n, c in cache.items()}
    y, rc = RefAttention.decode(lp["attn"], x1, rcfg, jcache,
                                jnp.asarray(index), angles=ja)
    ty, tc = model.blocks[0].attn.decode(torch.from_numpy(x1), tcache,
                                         torch.from_numpy(index), angles=ta)
    close(ty, y)
    for n in ("k", "v"):
        close(tc[n], rc[n])
    tcache = {n: torch.from_numpy(c.copy()) for n, c in cache.items()}
    y, _ = RefDecoderBlock.decode(lp, x1, rcfg, jcache, jnp.asarray(index),
                                  angles=ja)
    close(model.blocks[0].decode(torch.from_numpy(x1), tcache,
                                 torch.from_numpy(index), angles=ta)[0], y)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_apply_prefill_and_decode_match(arch):
    rcfg, params, model = pair(arch)
    tokens = np.random.default_rng(7).integers(0, rcfg.vocab, (B, S)
                                               ).astype(np.int32)
    want, _ = RefLM.apply(params, {"tokens": jnp.asarray(tokens)}, rcfg)
    got, _ = model({"tokens": torch.from_numpy(tokens)})
    close(got, want)

    rlogits, rcache = jax.jit(lambda p, t: RefLM.prefill(
        p, {"tokens": t}, rcfg, MAX_SEQ))(params, jnp.asarray(tokens))
    tlogits, tcache = make_prefill_step(model.cfg, MAX_SEQ)(
        model, {"tokens": torch.from_numpy(tokens)})
    close(tlogits, rlogits)
    assert int(tcache["index"]) == int(rcache["index"]) == S
    for n in ("k", "v"):
        close(tcache["layers"][n], rcache["layers"][n])
    assert {n: (tuple(s), d) for n, (s, d) in
            cache_structs(model.cfg, B, MAX_SEQ)["layers"].items()} == {
        n: (tuple(tcache["layers"][n].shape), tcache["layers"][n].dtype)
        for n in ("k", "v")}
    assert cache_axes(model.cfg, B, MAX_SEQ)["layers"]["k"] == (
        "layers", "batch", "cache_seq", "kv_heads", None)

    # decode steps with a per-row index vector: row 1 restarts two slots back
    index = np.array([S, S - 2], np.int32)
    rcache = {**rcache, "index": jnp.asarray(index)}
    tcache = {**tcache, "index": torch.from_numpy(index)}
    rdecode = jax.jit(lambda p, t, c: RefLM.decode(p, t, rcfg, c))
    rng = np.random.default_rng(8)
    for _ in range(4):
        tok = rng.integers(0, rcfg.vocab, (B, 1)).astype(np.int32)
        rlogits, rcache = rdecode(params, jnp.asarray(tok), rcache)
        with torch.no_grad():
            tlogits, tcache = model.decode(torch.from_numpy(tok), tcache)
        close(tlogits, rlogits)
    np.testing.assert_array_equal(tcache["index"].numpy(), rcache["index"])
    for n in ("k", "v"):
        close(tcache["layers"][n], rcache["layers"][n])


def test_chunked_prefill_matches_one_shot():
    _, _, model = pair("qwen2.5-3b")
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, model.cfg.vocab, (1, 10)).astype(np.int32))
    one, c1 = make_prefill_step(model.cfg, MAX_SEQ)(model, {"tokens": tokens})
    chunked, c2 = make_chunked_prefill_step(model.cfg, MAX_SEQ, 4)(
        model, {"tokens": tokens})
    close(chunked, one)
    for n in ("k", "v"):
        close(c2["layers"][n], c1["layers"][n])

