"""The port's encoder-decoder family (seamless-m4t: a bidirectional encoder,
a decoder with cross attention) against the JAX reference, on the CPU, at
bridged weights, in float32.

- ``EncoderBlock`` forward and ``CrossDecoderBlock`` forward and decode
  (per-row ``cross_len`` masks and per-row positions), ``LM`` forward,
  prefill (logits and every cache leaf, cross K/V at the encoder's length)
  and decode on TINY_CFGS["audio"] and the seamless-m4t-medium smoke
  config: within rtol = 1e-4, atol = 1e-5; positions, ``cross_len`` and
  token streams exactly equal.
- ``cross_len`` masks: decoding over a zero-padded cross pool equals
  decoding over the unpadded encoder K/V.
- ``write_slot`` zero-pads encoder-length cross K/V up to the pool's
  max_seq, as the reference's does; the paged pool pages the self K/V and
  keeps the cross K/V dense, and shares nothing.
- The reference's four enc-dec engine tests (tests/test_serving_engine.py)
  mirrored on the port, each also against the reference engine's streams:
  staggered requests of different encoder lengths equal their solo runs
  (TINY and the smoke config), a streamed decoder prompt equals a one-shot
  one, and missing, oversized or mis-shaped frames are refused at submit.
- Engine token streams equal the reference engine's on {dense, paged} x
  prefill_chunk {1, 3, None} x {greedy, temperature + top-k}; with
  ``spec_k=3`` the family serves the plain path, as in the reference; the
  serve CLI, which makes no frames, refuses the family as the reference's
  does.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY_CFGS
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch import serve as ref_serve
from repro.models import LM as RefLM
from repro.models.attention import Attention as RefAttention
from repro.models.blocks import CrossDecoderBlock as RefCrossDecoderBlock
from repro.models.blocks import EncoderBlock as RefEncoderBlock
from repro.serving import Request as RefRequest
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import ServingEngine as RefServingEngine
from repro.serving.engine import EngineCore as RefEngineCore
from repro.serving.slots import write_slot as ref_write_slot

from test_torch_hybrid import close, close_trees, leaves
from test_torch_speculative import run_staggered
from test_torch_ssm import port_cfg

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models.bridge import from_reference
from repro_torch.models.rotary import rope_angles, text_positions
from repro_torch.models.steps import (
    cache_structs, make_chunked_prefill_step, make_prefill_step,
)
from repro_torch.serving import (
    Request, SamplingParams, ServingEngine, SlotPool, make_pool,
)
from repro_torch.serving.engine import EngineCore
from repro_torch.serving.slots import write_slot

ARCHS = {"audio": None, "seamless": "seamless-m4t-medium"}
MAX_SEQ = 24
B, S, SE = 2, 12, 7


def ref_cfg(name):
    arch = ARCHS[name]
    return TINY_CFGS["audio"] if arch is None else ref_smoke_config(arch)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_configs_equal_reference():
    arch = "seamless-m4t-medium"
    assert get_config(arch) == port_cfg(ref_config(arch))
    assert get_smoke_config(arch) == port_cfg(ref_smoke_config(arch))


@functools.lru_cache(maxsize=None)
def pair(name):
    """(reference cfg, reference params, port model) at the same weights."""
    rcfg = ref_cfg(name)
    params = jax.jit(lambda key: RefLM.init(key, rcfg)[0])(
        jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    return rcfg, params, from_reference(params, port_cfg(rcfg), device="cpu")


def layer(params, tower, i=0):
    return jax.tree.map(lambda p: p[i], params[tower])


def angles(rcfg, batch, seq, start=0):
    from repro.models.rotary import rope_angles as ref_rope_angles
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32)[None]
                          + np.reshape(start, (-1, 1)), (batch, seq))
    return (ref_rope_angles(jnp.asarray(pos), rcfg.hd, rcfg.rope_theta),
            rope_angles(text_positions(batch, seq, torch.as_tensor(start)),
                        rcfg.hd, rcfg.rope_theta))


# ---------------------------------------------------------------- blocks


@pytest.mark.parametrize("name", list(ARCHS))
def test_encoder_block_matches(name):
    rcfg, params, model = pair(name)
    x = _rand((B, SE, rcfg.d_model), 1)
    ja, ta = angles(rcfg, B, SE)
    for i, blk in enumerate(model.enc_blocks):
        want = RefEncoderBlock.apply(layer(params, "enc_blocks", i), x, rcfg,
                                     angles=ja)
        with torch.no_grad():
            close(blk(torch.from_numpy(x), angles=ta), want)


@pytest.mark.parametrize("name", list(ARCHS))
def test_cross_decoder_block_forward_and_decode_match(name):
    rcfg, params, model = pair(name)
    lp = layer(params, "dec_blocks")
    blk = model.dec_blocks[0]
    x, enc = _rand((B, S, rcfg.d_model), 2), _rand((B, SE, rcfg.d_model), 3)
    ja, ta = angles(rcfg, B, S)
    want = RefCrossDecoderBlock.apply(lp, x, rcfg, enc_out=jnp.asarray(enc),
                                      angles=ja)
    with torch.no_grad():
        got, (k, v), (ck, cv) = blk(torch.from_numpy(x),
                                    enc_out=torch.from_numpy(enc), angles=ta,
                                    return_kv=True)
    close(got, want)
    rk, rv = RefCrossDecoderBlock.cross_kv(lp, jnp.asarray(enc), rcfg)
    close(ck, rk)
    close(cv, rv)

    # one decode step, rows at their own positions and encoder lengths,
    # over a cross pool padded past SE with garbage the mask must hide
    kv_shape = (B, MAX_SEQ, rcfg.n_kv_heads, rcfg.hd)
    self_c = {"k": _rand(kv_shape, 4), "v": _rand(kv_shape, 5)}
    cross = {"k": _rand(kv_shape, 6), "v": _rand(kv_shape, 7)}
    index = np.array([3, 17], np.int32)
    cross_len = np.array([SE, 2], np.int32)
    x1 = _rand((B, 1, rcfg.d_model), 8)
    ja, ta = angles(rcfg, B, 1, index)
    rstate = {"self": {n: jnp.asarray(c) for n, c in self_c.items()},
              "cross": {n: jnp.asarray(c) for n, c in cross.items()}}
    want, rnew = RefCrossDecoderBlock.decode(
        lp, x1, rcfg, rstate, jnp.asarray(index), angles=ja,
        cross_len=jnp.asarray(cross_len))
    tstate = {"self": {n: torch.from_numpy(c.copy())
                       for n, c in self_c.items()},
              "cross": {n: torch.from_numpy(c.copy())
                        for n, c in cross.items()}}
    with torch.no_grad():
        got, tnew = blk.decode(torch.from_numpy(x1), tstate,
                               torch.from_numpy(index), angles=ta,
                               cross_len=torch.from_numpy(cross_len))
    close(got, want)
    close_trees(tnew, rnew, 1e-5)
    for n in ("k", "v"):              # the cross pool is only read
        np.testing.assert_array_equal(tnew["cross"][n].numpy(), cross[n])


@pytest.mark.parametrize("cross_len", [1, 3, SE])
def test_cross_len_masks_the_padded_keys(cross_len):
    """Cross decode over a max_seq pool, rows padded past ``cross_len``
    with garbage, equals cross decode over the unpadded K/V, and the
    reference's."""
    rcfg, params, model = pair("audio")
    attn = model.dec_blocks[0].cross_attn
    ref_p = layer(params, "dec_blocks")["cross_attn"]
    kv = (_rand((B, cross_len, rcfg.n_kv_heads, rcfg.hd), 9),
          _rand((B, cross_len, rcfg.n_kv_heads, rcfg.hd), 10))
    padded = tuple(np.concatenate(
        [t, _rand((B, MAX_SEQ - cross_len) + t.shape[2:], 11 + i)], axis=1)
        for i, t in enumerate(kv))
    x1 = _rand((B, 1, rcfg.d_model), 13)
    with torch.no_grad():
        short, _ = attn.decode(torch.from_numpy(x1), None, 0,
                               cross_kv=tuple(map(torch.from_numpy, kv)))
        masked, cache = attn.decode(
            torch.from_numpy(x1), None, 0,
            cross_kv=tuple(map(torch.from_numpy, padded)),
            cross_len=cross_len)
    assert cache is None
    close(masked, short)
    want, _ = RefAttention.decode(ref_p, x1, rcfg, None, 0,
                                  cross_kv=tuple(map(jnp.asarray, padded)),
                                  cross_len=cross_len)
    close(masked, want)


# ------------------------------------------------------------------- LM


def encdec_inputs(rcfg, seed, batch=B, seq=S, enc=SE):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, rcfg.vocab, (batch, seq)
                                   ).astype(np.int32),
            "frames": rng.standard_normal((batch, enc, rcfg.d_model)
                                          ).astype(np.float32)}


@pytest.mark.parametrize("name", list(ARCHS))
def test_lm_apply_prefill_and_decode_match(name):
    rcfg, params, model = pair(name)
    inputs = encdec_inputs(rcfg, 7)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    want, _ = jax.jit(lambda p, i: RefLM.apply(p, i, rcfg))(params, jin)
    with torch.no_grad():
        got, _ = model(tin)
    close(got, want)

    rlogits, rcache = jax.jit(lambda p, i: RefLM.prefill(
        p, i, rcfg, MAX_SEQ))(params, jin)
    tlogits, tcache = make_prefill_step(model.cfg, MAX_SEQ)(model, tin)
    close(tlogits, rlogits)
    close_trees(tcache, rcache, 1e-5)
    assert tuple(tcache["cross"]["k"].shape) == (
        rcfg.n_layers, B, SE, rcfg.n_kv_heads, rcfg.hd)
    assert tcache["cross_len"].tolist() == [SE] * B
    assert int(tcache["index"]) == S
    # the cache spec sizes the cross pool at max_seq
    structs = leaves(cache_structs(model.cfg, B, MAX_SEQ))
    assert structs["/cross/k"][0] == (rcfg.n_layers, B, MAX_SEQ,
                                      rcfg.n_kv_heads, rcfg.hd)
    assert structs["/cross_len"] == ((B,), torch.int32)
    assert {k: tuple(s) for k, (s, _) in structs.items()
            if k.startswith("/self")} == {
        k: tuple(v.shape) for k, v in leaves(tcache).items()
        if k.startswith("/self")}

    # decode steps with per-row positions and per-row encoder lengths
    index = np.array([S, S - 2], np.int32)
    cross_len = np.array([SE, 3], np.int32)
    rcache = {**rcache, "index": jnp.asarray(index),
              "cross_len": jnp.asarray(cross_len)}
    tcache = {**tcache, "index": torch.from_numpy(index),
              "cross_len": torch.from_numpy(cross_len)}
    rdecode = jax.jit(lambda p, t, c: RefLM.decode(p, t, rcfg, c))
    rng = np.random.default_rng(8)
    for _ in range(3):
        tok = rng.integers(0, rcfg.vocab, (B, 1)).astype(np.int32)
        rlogits, rcache = rdecode(params, jnp.asarray(tok), rcache)
        with torch.no_grad():
            tlogits, tcache = model.decode(torch.from_numpy(tok), tcache)
        close(tlogits, rlogits)
    close_trees(tcache, rcache, 1e-5)


@pytest.mark.parametrize("chunk", [1, 4])
def test_chunked_prefill_runs_in_one_shot(chunk):
    """The encoder needs every frame: the chunked step prefills the whole
    prompt at once, as the reference's does."""
    rcfg, _, model = pair("audio")
    tin = {k: torch.from_numpy(v)
           for k, v in encdec_inputs(rcfg, 9, batch=1, seq=10).items()}
    one, c1 = make_prefill_step(model.cfg, MAX_SEQ)(model, tin)
    chunked, c2 = make_chunked_prefill_step(model.cfg, MAX_SEQ, chunk)(
        model, tin)
    assert torch.equal(chunked, one)
    assert int(c2["index"]) == 10
    close_trees(c2, c1, 0.0)


# ------------------------------------------------------------------- pool


def test_write_slot_zero_pads_cross_kv():
    """A prefill's (L, 1, S_enc, KV, hd) cross K/V land at the slot of the
    (L, slots, max_seq, KV, hd) pool, zero past S_enc, as the reference's
    ``write_slot`` puts them."""
    L, slots, KV, hd = 2, 3, 2, 8
    pool = _rand((L, slots, MAX_SEQ, KV, hd), 1)
    one = _rand((L, 1, SE, KV, hd), 2)
    want = np.asarray(ref_write_slot(jnp.asarray(pool), jnp.asarray(one), 1))
    got = write_slot(torch.from_numpy(pool.copy()), torch.from_numpy(one), 1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy()[:, 1, :SE], one[:, 0])
    assert float(np.abs(got.numpy()[:, 1, SE:]).max()) == 0.0
    np.testing.assert_array_equal(got.numpy()[:, [0, 2]], pool[:, [0, 2]])


@pytest.mark.parametrize("pool_kind", ["dense", "paged"])
def test_slot_pool_writes_an_encdec_prefill(pool_kind):
    rcfg, _, model = pair("audio")
    tin = {k: torch.from_numpy(v)
           for k, v in encdec_inputs(rcfg, 3, batch=1, seq=5).items()}
    _, one = make_prefill_step(model.cfg, MAX_SEQ)(model, tin)
    pool = make_pool(model.cfg, 3, MAX_SEQ, pool=pool_kind, block_size=4,
                     device="cpu")
    assert isinstance(pool, SlotPool)
    assert getattr(pool, "is_paged", False) == (pool_kind == "paged")
    if pool_kind == "paged":
        # self K/V page, cross K/V stay dense, nothing is shared
        assert not pool.can_share
        assert pool.cache["self"]["k"].shape[:3] == (
            rcfg.n_layers, pool.num_blocks, 4)
        pool.admit_slot(1, np.arange(5), 4)
    assert tuple(pool.cache["cross"]["k"].shape) == (
        rcfg.n_layers, 3, MAX_SEQ, rcfg.n_kv_heads, rcfg.hd)
    pool.write(one, 1)
    for n in ("k", "v"):
        c = pool.cache["cross"][n]
        np.testing.assert_array_equal(c[:, 1, :SE].numpy(),
                                      one["cross"][n][:, 0].numpy())
        assert float(c[:, 1, SE:].abs().max()) == 0.0
        assert float(c[:, [0, 2]].abs().max()) == 0.0
    assert pool.cache["cross_len"].tolist() == [0, SE, 0]
    assert pool.index.tolist() == [0, 5, 0]


# ---------------------------------------------------------------- engine


@functools.lru_cache(maxsize=None)
def cores(name="audio"):
    rcfg = ref_cfg(name)
    ref = RefEngineCore(rcfg, MAX_SEQ, seed=0)
    params = jax.tree.map(np.asarray, ref.params)
    cfg = port_cfg(rcfg)
    port = EngineCore(cfg, MAX_SEQ,
                      params=from_reference(params, cfg, device="cpu"),
                      device="cpu")
    return ref, port


def engines(name="audio", **kw):
    ref_core, port_core = cores(name)
    kw = {"slots": 2, "max_seq": MAX_SEQ, **kw}
    return (RefServingEngine(ref_core.cfg, core=ref_core, **kw),
            ServingEngine(port_core.cfg, core=port_core, **kw))


def audio_request(cls, cfg, rid, enc_len, *, prompt_len=6, gen_len=4,
                  seed=0, sampling=None):
    """tests/test_serving_engine.py's ``_audio_request``."""
    rng = np.random.default_rng((seed, rid))
    kw = {} if sampling is None else {"sampling": sampling}
    return cls(rid=rid,
               prompt=rng.integers(3, cfg.vocab, size=prompt_len
                                   ).astype(np.int32),
               gen_len=gen_len,
               frames=rng.standard_normal((enc_len, cfg.d_model)
                                          ).astype(np.float32), **kw)


def run_to_completion(eng, n, max_steps=500, now=0.0):
    done = []
    for _ in range(max_steps):
        now += 1.0
        done.extend(eng.step(now=now))
        if len(done) >= n and eng.idle:
            return {r.rid: list(r.tokens_out) for r in done}
    raise AssertionError(f"only {len(done)}/{n} completed")


def staggered(eng, cls, seed, first, second):
    """Request ``first`` admitted, two ticks, then request ``second``."""
    cfg = eng.cfg
    eng.submit(audio_request(cls, cfg, *first, seed=seed), now=0.0)
    now = 0.0
    for _ in range(2):
        now += 1.0
        eng.step(now=now)
    eng.submit(audio_request(cls, cfg, *second, seed=seed), now=now)
    return run_to_completion(eng, 2, now=now)


@pytest.mark.parametrize("name,seed", [("audio", 0), ("seamless", 3)])
def test_mixed_encoder_lengths_equal_solo(name, seed):
    """Two requests of different encoder lengths, staggered so their
    positions and cross lengths differ every tick, each give the tokens
    they give alone; the reference engine's too."""
    solo = {}
    for rid, enc_len in ((0, 5), (1, 9)):
        _, eng = engines(name, prefill_chunk=4)
        eng.submit(audio_request(Request, eng.cfg, rid, enc_len, seed=seed),
                   now=0.0)
        solo.update(run_to_completion(eng, 1))
    ref, eng = engines(name, prefill_chunk=4)
    got = staggered(eng, Request, seed, (0, 5), (1, 9))
    assert got == solo
    assert all(len(t) == 4 for t in got.values())
    assert staggered(ref, RefRequest, seed, (0, 5), (1, 9)) == got


def test_streamed_prefill_equals_one_shot():
    """The decoder prompt's tail streams through the decode tick over the
    cross K/V pooled at admission: the same tokens as a one-shot prefill,
    and as the reference's."""
    out = {}
    for chunk in (None, 3):
        ref, eng = engines(prefill_chunk=chunk, slots=1)
        for e, cls in ((ref, RefRequest), (eng, Request)):
            e.submit(audio_request(cls, e.cfg, 0, 7, prompt_len=10), now=0.0)
        out[chunk] = run_to_completion(eng, 1)
        assert run_to_completion(ref, 1) == out[chunk]
    assert out[None] == out[3]


def test_submit_rejects_missing_oversized_or_misshaped_frames():
    for eng, cls in zip(engines(slots=1), (RefRequest, Request)):
        cfg = eng.cfg
        req = audio_request(cls, cfg, 0, 5)
        req.frames = None
        with pytest.raises(ValueError):
            eng.submit(req, now=0.0)
        with pytest.raises(ValueError):      # the encoder must fit the pool
            eng.submit(audio_request(cls, cfg, 1, MAX_SEQ + 1), now=0.0)
        bad = audio_request(cls, cfg, 2, 5)
        bad.frames = np.zeros((5, cfg.d_model + 1), np.float32)
        with pytest.raises(ValueError):      # d_model mismatch
            eng.submit(bad, now=0.0)
        assert eng.scheduler.depth == 0


def audio_requests(cls, cfg, sampling):
    """5 requests of 8 prompt tokens, encoder lengths 3 to 11."""
    return [audio_request(cls, cfg, i, 3 + 2 * i, prompt_len=8, gen_len=5,
                          sampling=sampling) for i in range(5)]


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 5)])
@pytest.mark.parametrize("prefill_chunk", [1, 3, None])
@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_token_streams_equal_reference(pool, prefill_chunk, temperature,
                                       top_k):
    ref, port = engines(prefill_chunk=prefill_chunk, pool=pool)
    want = run_staggered(ref, audio_requests(
        RefRequest, ref.cfg, RefSamplingParams(temperature, top_k, seed=3)))
    got = run_staggered(port, audio_requests(
        Request, port.cfg, SamplingParams(temperature, top_k, seed=3)))
    assert got == want
    assert all(len(t) == 5 for t in got.values())
    assert port._paged == ref._paged == (pool == "paged")
    assert port.lifetime() == ref.lifetime()
    if temperature == 0.0:
        assert port.logits_pulls == 0 == ref.logits_pulls
    else:
        assert port.logits_pulls == ref.logits_pulls > 0


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_spec_k_serves_the_plain_path(pool):
    """An encoder-decoder serves plain with spec_k > 0, as in the
    reference: the streams equal the plain engine's, nothing is proposed
    and no prefix is shared."""
    ref, spec = engines(prefill_chunk=3, pool=pool, spec_k=3)
    _, plain = engines(prefill_chunk=3, pool=pool)
    sp = SamplingParams()
    want = run_staggered(plain, audio_requests(Request, plain.cfg, sp))
    assert run_staggered(spec, audio_requests(Request, spec.cfg, sp)) == want
    assert run_staggered(ref, audio_requests(
        RefRequest, ref.cfg, RefSamplingParams())) == want
    got = spec.lifetime()
    assert got == ref.lifetime()
    assert got["spec_proposed"] == 0 == got["spec_accepted"]
    assert got.get("prefix_hits", 0) == 0


def test_serve_cli_refuses_encdec_as_the_reference_does():
    """The CLI's synthetic requests carry no frames, so submit refuses
    them on both sides: an encoder-decoder serves through ServingEngine
    with frames."""
    argv = ["--arch", "seamless-m4t-medium", "--smoke", "--requests", "2",
            "--slots", "2", "--max-seq", "32", "--prompt-len", "8",
            "--gen-len", "4"]
    with pytest.raises(ValueError, match="frames"):
        ref_serve.main(argv)
    with pytest.raises(ValueError, match="frames"):
        serve.main(argv + ["--device", "cpu"])
