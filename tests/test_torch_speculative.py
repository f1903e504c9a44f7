"""The port's speculative decoding and paged engine against the JAX
reference engine, both on the CPU, at bridged weights.

- ``ngram_propose`` equals the reference's on a deterministic fuzz;
- ``make_verify_step`` gives the reference's per-lane tokens exactly and its
  logits within atol = rtol = 2e-5 (float32), on dense and paged caches;
- the engine, for (pool, spec_k) in {dense, paged} x {0, 3}, prefill_chunk
  in {1, 4, None}, greedy and temperature / top-k sampling, staggered
  arrivals, on the shared-prefix and the echo workloads: token streams and
  every ``lifetime()`` counter equal the reference's; the pool index equals
  the host positions after every tick; after ``evacuate()`` every refcount
  is 0.  A sliding-window config degenerates to dense and plain, as in the
  reference.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import LM as RefLM
from repro.models.steps import make_verify_step as ref_make_verify_step
from repro.serving import Request as RefRequest
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import ServingEngine as RefServingEngine
from repro.serving.draft import ngram_propose as ref_ngram_propose
from repro.serving.engine import EngineCore as RefEngineCore

from repro_torch.configs import get_smoke_config
from repro_torch.models.bridge import from_reference
from repro_torch.models.steps import make_verify_step
from repro_torch.serving import Request, SamplingParams, ServingEngine
from repro_torch.serving.draft import ngram_propose
from repro_torch.serving.engine import EngineCore

ARCH = "qwen2.5-3b"
MAX_SEQ = 32
BK = 4
ATOL = RTOL = 2e-5


@functools.lru_cache(maxsize=None)
def cores(arch=ARCH):
    ref = RefEngineCore(ref_smoke_config(arch), MAX_SEQ, seed=0)
    params = jax.tree.map(np.asarray, ref.params)
    cfg = get_smoke_config(arch)
    port = EngineCore(cfg, MAX_SEQ,
                      params=from_reference(params, cfg, device="cpu"),
                      device="cpu")
    return ref, port


# ---------------------------------------------------------------- workloads


def shared_prefix_requests(request_cls, sampling, vocab, n=5, *,
                           prefix_len=8, prompt_len=11, gen_len=3, seed=0):
    """tests/test_paged_pool.py's workload: one block-aligned prefix, then a
    unique tail."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(3, vocab, size=prefix_len).astype(np.int32)
    return [request_cls(rid=i, prompt=np.concatenate(
        [prefix, rng.integers(3, vocab, size=prompt_len - prefix_len
                              ).astype(np.int32)]),
        gen_len=gen_len, sampling=sampling) for i in range(n)]


def echo_requests(request_cls, sampling, vocab, n=3, *, prompt_len=12,
                  gen_len=10, period=4, seed=0):
    """tests/test_speculative.py's workload: prompts that tile a short
    phrase, so drafts fire."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        phrase = rng.integers(3, vocab, size=period)
        prompt = np.tile(phrase, prompt_len // period + 1)[:prompt_len]
        out.append(request_cls(rid=i, prompt=prompt.astype(np.int32),
                               gen_len=gen_len, sampling=sampling))
    return out


WORKLOADS = {"shared_prefix": shared_prefix_requests, "echo": echo_requests}


def run_staggered(eng, reqs, *, on_tick=None, max_steps=600):
    """Submit one request per tick, run to drain; returns the streams."""
    done, now, i = [], 0.0, 0
    for _ in range(max_steps):
        if i < len(reqs):
            eng.submit(reqs[i], now=now)
            i += 1
        now += 1.0
        done.extend(eng.step(now=now))
        if on_tick is not None:
            on_tick(eng)
        if len(done) >= len(reqs) and eng.idle:
            return {r.rid: tuple(r.tokens_out) for r in done}
    raise AssertionError(f"stalled at {len(done)}/{len(reqs)}")


def index_matches_positions(eng):
    active = np.nonzero(eng.active)[0]
    np.testing.assert_array_equal(eng.pool.index.numpy()[active],
                                  eng.pos[active])


# ------------------------------------------------------------ ngram_propose


def test_ngram_propose_equals_reference_on_fuzz():
    rng = np.random.default_rng(0)
    for _ in range(300):
        T = int(rng.integers(0, 40))
        h = rng.integers(0, int(rng.integers(2, 8)), size=T).tolist()
        k, ngram = int(rng.integers(0, 6)), int(rng.integers(1, 5))
        got = ngram_propose(h, k=k, ngram=ngram)
        want = ref_ngram_propose(h, k=k, ngram=ngram)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            ngram_propose(np.asarray(h, np.int32), k=k, ngram=ngram), want)


# ------------------------------------------------------------- verify step


def _paged_cache(cfg, B, nk, bk, seed):
    """A (L, NB, bk, KV, hd) pool with a permuted table, as numpy."""
    rng = np.random.default_rng(seed)
    NB = B * nk + 1
    shape = (cfg.n_layers, NB, bk, cfg.n_kv_heads, cfg.d_model // cfg.n_heads)
    tbl = (1 + rng.permutation(B * nk)).reshape(B, nk).astype(np.int32)
    return {"k": rng.standard_normal(shape).astype(np.float32),
            "v": rng.standard_normal(shape).astype(np.float32)}, tbl


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_verify_step_matches_reference(pool):
    ref_core, port_core = cores()
    rcfg, cfg = ref_core.cfg, port_core.cfg
    B, W = 3, 4
    rng = np.random.default_rng(1)
    index = np.array([0, 9, 20], np.int32)
    tokens = rng.integers(0, cfg.vocab, (B, W)).astype(np.int32)
    if pool == "dense":
        shape = (cfg.n_layers, B, MAX_SEQ, cfg.n_kv_heads,
                 cfg.d_model // cfg.n_heads)
        layers = {n: rng.standard_normal(shape).astype(np.float32)
                  for n in ("k", "v")}
        extra = {}
    else:
        layers, tbl = _paged_cache(cfg, B, MAX_SEQ // BK, BK, seed=2)
        extra = {"block_tbl": tbl}
    rcache = {"index": jnp.asarray(index),
              "layers": {n: jnp.asarray(a) for n, a in layers.items()},
              **{n: jnp.asarray(a) for n, a in extra.items()}}
    tcache = {"index": torch.from_numpy(index),
              "layers": {n: torch.from_numpy(a.copy())
                         for n, a in layers.items()},
              **{n: torch.from_numpy(a) for n, a in extra.items()}}
    rtoks, rlogits, rcache = jax.jit(ref_make_verify_step(rcfg))(
        ref_core.params, jnp.asarray(tokens), rcache)
    ttoks, tlogits, tcache = make_verify_step(cfg)(
        port_core.params, torch.from_numpy(tokens), tcache)
    assert ttoks.dtype == torch.int32 and ttoks.shape == (B, W)
    np.testing.assert_array_equal(ttoks.numpy(), np.asarray(rtoks))
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(rlogits),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(tcache["index"].numpy(), index + W)
    for n in ("k", "v"):
        np.testing.assert_allclose(tcache["layers"][n].numpy(),
                                   np.asarray(rcache["layers"][n]),
                                   atol=ATOL, rtol=RTOL)
    if pool == "paged":
        assert tcache["block_tbl"] is not None
        np.testing.assert_array_equal(tcache["block_tbl"].numpy(),
                                      extra["block_tbl"])


# ------------------------------------------------------------------ engine


@pytest.mark.parametrize("workload", list(WORKLOADS))
@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 8)])
@pytest.mark.parametrize("prefill_chunk", [1, 4, None])
@pytest.mark.parametrize("pool,spec_k", [("dense", 0), ("dense", 3),
                                         ("paged", 0), ("paged", 3)])
def test_engine_streams_and_counters_equal_reference(pool, spec_k,
                                                     prefill_chunk,
                                                     temperature, top_k,
                                                     workload):
    ref_core, port_core = cores()
    kw = dict(slots=2, max_seq=MAX_SEQ, prefill_chunk=prefill_chunk,
              pool=pool, spec_k=spec_k)
    if pool == "paged":
        kw["block_size"] = BK
    ref = RefServingEngine(ref_core.cfg, core=ref_core, **kw)
    port = ServingEngine(port_core.cfg, core=port_core, **kw)
    make = WORKLOADS[workload]
    vocab = port_core.cfg.vocab
    want = run_staggered(ref, make(RefRequest, RefSamplingParams(
        temperature, top_k, seed=11), vocab))
    got = run_staggered(port, make(Request, SamplingParams(
        temperature, top_k, seed=11), vocab),
        on_tick=index_matches_positions)
    assert got == want
    assert port.lifetime() == ref.lifetime()
    life = port.lifetime()
    if spec_k and workload == "echo":
        assert life["spec_proposed"] > 0          # the drafts really fired
    if pool == "paged":
        assert port._paged
        if workload == "shared_prefix":
            assert life["prefix_hits"] > 0        # sharing really ran
        assert life["prefill_tokens"] == (life["prompt_tokens"]
                                          - life["tokens_shared"])
    if temperature == 0.0:
        assert life["logits_pulls"] == 0
    port.evacuate()
    ref.evacuate()
    if pool == "paged":
        assert (port.pool.refcount == 0).all()
        assert (ref.pool.refcount == 0).all()


def test_rewind_leaves_garbage_only_past_the_index():
    """A spec engine's valid cache region [0, pos) equals the plain
    engine's after the same traffic; rejected lanes left data past it."""
    _, port_core = cores()
    engines = {}
    for spec_k in (0, 3):
        eng = ServingEngine(port_core.cfg, core=port_core, slots=1,
                            max_seq=MAX_SEQ, spec_k=spec_k)
        run_staggered(eng, echo_requests(Request, SamplingParams(),
                                         port_core.cfg.vocab, n=1,
                                         gen_len=8, seed=5))
        engines[spec_k] = eng
    k0 = engines[0].pool.cache["layers"]["k"]
    k3 = engines[3].pool.cache["layers"]["k"]
    pos = int(engines[0].pool.index[0])
    assert int(engines[3].pool.index[0]) == pos
    np.testing.assert_allclose(k3[:, :, :pos].numpy(), k0[:, :, :pos].numpy(),
                               atol=1e-6)
    assert (k3[:, :, pos:] - k0[:, :, pos:]).abs().max() > 0.0
    assert engines[3].stats.total_spec_proposed > 0


def test_sliding_window_degenerates_to_dense_and_plain():
    """h2o-danube's smoke window (8) is shorter than max_seq: the paged pool
    keeps the dense ring and speculation is off, as in the reference."""
    ref_core, port_core = cores("h2o-danube-1.8b")
    kw = dict(slots=2, max_seq=MAX_SEQ, prefill_chunk=4, pool="paged",
              block_size=BK, spec_k=3)
    ref = RefServingEngine(ref_core.cfg, core=ref_core, **kw)
    port = ServingEngine(port_core.cfg, core=port_core, **kw)
    assert not port._paged and not port.pool.is_paged
    assert not port._spec_ok and not ref._spec_ok
    assert "block_tbl" not in port.pool.cache
    vocab = port_core.cfg.vocab
    want = run_staggered(ref, echo_requests(RefRequest, RefSamplingParams(),
                                            vocab))
    got = run_staggered(port, echo_requests(Request, SamplingParams(), vocab))
    assert got == want
    assert port.lifetime() == ref.lifetime()
    assert port.lifetime()["spec_proposed"] == 0
