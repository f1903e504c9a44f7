"""The port's SSM (Mamba2) and hybrid (zamba2) language models, pool and
engine against the JAX reference, on the CPU, at bridged weights.

- ``LM`` forward, prefill and decode logits and every cache leaf on
  TINY_CFGS["ssm2"], TINY_CFGS["hybrid"] and the zamba2-2.7b smoke config,
  against the reference with ``use_pallas=False`` (atol = rtol = 1e-5) and
  with ``use_pallas=True`` (the Pallas SSD scan and attention kernels in
  interpret mode; atol = rtol = 3e-4, the scan's own tolerance).
- Chunked prefill equals one-shot prefill within 1e-5.
- ``write_slot`` puts the hybrid's (G, A, B, …) mamba leaves at axis 2,
  as the reference does.
- Engine token streams equal the reference engine's on {ssm2, hybrid} ×
  {dense, paged} × prefill_chunk {1, 3, None} × {greedy, temperature +
  top-k}; with ``spec_k=3`` these families serve the plain path (streams
  unchanged, nothing proposed); the serve CLI runs zamba2's smoke config.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY_CFGS
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import LM as RefLM
from repro.serving import Request as RefRequest
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import ServingEngine as RefServingEngine
from repro.serving.engine import EngineCore as RefEngineCore
from repro.serving.slots import write_slot as ref_write_slot

from test_torch_ssm import port_cfg

from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models.bridge import from_reference
from repro_torch.models.steps import (
    cache_structs, make_chunked_prefill_step, make_prefill_step,
)
from repro_torch.serving import (
    Request, SamplingParams, ServingEngine, SlotPool, make_pool,
)
from repro_torch.serving.engine import EngineCore
from repro_torch.serving.slots import write_slot

ARCHS = ["ssm2", "hybrid", "zamba2"]
TOL = {False: 1e-5, True: 3e-4}
MAX_SEQ = 24
B, S = 2, 12


def ref_cfg(name):
    if name == "zamba2":
        return ref_smoke_config("zamba2-2.7b")
    return TINY_CFGS[name]


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in leaves(sub, f"{prefix}/{key}").items()}
    return {prefix: tree}


def close_trees(got, want, tol):
    got, want = leaves(got), leaves(want)
    assert got.keys() == want.keys()
    for k in got:
        assert tuple(got[k].shape) == tuple(np.shape(want[k])), k
        close(got[k], want[k], tol)


@functools.lru_cache(maxsize=None)
def pair(name):
    """(reference cfg, reference params, port model) at the same weights."""
    rcfg = ref_cfg(name)
    params = jax.jit(lambda key: RefLM.init(key, rcfg)[0])(
        jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    return rcfg, params, from_reference(params, port_cfg(rcfg), device="cpu")


def test_zamba2_smoke_config_equals_reference():
    assert get_smoke_config("zamba2-2.7b") == port_cfg(
        ref_smoke_config("zamba2-2.7b"))


@pytest.mark.parametrize("use_pallas", [False, True])
@pytest.mark.parametrize("name", ARCHS)
def test_lm_apply_prefill_and_decode_match(name, use_pallas):
    rcfg, params, model = pair(name)
    rcfg = dataclasses.replace(rcfg, use_pallas=use_pallas)
    tol = TOL[use_pallas]
    tokens = np.random.default_rng(7).integers(0, rcfg.vocab, (B, S)
                                               ).astype(np.int32)
    want = jax.jit(lambda p, t: RefLM.apply(p, {"tokens": t}, rcfg)[0])(
        params, jnp.asarray(tokens))
    with torch.no_grad():
        got, _ = model({"tokens": torch.from_numpy(tokens)})
    close(got, want, tol)

    rlogits, rcache = jax.jit(lambda p, t: RefLM.prefill(
        p, {"tokens": t}, rcfg, MAX_SEQ))(params, jnp.asarray(tokens))
    tlogits, tcache = make_prefill_step(model.cfg, MAX_SEQ)(
        model, {"tokens": torch.from_numpy(tokens)})
    close(tlogits, rlogits, tol)
    close_trees(tcache, rcache, tol)
    structs = leaves(cache_structs(model.cfg, B, MAX_SEQ))
    assert {k: (tuple(s), d) for k, (s, d) in structs.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in leaves(tcache).items()}

    # decode steps with a per-row index vector: row 1 restarts two slots
    # back (the recurrent state does not rewind; both sides agree on that)
    index = np.array([S, S - 2], np.int32)
    rcache = {**rcache, "index": jnp.asarray(index)}
    tcache = {**tcache, "index": torch.from_numpy(index)}
    rdecode = jax.jit(lambda p, t, c: RefLM.decode(p, t, rcfg, c))
    rng = np.random.default_rng(8)
    for _ in range(3):
        tok = rng.integers(0, rcfg.vocab, (B, 1)).astype(np.int32)
        rlogits, rcache = rdecode(params, jnp.asarray(tok), rcache)
        with torch.no_grad():
            tlogits, tcache = model.decode(torch.from_numpy(tok), tcache)
        close(tlogits, rlogits, tol)
    close_trees(tcache, rcache, tol)


@pytest.mark.parametrize("name", ARCHS)
def test_chunked_prefill_matches_one_shot(name):
    _, _, model = pair(name)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, model.cfg.vocab, (1, 10)).astype(np.int32))
    one, c1 = make_prefill_step(model.cfg, MAX_SEQ)(model, {"tokens": tokens})
    chunked, c2 = make_chunked_prefill_step(model.cfg, MAX_SEQ, 4)(
        model, {"tokens": tokens})
    close(chunked, one)
    close_trees(c2, c1, 1e-5)


@pytest.mark.parametrize("G", [2, 1])
def test_write_slot_puts_mamba_leaves_at_axis_2(G):
    """(G, A, slots, …) pool leaves take a batch-1 leaf at axis 2 — with a
    single group too, where axis 0 is 1 on both sides — as in the
    reference."""
    A, slots = 3, 4
    for shape in [(2, 4, 8), (3, 10)]:              # h and conv
        pool = _rand((G, A, slots) + shape, 1)
        one = _rand((G, A, 1) + shape, 2)
        want = np.asarray(ref_write_slot(jnp.asarray(pool), jnp.asarray(one),
                                         2))
        got = write_slot(torch.from_numpy(pool.copy()), torch.from_numpy(one),
                         2)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy()[:, :, 2], one[:, :, 0])
        np.testing.assert_array_equal(got.numpy()[:, :, [0, 1, 3]],
                                      pool[:, :, [0, 1, 3]])


def test_slot_pool_writes_a_hybrid_prefill_into_its_slot():
    _, _, model = pair("hybrid")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, model.cfg.vocab, (1, 7)).astype(np.int32))
    _, one = make_prefill_step(model.cfg, MAX_SEQ)(model, {"tokens": tokens})
    pool = SlotPool(model.cfg, 3, MAX_SEQ, device="cpu")
    pool.write(one, 1)
    m = pool.cache["mamba"]
    for n in ("h", "conv"):
        np.testing.assert_array_equal(m[n][:, :, 1].numpy(),
                                      one["mamba"][n][:, :, 0].numpy())
        assert float(m[n][:, :, [0, 2]].abs().max()) == 0.0
    np.testing.assert_array_equal(pool.cache["attn"]["k"][:, 1].numpy(),
                                  one["attn"]["k"][:, 0].numpy())
    assert pool.index.tolist() == [0, 7, 0]


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ------------------------------------------------------------------- engine

N_REQ = 5
ARRIVE = [0, 0, 1, 3, 4]      # staggered admissions


@functools.lru_cache(maxsize=None)
def cores(name):
    rcfg = ref_cfg(name)
    ref = RefEngineCore(rcfg, MAX_SEQ, seed=0)
    params = jax.tree.map(np.asarray, ref.params)
    cfg = port_cfg(rcfg)
    port = EngineCore(cfg, MAX_SEQ,
                      params=from_reference(params, cfg, device="cpu"),
                      device="cpu")
    return ref, port


def run(engine, request_cls, sampling, vocab):
    rng = np.random.default_rng(0)
    reqs = [request_cls(rid=i, prompt=rng.integers(3, vocab, size=8
                                                   ).astype(np.int32),
                        gen_len=5, sampling=sampling) for i in range(N_REQ)]
    done = []
    for step in range(300):
        for r, t in zip(reqs, ARRIVE):
            if t == step:
                engine.submit(r, now=float(step))
        done.extend(engine.step(now=float(step)))
        if len(done) == N_REQ:
            return {r.rid: list(r.tokens_out) for r in done}
    raise AssertionError(f"only {len(done)}/{N_REQ} requests finished")


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 5)])
@pytest.mark.parametrize("prefill_chunk", [1, 3, None])
@pytest.mark.parametrize("pool", ["dense", "paged"])
@pytest.mark.parametrize("name", ["ssm2", "hybrid"])
def test_token_streams_equal_reference(name, pool, prefill_chunk, temperature,
                                       top_k):
    ref_core, port_core = cores(name)
    kw = dict(slots=2, max_seq=MAX_SEQ, prefill_chunk=prefill_chunk,
              pool=pool)
    ref = RefServingEngine(ref_core.cfg, core=ref_core, **kw)
    port = ServingEngine(port_core.cfg, core=port_core, **kw)
    vocab = port_core.cfg.vocab
    want = run(ref, RefRequest, RefSamplingParams(temperature, top_k, seed=3),
               vocab)
    got = run(port, Request, SamplingParams(temperature, top_k, seed=3),
              vocab)
    assert got == want
    assert all(len(t) == 5 for t in got.values())
    assert port._paged == ref._paged == (pool == "paged" and name == "hybrid")
    if temperature == 0.0:
        assert port.logits_pulls == 0 == ref.logits_pulls
    else:
        assert port.logits_pulls == ref.logits_pulls > 0


@pytest.mark.parametrize("pool", ["dense", "paged"])
@pytest.mark.parametrize("name", ["ssm2", "hybrid"])
def test_spec_k_serves_the_plain_path(name, pool):
    """Recurrent state cannot rewind, so spec_k > 0 serves the plain path on
    these families: the streams equal the plain engine's and nothing is
    proposed, as in the reference."""
    ref_core, port_core = cores(name)
    kw = dict(slots=2, max_seq=MAX_SEQ, prefill_chunk=3, pool=pool)
    vocab = port_core.cfg.vocab
    plain = run(ServingEngine(port_core.cfg, core=port_core, **kw), Request,
                SamplingParams(), vocab)
    spec = ServingEngine(port_core.cfg, core=port_core, spec_k=3, **kw)
    ref = RefServingEngine(ref_core.cfg, core=ref_core, spec_k=3, **kw)
    assert run(spec, Request, SamplingParams(), vocab) == plain
    assert run(ref, RefRequest, RefSamplingParams(), vocab) == plain
    got, want = spec.lifetime(), ref.lifetime()
    assert got == want
    assert got["spec_proposed"] == 0 == got["spec_accepted"]


def test_hybrid_paged_pool_pages_only_attention():
    cfg = port_cfg(TINY_CFGS["hybrid"])
    pool = make_pool(cfg, 2, MAX_SEQ, pool="paged", block_size=4,
                     device="cpu")
    assert pool.is_paged and not pool.can_share
    assert pool.cache["attn"]["k"].shape[:3] == (1, pool.num_blocks, 4)
    assert pool.cache["mamba"]["h"].shape[:3] == (1, 2, 2)


def test_serve_cli_serves_zamba2_on_cpu(capsys):
    assert serve.main(["--arch", "zamba2-2.7b", "--smoke", "--device", "cpu",
                       "--requests", "4", "--slots", "2", "--max-seq", "32",
                       "--prompt-len", "8", "--gen-len", "4",
                       "--prefill-chunk", "3"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu requests=4 gen_tokens=16" in out
    assert "admissions=4 logits_pulls=0 finished=4" in out
