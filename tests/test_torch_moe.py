"""The port's MoE layer and MoE language models against the JAX reference,
on the CPU, at bridged weights, in float32.

- ``MoE`` on TINY_CFGS["moe"] (dropless), on a ``capacity_factor = 0.5``
  copy where tokens drop, on an all-ties router (zero router weights: every
  token picks experts 0..K-1) and with raw top-k probabilities: ``y``
  within atol = rtol = 1e-5; ``top_e``, the drop mask, ``drop_frac`` and
  ``expert_load`` exactly equal, the losses within 1e-6.  The reference's
  drop mask is read out of its own dispatch (``ref_drop_mask``).
- ``top_k_first`` equals ``lax.top_k`` on rows full of ties.
- ``LM`` forward (logits and the summed aux), prefill (logits and every
  cache leaf) and decode on TINY_CFGS["moe"] and the smoke configs of
  olmoe-1b-7b (drops at S = 12) and phi3.5-moe (GQA, ``norm_topk=False``),
  within 1e-5; chunked prefill equals one-shot prefill; two identical
  calls are bitwise equal.
- Engine token streams equal the reference engine's on {dense, paged} ×
  prefill_chunk {1, 3, None} × {greedy, temperature + top-k}, and with
  ``spec_k=3`` on the echo and shared-prefix workloads, every
  ``lifetime()`` counter too; the serve CLI runs olmoe's smoke config.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY_CFGS
from repro.configs import get_config as ref_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import LM as RefLM
from repro.models.moe import MoE as RefMoE
from repro.serving import Request as RefRequest
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import ServingEngine as RefServingEngine
from repro.serving.engine import EngineCore as RefEngineCore

from test_torch_hybrid import close, close_trees, leaves, run
from test_torch_speculative import (
    echo_requests, run_staggered, shared_prefix_requests,
)
from test_torch_ssm import port_cfg

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import MoECfg
from repro_torch.models.bridge import from_reference
from repro_torch.models.moe import MoE, capacity, top_k_first
from repro_torch.models.steps import (
    cache_structs, make_chunked_prefill_step, make_prefill_step,
)
from repro_torch.serving import Request, SamplingParams, ServingEngine
from repro_torch.serving.engine import EngineCore

ARCHS = {"moe": None, "olmoe": "olmoe-1b-7b", "phi": "phi3.5-moe-42b-a6.6b"}
MAX_SEQ = 24
B, S = 2, 12


def ref_cfg(name):
    arch = ARCHS[name]
    return TINY_CFGS["moe"] if arch is None else ref_smoke_config(arch)


@pytest.mark.parametrize("arch", [a for a in ARCHS.values() if a])
def test_configs_equal_reference(arch):
    assert get_config(arch) == port_cfg(ref_config(arch))
    assert get_smoke_config(arch) == port_cfg(ref_smoke_config(arch))


# ------------------------------------------------------------------ MoE


MOE_CASES = {
    "dropless": dict(capacity_factor=4.0),
    "drops": dict(capacity_factor=0.5),
    "all_ties": dict(capacity_factor=0.5),
    "raw_topk": dict(capacity_factor=1.0, norm_topk=False),
}


def moe_pair(case):
    """(reference MoECfg, reference params, port MoE) at the same weights;
    ``all_ties`` zeroes the router."""
    mcfg = dataclasses.replace(TINY_CFGS["moe"].moe, **MOE_CASES[case])
    d = TINY_CFGS["moe"].d_model
    params, _ = RefMoE.init(jax.random.PRNGKey(3), d, mcfg)
    params = jax.tree.map(np.asarray, params)
    if case == "all_ties":
        params["router"]["w"] = np.zeros_like(params["router"]["w"])
    moe = MoE(d, MoECfg(**dataclasses.asdict(mcfg)), dtype=torch.float32)
    with torch.no_grad():
        moe.router.w.copy_(torch.tensor(params["router"]["w"]))
        for n in ("gate", "up", "down"):
            getattr(moe, n).copy_(torch.tensor(params[n]))
    moe.recast()
    moe.router.recast()
    return mcfg, params, moe


def ref_drop_mask(top_e, E, K, C):
    """The assignments the reference's own dispatch drops, (N, K) bool.
    Every token is the same all-ones row and every expert the same constant
    map, so each valid slab row comes out as the same value c; assignment
    (n, k) is weighted 2**k, and y[n] / c spells out token n's kept
    assignments in binary."""
    N = top_e.shape[0]
    d = f = 4
    w = jnp.full((E, d, f), 0.25, jnp.float32)
    y, _, _ = RefMoE._dispatch_compute_combine(
        jnp.ones((N, d), jnp.float32), jnp.asarray(top_e).reshape(-1),
        jnp.tile(2.0 ** jnp.arange(K, dtype=jnp.float32), N), w, w,
        jnp.full((E, f, d), 0.25, jnp.float32), n_buckets=E, C=C,
        w_dt=jnp.float32, K=K)
    c = float(jax.nn.silu(1.0))
    bits = np.rint(np.asarray(y)[:, 0] / c).astype(np.int64)
    return ((bits[:, None] >> np.arange(K)[None]) & 1) == 0


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_matches_reference(case):
    mcfg, params, moe = moe_pair(case)
    E, K = mcfg.n_experts, mcfg.top_k
    x = np.random.default_rng(5).standard_normal(
        (B, 16, TINY_CFGS["moe"].d_model)).astype(np.float32)
    N = B * 16
    xf = x.reshape(N, -1)
    ry, raux = RefMoE._apply_global(params, jnp.asarray(x), mcfg)
    with torch.no_grad():
        ty, taux = moe(torch.from_numpy(x))
        tp, te, _, _ = moe.route(torch.from_numpy(xf))
        C = capacity(N, mcfg)
        _, dropped, _ = moe.dispatch_compute_combine(
            torch.from_numpy(xf), te, tp, C)
    rp, re_, _, _ = RefMoE._router(params["router"], jnp.asarray(xf), mcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(re_))
    close(tp, rp)
    close(ty, ry)
    want_drop = ref_drop_mask(np.asarray(re_), E, K, C)
    np.testing.assert_array_equal(dropped.numpy().reshape(N, K), want_drop)
    assert taux["drop_frac"].item() == float(raux["drop_frac"])
    np.testing.assert_array_equal(taux["expert_load"].numpy(),
                                  np.asarray(raux["expert_load"]))
    for k in ("lb_loss", "z_loss"):
        close(taux[k], raux[k], 1e-6)
    dropping = {"dropless": False, "raw_topk": None}.get(case, True)
    if dropping is not None:
        assert bool(want_drop.any()) == dropping
    if case == "all_ties":
        assert (te.numpy() == np.arange(K)).all()
        # experts 0..K-1 keep their first C tokens, in token order
        assert (~want_drop[:C]).all() and want_drop[C:].all()


def test_top_k_first_breaks_ties_to_the_lower_index():
    rng = np.random.default_rng(0)
    probs = rng.integers(0, 3, (64, 16)).astype(np.float32) / 4
    for k in (1, 2, 5, 16):
        want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
        got_v, got_i = top_k_first(torch.from_numpy(probs), k)
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


# ------------------------------------------------------------------- LM


@functools.lru_cache(maxsize=None)
def pair(name):
    """(reference cfg, reference params, port model) at the same weights."""
    rcfg = ref_cfg(name)
    params = jax.jit(lambda key: RefLM.init(key, rcfg)[0])(
        jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    return rcfg, params, from_reference(params, port_cfg(rcfg), device="cpu")


@pytest.mark.parametrize("name", list(ARCHS))
def test_lm_apply_prefill_and_decode_match(name):
    rcfg, params, model = pair(name)
    tokens = np.random.default_rng(7).integers(0, rcfg.vocab, (B, S)
                                               ).astype(np.int32)
    want, raux = jax.jit(lambda p, t: RefLM.apply(p, {"tokens": t}, rcfg))(
        params, jnp.asarray(tokens))
    with torch.no_grad():
        got, taux = model({"tokens": torch.from_numpy(tokens)})
        again, _ = model({"tokens": torch.from_numpy(tokens)})
    close(got, want)
    assert torch.equal(got, again)
    assert taux.keys() == raux.keys()
    for k in taux:
        close(taux[k], raux[k])
    if name == "olmoe":
        assert float(raux["drop_frac"]) > 0          # tokens really dropped

    rlogits, rcache = jax.jit(lambda p, t: RefLM.prefill(
        p, {"tokens": t}, rcfg, MAX_SEQ))(params, jnp.asarray(tokens))
    tlogits, tcache = make_prefill_step(model.cfg, MAX_SEQ)(
        model, {"tokens": torch.from_numpy(tokens)})
    close(tlogits, rlogits)
    close_trees(tcache, rcache, 1e-5)
    structs = leaves(cache_structs(model.cfg, B, MAX_SEQ))
    assert {k: (tuple(s), d) for k, (s, d) in structs.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in leaves(tcache).items()}

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
        close(tlogits, rlogits)
    close_trees(tcache, rcache, 1e-5)


def test_chunked_prefill_matches_one_shot():
    _, _, model = pair("moe")
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, model.cfg.vocab, (1, 10)).astype(np.int32))
    one, c1 = make_prefill_step(model.cfg, MAX_SEQ)(model, {"tokens": tokens})
    chunked, c2 = make_chunked_prefill_step(model.cfg, MAX_SEQ, 4)(
        model, {"tokens": tokens})
    close(chunked, one)
    close_trees(c2, c1, 1e-5)


def test_bridge_fills_the_expert_stacks():
    """Every expert's slice of every layer comes from the reference tree."""
    _, params, model = pair("olmoe")
    for i, blk in enumerate(model.blocks):
        for n in ("gate", "up", "down"):
            want = params["blocks"]["moe"][n][i]
            np.testing.assert_array_equal(getattr(blk.moe, n).numpy(), want)
            np.testing.assert_array_equal(
                getattr(blk.moe, n + "_c").numpy(), want)
        np.testing.assert_array_equal(blk.moe.router.w.numpy(),
                                      params["blocks"]["moe"]["router"]["w"][i])


# ---------------------------------------------------------------- engine


@functools.lru_cache(maxsize=None)
def cores():
    rcfg = TINY_CFGS["moe"]
    ref = RefEngineCore(rcfg, MAX_SEQ, seed=0)
    params = jax.tree.map(np.asarray, ref.params)
    cfg = port_cfg(rcfg)
    port = EngineCore(cfg, MAX_SEQ,
                      params=from_reference(params, cfg, device="cpu"),
                      device="cpu")
    return ref, port


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 5)])
@pytest.mark.parametrize("prefill_chunk", [1, 3, None])
@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_token_streams_equal_reference(pool, prefill_chunk, temperature,
                                       top_k):
    ref_core, port_core = cores()
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
    assert port._paged == ref._paged == (pool == "paged")
    if temperature == 0.0:
        assert port.logits_pulls == 0 == ref.logits_pulls
    else:
        assert port.logits_pulls == ref.logits_pulls > 0


WORKLOADS = {"shared_prefix": shared_prefix_requests, "echo": echo_requests}


@pytest.mark.parametrize("workload", list(WORKLOADS))
@pytest.mark.parametrize("prefill_chunk", [1, 4, None])
@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_spec_streams_equal_reference(pool, prefill_chunk, workload):
    """MoE is spec-eligible: with spec_k=3 the streams and every lifetime
    counter equal the reference's, and equal the plain engine's."""
    ref_core, port_core = cores()
    kw = dict(slots=2, max_seq=MAX_SEQ, prefill_chunk=prefill_chunk,
              pool=pool)
    if pool == "paged":
        kw["block_size"] = 4
    make, vocab = WORKLOADS[workload], port_core.cfg.vocab
    ref = RefServingEngine(ref_core.cfg, core=ref_core, spec_k=3, **kw)
    port = ServingEngine(port_core.cfg, core=port_core, spec_k=3, **kw)
    want = run_staggered(ref, make(RefRequest, RefSamplingParams(), vocab))
    got = run_staggered(port, make(Request, SamplingParams(), vocab))
    plain = run_staggered(ServingEngine(port_core.cfg, core=port_core, **kw),
                          make(Request, SamplingParams(), vocab))
    assert got == want == plain
    life = port.lifetime()
    assert life == ref.lifetime()
    if workload == "echo":
        assert life["spec_proposed"] > 0          # the drafts really fired
    if pool == "paged" and workload == "shared_prefix":
        assert life["prefix_hits"] > 0


def test_serve_cli_serves_olmoe_on_cpu(capsys):
    assert serve.main(["--arch", "olmoe-1b-7b", "--smoke", "--device", "cpu",
                       "--requests", "4", "--slots", "2", "--max-seq", "32",
                       "--prompt-len", "8", "--gen-len", "4",
                       "--prefill-chunk", "3"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu requests=4 gen_tokens=16" in out
    assert "admissions=4 logits_pulls=0 finished=4" in out
