"""The port's VLM family (qwen2-vl: M-RoPE and a patch prefix) against the
JAX reference, on the CPU, at bridged weights, in float32.

- ``section_ids`` and ``mrope_positions`` (n_patches 0, 4 and 9; an int
  start and a per-row one) exactly equal; M-RoPE angles within rtol =
  1e-4, atol = 1e-5, with sections that cover head_dim // 2 and sections
  shorter than it.
- ``LM`` forward, prefill (logits and every cache leaf) and decode with a
  per-row index, with patches, on TINY_CFGS["vlm"] and the qwen2-vl-7b
  smoke config, within rtol = 1e-4, atol = 1e-5.
- ``make_chunked_prefill_step`` equals a one-shot prefill, and raises for a
  chunk that ends inside the patch prefix, as the reference's does.
- Engine token streams equal the reference engine's on {dense, paged} x
  {greedy, temperature + top-k} x prefill_chunk {1 (raised past the
  patches), 6, None}, and with ``spec_k=3`` on the shared-prefix and echo
  workloads, every ``lifetime()`` counter too; prefix keys with other
  ``extra`` bytes never alias; the serve CLI runs the smoke config.
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
from repro.models import LM as RefLM
from repro.models.rotary import mrope_positions as ref_mrope_positions
from repro.models.rotary import rope_angles as ref_rope_angles
from repro.models.rotary import section_ids as ref_section_ids
from repro.models.steps import (
    make_chunked_prefill_step as ref_make_chunked_prefill_step,
)
from repro.serving import Request as RefRequest
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import ServingEngine as RefServingEngine
from repro.serving.engine import EngineCore as RefEngineCore
from repro.serving.slots import _prefix_key as ref_prefix_key

from test_torch_hybrid import close, close_trees, leaves, run
from test_torch_speculative import (
    echo_requests, run_staggered, shared_prefix_requests,
)
from test_torch_ssm import port_cfg

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models.bridge import from_reference
from repro_torch.models.rotary import (
    mrope_positions, rope_angles, section_ids,
)
from repro_torch.models.steps import (
    cache_structs, make_chunked_prefill_step, make_prefill_step,
)
from repro_torch.serving import (
    PagedSlotPool, Request, SamplingParams, ServingEngine,
)
from repro_torch.serving.engine import EngineCore
from repro_torch.serving.slots import _prefix_key

ARCHS = {"vlm": None, "qwen2vl": "qwen2-vl-7b"}
MAX_SEQ = 24
B, S = 2, 12


def ref_cfg(name):
    arch = ARCHS[name]
    return TINY_CFGS["vlm"] if arch is None else ref_smoke_config(arch)


def test_configs_equal_reference():
    assert get_config("qwen2-vl-7b") == port_cfg(ref_config("qwen2-vl-7b"))
    assert get_smoke_config("qwen2-vl-7b") == port_cfg(
        ref_smoke_config("qwen2-vl-7b"))


# ------------------------------------------------------------------ M-RoPE

# (head_dim, sections): the full config's; the smoke configs' (sum 4 of a
# half of 4 at hd 8, and of 8 at hd 16: padded with the last stream); one
# section past half (cut)
SECTIONS = [(128, (16, 24, 24)), (8, (2, 1, 1)), (16, (2, 1, 1)),
            (16, (4, 4)), (8, (3, 3))]


@pytest.mark.parametrize("head_dim,sections", SECTIONS)
def test_section_ids_equal_reference(head_dim, sections):
    np.testing.assert_array_equal(
        section_ids(head_dim, sections).numpy(),
        np.asarray(ref_section_ids(head_dim, sections)))


STARTS = {"zero": 0, "scalar": 5, "per_row": np.array([3, 11], np.int32)}


@pytest.mark.parametrize("start", list(STARTS))
@pytest.mark.parametrize("n_patches", [0, 4, 9])
def test_mrope_positions_equal_reference(n_patches, start):
    st = STARTS[start]
    for seq in (1, S):
        want = np.asarray(ref_mrope_positions(B, seq, n_patches,
                                              jnp.asarray(st)))
        got = mrope_positions(B, seq, n_patches, torch.as_tensor(st))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("head_dim,sections", SECTIONS)
@pytest.mark.parametrize("n_patches", [0, 4, 9])
def test_mrope_angles_match(n_patches, head_dim, sections):
    pos = np.array(ref_mrope_positions(B, S, n_patches, jnp.asarray([0, 7])))
    want = ref_rope_angles(jnp.asarray(pos), head_dim, 1e6, sections)
    got = rope_angles(torch.from_numpy(pos), head_dim, 1e6, sections)
    assert tuple(got.shape) == (B, S, head_dim // 2)
    close(got, want)


def test_mrope_angles_need_their_sections():
    with pytest.raises(ValueError):
        rope_angles(mrope_positions(1, 4, 0, 0), 8, 1e6)


# ------------------------------------------------------------------- LM


@functools.lru_cache(maxsize=None)
def pair(name):
    """(reference cfg, reference params, port model) at the same weights."""
    rcfg = ref_cfg(name)
    params = jax.jit(lambda key: RefLM.init(key, rcfg)[0])(
        jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    return rcfg, params, from_reference(params, port_cfg(rcfg), device="cpu")


def vlm_inputs(rcfg, seed, batch=B, seq=S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, rcfg.vocab, (batch, seq)
                                   ).astype(np.int32),
            "patches": rng.standard_normal(
                (batch, rcfg.n_vision_patches, rcfg.d_model)
            ).astype(np.float32)}


def as_jax(inputs):
    return {k: jnp.asarray(v) for k, v in inputs.items()}


def as_torch(inputs):
    return {k: torch.from_numpy(v) for k, v in inputs.items()}


@pytest.mark.parametrize("name", list(ARCHS))
def test_lm_apply_prefill_and_decode_match(name):
    rcfg, params, model = pair(name)
    inputs = vlm_inputs(rcfg, 7)
    want, _ = jax.jit(lambda p, i: RefLM.apply(p, i, rcfg))(
        params, as_jax(inputs))
    with torch.no_grad():
        got, _ = model(as_torch(inputs))
        no_patches, _ = model({"tokens": torch.from_numpy(inputs["tokens"])})
    close(got, want)
    # the patches reach the model: without them the logits differ
    assert not torch.allclose(got, no_patches)

    rlogits, rcache = jax.jit(lambda p, i: RefLM.prefill(
        p, i, rcfg, MAX_SEQ))(params, as_jax(inputs))
    tlogits, tcache = make_prefill_step(model.cfg, MAX_SEQ)(
        model, as_torch(inputs))
    close(tlogits, rlogits)
    close_trees(tcache, rcache, 1e-5)
    structs = leaves(cache_structs(model.cfg, B, MAX_SEQ))
    assert {k: (tuple(s), d) for k, (s, d) in structs.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in leaves(tcache).items()}

    # decode steps with a per-row index vector: text positions t = h = w
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


@pytest.mark.parametrize("chunk", [5, 7])
@pytest.mark.parametrize("name", list(ARCHS))
def test_chunked_prefill_matches_one_shot_and_reference(name, chunk):
    rcfg, params, model = pair(name)
    inputs = vlm_inputs(rcfg, 9, batch=1, seq=10)
    one, c1 = make_prefill_step(model.cfg, MAX_SEQ)(model, as_torch(inputs))
    chunked, c2 = make_chunked_prefill_step(model.cfg, MAX_SEQ, chunk)(
        model, as_torch(inputs))
    close(chunked, one)
    close_trees(c2, c1, 1e-5)
    want, rcache = ref_make_chunked_prefill_step(rcfg, MAX_SEQ, chunk)(
        params, as_jax(inputs))
    close(chunked, want)
    close_trees(c2, rcache, 1e-5)


@pytest.mark.parametrize("chunk", [1, 4])
def test_chunked_prefill_refuses_a_chunk_inside_the_patches(chunk):
    cfg = port_cfg(TINY_CFGS["vlm"])
    assert cfg.n_vision_patches == 4
    with pytest.raises(ValueError):
        ref_make_chunked_prefill_step(TINY_CFGS["vlm"], MAX_SEQ, chunk)
    with pytest.raises(ValueError):
        make_chunked_prefill_step(cfg, MAX_SEQ, chunk)


# ---------------------------------------------------------------- engine


@functools.lru_cache(maxsize=None)
def cores(name="vlm"):
    rcfg = ref_cfg(name)
    ref = RefEngineCore(rcfg, MAX_SEQ, seed=0)
    params = jax.tree.map(np.asarray, ref.params)
    cfg = port_cfg(rcfg)
    port = EngineCore(cfg, MAX_SEQ,
                      params=from_reference(params, cfg, device="cpu"),
                      device="cpu")
    return ref, port


@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 5)])
@pytest.mark.parametrize("prefill_chunk", [1, 6, None])
@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_token_streams_equal_reference(pool, prefill_chunk, temperature,
                                       top_k):
    ref_core, port_core = cores()
    kw = dict(slots=2, max_seq=MAX_SEQ, prefill_chunk=prefill_chunk,
              pool=pool)
    ref = RefServingEngine(ref_core.cfg, core=ref_core, **kw)
    port = ServingEngine(port_core.cfg, core=port_core, **kw)
    assert port.prefill_chunk == ref.prefill_chunk
    assert port.prefill_chunk > port_core.cfg.n_vision_patches
    vocab = port_core.cfg.vocab
    want = run(ref, RefRequest, RefSamplingParams(temperature, top_k, seed=3),
               vocab)
    got = run(port, Request, SamplingParams(temperature, top_k, seed=3),
              vocab)
    assert got == want
    assert all(len(t) == 5 for t in got.values())
    assert port._paged == ref._paged == (pool == "paged")
    assert port.lifetime() == ref.lifetime()
    if temperature == 0.0:
        assert port.logits_pulls == 0 == ref.logits_pulls
    else:
        assert port.logits_pulls == ref.logits_pulls > 0


WORKLOADS = {"shared_prefix": shared_prefix_requests, "echo": echo_requests}


@pytest.mark.parametrize("workload", list(WORKLOADS))
@pytest.mark.parametrize("prefill_chunk", [1, None])
@pytest.mark.parametrize("pool", ["dense", "paged"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_spec_streams_equal_reference(name, pool, prefill_chunk, workload):
    """The VLM is spec-eligible: with spec_k=3 the streams and every
    lifetime counter equal the reference's, and equal the plain engine's;
    the paged shared-prefix run shares prefix blocks, patches included."""
    ref_core, port_core = cores(name)
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
        assert life["spec_proposed"] > 0
    if pool == "paged" and workload == "shared_prefix":
        assert life["prefix_hits"] > 0


def test_prefix_keys_with_other_extra_bytes_never_alias():
    """The reference's tests/test_paged_pool.py check on the port's pool:
    the same token prefix under other patch bytes misses the registry, and
    the keys equal the reference's byte for byte."""
    cfg = port_cfg(TINY_CFGS["vlm"])
    pool = PagedSlotPool(cfg, 2, MAX_SEQ, block_size=4, device="cpu")
    prompt = np.arange(3, 14, dtype=np.int32)
    pool.admit_slot(0, prompt, 3, extra=b"patches-a")
    for j in range(2):
        pool.register_block(0, j, prompt, extra=b"patches-a")
    assert pool.lookup_prefix(1, prompt, extra=b"patches-b") == (0, [])
    assert pool.lookup_prefix(1, prompt) == (0, [])
    assert pool.lookup_prefix(1, prompt, extra=b"patches-a")[0] == 2
    assert pool.admit_slot(1, prompt, 3, extra=b"patches-a") == 8
    for extra in (b"", b"patches-a", b"\x00" * 20):
        for n in (4, 8):
            assert _prefix_key(prompt, n, extra) == ref_prefix_key(
                prompt, n, extra)
    assert _prefix_key(prompt, 8, b"x") != _prefix_key(prompt, 8)
    ref_core, port_core = cores()
    eng = ServingEngine(port_core.cfg, core=port_core, slots=2,
                        max_seq=MAX_SEQ, pool="paged", block_size=4)
    ref = RefServingEngine(ref_core.cfg, core=ref_core, slots=2,
                           max_seq=MAX_SEQ, pool="paged", block_size=4)
    assert eng._patch_key == ref._patch_key != b""


def test_serve_cli_serves_the_vlm_on_cpu(capsys):
    assert serve.main(["--arch", "qwen2-vl-7b", "--smoke", "--device", "cpu",
                       "--requests", "4", "--slots", "2", "--max-seq", "32",
                       "--prompt-len", "8", "--gen-len", "4",
                       "--prefill-chunk", "3"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu requests=4 gen_tokens=16" in out
    assert "admissions=4 logits_pulls=0 finished=4" in out
