"""The port's Mamba1 block and Mamba1 language models (falcon-mamba)
against the JAX reference, on the CPU, at bridged weights, in float32.

- ``Mamba1`` forward, its final state (``h`` against the reference's
  ``LM._mamba1_final_state``, the conv tail too, short prompts included,
  where the tail is shorter than ``d_conv - 1``) and one-token decode
  (output and both state leaves, written in place) on TINY_CFGS["ssm1"]
  and falcon-mamba-7b's smoke config, within atol = rtol = 1e-5;
  ``state_shape`` equals the reference's.
- ``selective_scan`` equals the step-by-step recurrence.
- ``LM`` forward (aux all zero), prefill (logits and every cache leaf) and
  decode, within 1e-5; chunked prefill equals one-shot prefill.
- Engine token streams equal the reference engine's on {dense, paged} ×
  prefill_chunk {1, 3, None} × {greedy, temperature + top-k}; "paged"
  degenerates to the dense tree; with ``spec_k=3`` the streams are the
  plain ones and nothing is proposed; the serve CLI runs falcon-mamba's
  smoke config.
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
from repro.models.mamba import Mamba1 as RefMamba1
from repro.serving import Request as RefRequest
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import ServingEngine as RefServingEngine
from repro.serving.engine import EngineCore as RefEngineCore

from test_torch_hybrid import close, close_trees, leaves, run
from test_torch_ssm import port_cfg

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models.bridge import from_reference
from repro_torch.models.mamba import Mamba1, selective_scan
from repro_torch.models.steps import (
    cache_structs, make_chunked_prefill_step, make_prefill_step,
)
from repro_torch.serving import Request, SamplingParams, ServingEngine
from repro_torch.serving.engine import EngineCore

ARCH = "falcon-mamba-7b"
NAMES = ["ssm1", "falcon"]
MAX_SEQ = 24
B, S = 2, 12


def ref_cfg(name):
    return TINY_CFGS["ssm1"] if name == "ssm1" else ref_smoke_config(ARCH)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_configs_equal_reference():
    assert get_config(ARCH) == port_cfg(ref_config(ARCH))
    assert get_smoke_config(ARCH) == port_cfg(ref_smoke_config(ARCH))


@functools.lru_cache(maxsize=None)
def pair(name):
    """(reference cfg, reference params, port model) at the same weights."""
    rcfg = ref_cfg(name)
    params = jax.jit(lambda key: RefLM.init(key, rcfg)[0])(
        jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    return rcfg, params, from_reference(params, port_cfg(rcfg), device="cpu")


def mamba0(params):
    return jax.tree.map(lambda p: p[0], params["blocks"]["mamba"])


# ---------------------------------------------------------------- Mamba1


def test_selective_scan_equals_the_recurrence():
    Bsz, L, di, N = 2, 9, 6, 4
    rng = np.random.default_rng(1)
    x = rng.standard_normal((Bsz, L, di)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((Bsz, L, di)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal((di, N))).astype(np.float32)
    Bm, C = (rng.standard_normal((Bsz, L, N)).astype(np.float32)
             for _ in range(2))
    h = np.zeros((Bsz, di, N), np.float32)
    ys = []
    for t in range(L):
        h = (np.exp(dt[:, t, :, None] * A) * h
             + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :])
        ys.append(np.einsum("bdn,bn->bd", h, C[:, t]))
    y, h_last = selective_scan(*map(torch.from_numpy, (x, dt, A, Bm, C)))
    close(y, np.stack(ys, 1))
    close(h_last, h)


@pytest.mark.parametrize("L", [1, 2, 3, 11])
@pytest.mark.parametrize("name", NAMES)
def test_mamba1_forward_state_and_decode_match(name, L):
    rcfg, params, model = pair(name)
    m, mp = model.blocks[0].mamba, mamba0(params)
    assert isinstance(m, Mamba1)
    x = _x((2, L, rcfg.d_model), 3)
    with torch.no_grad():
        close(m(torch.from_numpy(x)), RefMamba1.apply(mp, x, rcfg))
        y, st = m(torch.from_numpy(x), return_state=True)
    close(y, RefMamba1.apply(mp, x, rcfg))
    want = RefLM._mamba1_final_state(mp, x, rcfg)
    for n in ("h", "conv"):
        assert tuple(st[n].shape) == want[n].shape
        close(st[n], want[n])
    assert st["conv"].shape[1] == min(L, rcfg.ssm.d_conv - 1)

    shapes = RefMamba1.state_shape(rcfg, 2)
    assert {n: (s, dt) for n, (s, dt, _) in Mamba1.state_shape(
        model.cfg, 2).items()} == {
        n: (s, torch.float32) for n, (s, _, _) in shapes.items()}
    state = {n: _x(s, 4 + i) for i, (n, (s, _, _)) in
             enumerate(shapes.items())}
    x1 = _x((2, 1, rcfg.d_model), 6 + L)
    ry, rst = RefMamba1.decode(mp, x1, rcfg, {n: jnp.asarray(v) for n, v in
                                                state.items()})
    tstate = {n: torch.from_numpy(v.copy()) for n, v in state.items()}
    with torch.no_grad():
        ty, tst = m.decode(torch.from_numpy(x1), tstate)
    assert tst is tstate                         # written in place
    close(ty, ry)
    for n in ("h", "conv"):
        close(tstate[n], rst[n])


# ------------------------------------------------------------------- LM


@pytest.mark.parametrize("name", NAMES)
def test_lm_apply_prefill_and_decode_match(name):
    rcfg, params, model = pair(name)
    tokens = np.random.default_rng(7).integers(0, rcfg.vocab, (B, S)
                                               ).astype(np.int32)
    want, raux = jax.jit(lambda p, t: RefLM.apply(p, {"tokens": t}, rcfg))(
        params, jnp.asarray(tokens))
    with torch.no_grad():
        got, taux = model({"tokens": torch.from_numpy(tokens)})
    close(got, want)
    assert taux.keys() == raux.keys()
    assert all(float(v) == 0.0 == float(raux[k]) for k, v in taux.items())

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


@pytest.mark.parametrize("name", NAMES)
def test_chunked_prefill_matches_one_shot(name):
    _, _, model = pair(name)
    tokens = torch.from_numpy(np.random.default_rng(9).integers(
        0, model.cfg.vocab, (1, 10)).astype(np.int32))
    one, c1 = make_prefill_step(model.cfg, MAX_SEQ)(model, {"tokens": tokens})
    chunked, c2 = make_chunked_prefill_step(model.cfg, MAX_SEQ, 4)(
        model, {"tokens": tokens})
    close(chunked, one)
    close_trees(c2, c1, 1e-5)


# ---------------------------------------------------------------- engine


@functools.lru_cache(maxsize=None)
def cores():
    rcfg = TINY_CFGS["ssm1"]
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
    assert not port._paged and not ref._paged    # nothing to page
    if temperature == 0.0:
        assert port.logits_pulls == 0 == ref.logits_pulls
    else:
        assert port.logits_pulls == ref.logits_pulls > 0


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_spec_k_serves_the_plain_path(pool):
    """Recurrent state cannot rewind: with spec_k > 0 the streams equal the
    plain engine's and nothing is proposed, as in the reference."""
    ref_core, port_core = cores()
    kw = dict(slots=2, max_seq=MAX_SEQ, prefill_chunk=3, pool=pool)
    vocab = port_core.cfg.vocab
    plain = run(ServingEngine(port_core.cfg, core=port_core, **kw), Request,
                SamplingParams(), vocab)
    spec = ServingEngine(port_core.cfg, core=port_core, spec_k=3, **kw)
    ref = RefServingEngine(ref_core.cfg, core=ref_core, spec_k=3, **kw)
    assert run(spec, Request, SamplingParams(), vocab) == plain
    assert run(ref, RefRequest, RefSamplingParams(), vocab) == plain
    got = spec.lifetime()
    assert got == ref.lifetime()
    assert got["spec_proposed"] == 0 == got["spec_accepted"]


def test_serve_cli_serves_falcon_mamba_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "4", "--slots", "2", "--max-seq", "32",
                       "--prompt-len", "8", "--gen-len", "4",
                       "--prefill-chunk", "3"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu requests=4 gen_tokens=16" in out
    assert "admissions=4 logits_pulls=0 finished=4" in out
