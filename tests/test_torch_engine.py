"""The port's serving engine against the JAX reference engine, both on the
CPU, at bridged weights.

Token streams must be equal, request for request, for greedy and for
temperature / top-k sampling, with prefill_chunk in {1, 6, None} and
staggered arrivals; greedy runs move no logits to the host.
"""
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke_config
from repro.serving import Request as RefRequest
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import ServingEngine as RefServingEngine
from repro.serving.engine import EngineCore as RefEngineCore

from repro_torch.configs import get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.launch import serve
from repro_torch.models import LM
from repro_torch.models.bridge import from_reference
from repro_torch.serving import (
    Request, SamplingParams, ServingEngine, SlotPool, make_pool,
)
from repro_torch.serving.engine import EngineCore

ARCH = "qwen2.5-3b"
MAX_SEQ = 24
N_REQ = 5
# step at which each request arrives: staggered admissions
ARRIVE = [0, 0, 1, 3, 4]


@functools.lru_cache(maxsize=None)
def cores():
    ref = RefEngineCore(ref_smoke_config(ARCH), MAX_SEQ, seed=0)
    params = jax.tree.map(np.asarray, ref.params)
    cfg = get_smoke_config(ARCH)
    port = EngineCore(cfg, MAX_SEQ,
                      params=from_reference(params, cfg, device="cpu"),
                      device="cpu")
    return ref, port


def run(engine, request_cls, sampling):
    rng = np.random.default_rng(0)
    reqs = [request_cls(rid=i, prompt=rng.integers(3, 128, size=8
                                                   ).astype(np.int32),
                        gen_len=5, sampling=sampling) for i in range(N_REQ)]
    done = []
    for step in range(200):
        for r, t in zip(reqs, ARRIVE):
            if t == step:
                engine.submit(r, now=float(step))
        done.extend(engine.step(now=float(step)))
        if len(done) == N_REQ:
            return {r.rid: list(r.tokens_out) for r in done}
    raise AssertionError(f"only {len(done)}/{N_REQ} requests finished")


@pytest.mark.parametrize("prefill_chunk", [1, 6, None])
@pytest.mark.parametrize("temperature,top_k", [(0.0, 0), (0.8, 5)])
def test_token_streams_equal_reference(prefill_chunk, temperature, top_k):
    ref_core, port_core = cores()
    kw = dict(slots=2, max_seq=MAX_SEQ, prefill_chunk=prefill_chunk)
    ref = RefServingEngine(ref_core.cfg, core=ref_core, **kw)
    port = ServingEngine(port_core.cfg, core=port_core, **kw)
    want = run(ref, RefRequest, RefSamplingParams(temperature, top_k, seed=3))
    got = run(port, Request, SamplingParams(temperature, top_k, seed=3))
    assert got == want
    assert all(len(t) == 5 for t in got.values())
    assert port.stats.total_admitted == N_REQ
    if temperature == 0.0:
        assert port.logits_pulls == 0 == ref.logits_pulls
    else:
        assert port.logits_pulls == ref.logits_pulls > 0


def test_spec_k_serves_plain_path():
    """spec_k > 0 speculates on the dense family, as the reference does: the
    streams equal the plain path's and the reference spec engine's, and the
    speculation counters equal the reference's (and are not 0)."""
    ref_core, port_core = cores()
    kw = dict(slots=2, max_seq=MAX_SEQ, prefill_chunk=6)
    plain = run(ServingEngine(port_core.cfg, core=port_core, **kw), Request,
                SamplingParams())
    spec = ServingEngine(port_core.cfg, core=port_core, spec_k=3, **kw)
    ref = RefServingEngine(ref_core.cfg, core=ref_core, spec_k=3, **kw)
    assert run(spec, Request, SamplingParams()) == plain
    assert run(ref, RefRequest, RefSamplingParams()) == plain
    got, want = spec.lifetime(), ref.lifetime()
    assert got == want
    assert got["spec_proposed"] > 0


@pytest.mark.parametrize("entry", [
    lambda cfg: LM(cfg),
    lambda cfg: LM.init_cache(cfg, 2, MAX_SEQ),
    lambda cfg: SlotPool(cfg, 2, MAX_SEQ),
    lambda cfg: make_pool(cfg, 2, MAX_SEQ),
    lambda cfg: make_pool(cfg, 2, MAX_SEQ, pool="paged"),
    lambda cfg: ServingEngine(cfg, slots=2, max_seq=MAX_SEQ),
], ids=["LM", "init_cache", "SlotPool", "make_pool", "make_pool_paged",
        "ServingEngine"])
def test_entry_points_default_to_cuda(entry):
    import torch
    cfg = get_smoke_config(ARCH)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            entry(cfg)
        return
    out = entry(cfg)
    tensor = (out.embed.table if isinstance(out, LM) else
              out["index"] if isinstance(out, dict) else out.cache["index"]
              if isinstance(out, SlotPool) else out.pool.cache["index"])
    assert tensor.is_cuda


def test_cuda_device_is_used_or_refused():
    import torch
    if torch.cuda.is_available():
        assert resolve_device("cuda").type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


def test_serve_cli_on_cpu(capsys):
    assert serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                       "--requests", "4", "--slots", "2", "--max-seq", "32",
                       "--prompt-len", "8", "--gen-len", "4",
                       "--prefill-chunk", "3"]) == 0
    out = capsys.readouterr().out
    assert "device=cpu requests=4 gen_tokens=16" in out
    assert "admissions=4 logits_pulls=0 finished=4" in out
