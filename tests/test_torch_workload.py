"""The serving workloads, the examples and h2o-danube's engine on the CPU.

* The five generators of ``repro_torch.serving.workload`` against the
  reference's on the same seeds: prompts, tiers, rids and lengths equal
  exactly (``tiered_requests`` at ``batch_frac`` 0 and 0.5,
  ``repetitive_requests`` at ``period`` 1 and ``prompt_len``,
  ``shared_prefix_requests`` at ``prefix_len`` 0 and ``prompt_len``), and
  ``repro_torch.serving`` exports what ``repro.serving`` exports of them.
* The reduced h2o-danube-1.8b (a sliding window of 8 slots) served by the
  port's engine on the dense pool, fed by ``shared_prefix_requests`` with
  prompts longer than the window: token streams equal the reference
  engine's at bridged weights, whole prompts and chunked.
* A model whose bf16 weight copies would not fit beside its float32
  weights (qwen2.5-14b on an 80 GB card, ``cast_copies_fit``) casts on
  every call instead (``nn.layers.cast_on_call``): on h2o-danube's and
  phi3.5-moe's reduced configs in bf16 its logits and streams equal the
  kept copies' bitwise.
* ``examples/torch_quickstart.py``, ``torch_serve_autoscale.py`` and
  ``torch_train_elastic.py`` run in-process with ``--device cpu`` (and
  ``--smoke`` where the reference has it): the quickstart completes, the
  autoscale loop returns 0 (its scaler changed the replica count), the
  elastic job's resumed batches and losses equal an uninterrupted run's.
  None of them imports ``jax`` or ``repro``.
"""
import ast
import functools
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.serving as ref_serving
from repro.configs import get_smoke_config as ref_smoke_config
from repro.serving import Request as RefRequest
from repro.serving import ServingEngine as RefServingEngine
from repro.serving import workload as ref_workload
from repro.serving.engine import EngineCore as RefEngineCore
from repro.sim.serving import WorkloadSpec as RefWorkloadSpec

import repro_torch.serving as port_serving
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import LM, transformer
from repro_torch.models.bridge import from_reference
from repro_torch.nn.layers import cast_on_call
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving import workload
from repro_torch.serving.engine import EngineCore
from repro_torch.sim.serving import WorkloadSpec

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("torch_quickstart", "torch_serve_autoscale",
            "torch_train_elastic")
PROMPT, GEN, VOCAB, N = 12, 5, 128, 9


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the engines' small ops contend for every core
    under the suite's parallel workers otherwise."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reqs(module, spec_cls, name, seed, **kw):
    fn = getattr(module, name)
    return fn(spec_cls(prompt_len=PROMPT, gen_len=GEN), N, VOCAB,
              rng=np.random.default_rng(seed), base_rid=100, **kw)


def _fields(reqs):
    return [(r.rid, r.prompt.dtype.str, r.prompt.tolist(), r.gen_len, r.tier)
            for r in reqs]


@pytest.mark.parametrize("name,kw", [
    ("synthetic_requests", {}),
    ("tiered_requests", {"batch_frac": 0.0}),
    ("tiered_requests", {"batch_frac": 0.5}),
    ("repetitive_requests", {"period": 1}),
    ("repetitive_requests", {"period": PROMPT}),
    ("repetitive_requests", {"period": 5}),
    ("shared_prefix_requests", {"prefix_len": 0}),
    ("shared_prefix_requests", {"prefix_len": PROMPT}),
    ("shared_prefix_requests", {"prefix_len": 7}),
])
@pytest.mark.parametrize("seed", [0, 3])
def test_generators_equal_the_reference(name, kw, seed):
    got = _reqs(workload, WorkloadSpec, name, seed, **kw)
    want = _reqs(ref_workload, RefWorkloadSpec, name, seed, **kw)
    assert _fields(got) == _fields(want)
    # each request its own SamplingParams, as the reference gives them
    assert len({id(r.sampling) for r in got}) == N
    if kw.get("batch_frac") == 0.5:
        assert {r.tier for r in got} == {"interactive", "batch"}
    # the tiers come after the prompts: the same prompts as a plain stream
    if name == "tiered_requests":
        plain = _reqs(workload, WorkloadSpec, "synthetic_requests", seed)
        assert [r.prompt.tolist() for r in got] == [
            r.prompt.tolist() for r in plain]


def test_poisson_arrivals_and_exports_equal_the_reference():
    got = workload.poisson_arrival_times(3.5, 20, np.random.default_rng(1))
    want = ref_workload.poisson_arrival_times(3.5, 20,
                                              np.random.default_rng(1))
    assert np.array_equal(got, want)
    ref_names = {n for n in ref_serving.__all__
                 if getattr(getattr(ref_serving, n), "__module__", None)
                 == ref_workload.__name__}
    assert ref_names == {"poisson_arrival_times", "synthetic_requests",
                         "tiered_requests", "shared_prefix_requests"}
    assert ref_names <= set(port_serving.__all__)
    for n in ref_names:
        assert getattr(port_serving, n) is getattr(workload, n)
    with pytest.raises(AssertionError):
        workload.repetitive_requests(WorkloadSpec(prompt_len=4), 1, VOCAB,
                                     period=5, rng=np.random.default_rng())
    with pytest.raises(AssertionError):
        workload.shared_prefix_requests(WorkloadSpec(prompt_len=4), 1, VOCAB,
                                        prefix_len=5,
                                        rng=np.random.default_rng())


# ------------------------------------------- h2o-danube on the dense pool

DANUBE, MAX_SEQ = "h2o-danube-1.8b", 32


@functools.lru_cache(maxsize=None)
def danube_cores():
    ref = RefEngineCore(ref_smoke_config(DANUBE), MAX_SEQ, seed=0)
    params = jax.tree.map(np.asarray, ref.params)
    cfg = get_smoke_config(DANUBE)
    port = EngineCore(cfg, MAX_SEQ, params=from_reference(params, cfg,
                                                          device="cpu"),
                      device="cpu")
    return ref, port


def _serve(engine, module, spec_cls, request_cls):
    reqs = module.shared_prefix_requests(
        spec_cls(prompt_len=PROMPT, gen_len=6), 5, VOCAB, prefix_len=6,
        rng=np.random.default_rng(2))
    assert all(isinstance(r, request_cls) for r in reqs)
    done = []
    for step in range(200):
        if step < len(reqs):
            engine.submit(reqs[step], now=float(step))
        done.extend(engine.step(now=float(step)))
        if len(done) == len(reqs):
            return {r.rid: list(r.tokens_out) for r in done}
    raise AssertionError(f"only {len(done)} requests finished")


@pytest.mark.parametrize("prefill_chunk", [None, 5])
def test_danube_shared_prefix_streams_equal_the_reference(prefill_chunk):
    ref_core, port_core = danube_cores()
    assert port_core.cfg.sliding_window == 8 < PROMPT
    kw = dict(slots=2, max_seq=MAX_SEQ, prefill_chunk=prefill_chunk)
    want = _serve(RefServingEngine(ref_core.cfg, core=ref_core, **kw),
                  ref_workload, RefWorkloadSpec, RefRequest)
    port = ServingEngine(port_core.cfg, core=port_core, **kw)
    got = _serve(port, workload, WorkloadSpec, Request)
    assert got == want
    assert all(len(t) == 6 for t in got.values())
    assert port.logits_pulls == 0


# ----------------------------------------------- weights cast on every call


def test_cast_copies_fit_by_the_cards_free_memory(monkeypatch):
    card = torch.device("cuda")
    free = 80 * 10**9

    def mem_get_info(device):
        assert device == card
        return free, 85 * 10**9
    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    assert not transformer.cast_copies_fit(get_config("qwen2.5-14b"), card)
    for arch in ("qwen2.5-3b", "h2o-danube-1.8b"):
        assert transformer.cast_copies_fit(get_config(arch), card)
    free = 10 * 10**9
    assert not transformer.cast_copies_fit(get_config("qwen2.5-3b"), card)
    # off a card, or with weights already in the compute dtype: always
    assert transformer.cast_copies_fit(get_config("qwen2.5-14b"),
                                       torch.device("cpu"))
    assert transformer.cast_copies_fit(get_config(
        "qwen2.5-14b", param_dtype="bfloat16"), card)


@pytest.mark.parametrize("arch", [DANUBE, "phi3.5-moe-42b-a6.6b"])
def test_casting_on_call_serves_the_same_numbers(arch):
    cfg = get_smoke_config(arch, dtype="bfloat16")
    kept = LM(cfg, device="cpu", seed=0)
    with cast_on_call():
        bare = LM(cfg, device="cpu", seed=0)
    # every weight stored in another dtype than it computes in: no copy
    cast = [m for m in bare.modules() if getattr(m, "keep_copy", None)
            is not None and (m.w if hasattr(m, "w") else m.gate).dtype
            != m.dtype]
    assert cast and not any(m.keep_copy for m in cast)
    assert all(getattr(m, "w_c", None) is None
               and getattr(m, "gate_c", None) is None for m in cast)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, PROMPT)).astype(np.int32))
    with torch.no_grad():
        assert torch.equal(kept({"tokens": tokens})[0],
                           bare({"tokens": tokens})[0])
    streams = []
    for model in (kept, bare):
        core = EngineCore(cfg, MAX_SEQ, params=model, device="cpu")
        eng = ServingEngine(cfg, slots=2, max_seq=MAX_SEQ, core=core)
        streams.append(_serve(eng, workload, WorkloadSpec, Request))
    assert streams[0] == streams[1]


# ------------------------------------------------------------- the examples


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_import_no_jax_and_default_to_cuda(name):
    tree = ast.parse((REPO / "examples" / f"{name}.py").read_text())
    mods = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
            for a in n.names}
    mods |= {n.module for n in ast.walk(tree)
             if isinstance(n, ast.ImportFrom) and n.module}
    roots = {m.split(".")[0] for m in mods}
    assert "jax" not in roots and "repro" not in roots, roots
    assert "repro_torch" in roots
    parser_default = [kw.value.value for n in ast.walk(tree)
                      if isinstance(n, ast.Call)
                      and any(isinstance(a, ast.Constant)
                              and a.value == "--device" for a in n.args)
                      for kw in n.keywords if kw.arg == "default"]
    assert parser_default == ["cuda"]


def test_quickstart_completes_on_the_cpu(tmp_path, capsys):
    out = _example("torch_quickstart").main(
        ["--device", "cpu", "--smoke", "--cells", str(tmp_path)])
    printed = capsys.readouterr().out
    assert "quickstart complete." in printed
    assert "needs a card" in printed and out["kernel_err"] is None
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["losses"][-1] < out["losses"][0]
    assert out["index"] == 32 + 4
    assert len(out["replicas"]) == 4 and min(out["replicas"]) >= 1
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        f"h2o-danube-1.8b__{s}__card.json"
        for s in ("decode_32k", "prefill_32k")]
    # the cells are read, not written again, on a second run
    again = _example("torch_quickstart").main(
        ["--device", "cpu", "--smoke", "--cells", str(tmp_path)])
    assert "writing" not in capsys.readouterr().out
    assert again["replicas"] == out["replicas"]
    assert again["strategy"] == out["strategy"]


def test_serve_autoscale_scales_on_the_cpu(capsys):
    rc = _example("torch_serve_autoscale").main(["--smoke", "--device",
                                                 "cpu"])
    printed = capsys.readouterr().out
    assert rc == 0, printed[-2000:]
    assert "replica trajectory" in printed and "FAIL" not in printed


def test_train_elastic_resumes_as_an_uninterrupted_run(tmp_path, capsys):
    rc = _example("torch_train_elastic").main(
        ["--device", "cpu", "--ckpt-dir", str(tmp_path)])
    printed = capsys.readouterr().out
    assert rc == 0, printed[-2000:]
    assert "restored onto mesh {'data': 1, 'model': 1} at step 8" in printed
    assert (tmp_path / "ckpt").is_dir()
