"""The language model's train step against the JAX reference's, on the CPU,
at bridged weights (not the control plane's DNN: that is
``test_torch_train.py``).

For each tiny family of ``conftest.TINY_CFGS`` (float32) one reference run
is shared by the tests: ``make_train_step``'s metrics, the gradients of its
loss at the initial weights and 8 steps on the counted token pipeline's
batches.  The reference runs with ``use_scan=False`` and ``remat="none"``
(the same stacked parameters walked by a Python loop instead of
``lax.scan``, no rematerialisation: the same arithmetic) and is compiled
once per family, step and gradients together, at XLA's backend
optimisation level 0: a quarter of the default compile time on the CPU.
The port holds:

- ``loss``, ``ce``, ``grad_norm``, ``lb_loss`` and ``drop_frac`` of one step
  within 1e-5 relative; each gradient leaf, stacked by
  ``bridge.to_reference``, within 1e-5 of the leaf's largest magnitude;
- the 8 steps' losses within 1e-4 relative; parameters and AdamW moments
  within 1e-4 (an element whose reference gradient is rounding noise may
  move by AdamW's step bound, 1.2·lr a step on each side, as in
  ``test_torch_dnn.py``; ``ADAM_NOISE`` names the leaves, none so far);
- ``_sdpa_chunked`` and chunked CE at chunk 16 over 64 tokens against the
  reference's chunked forms, forward and gradients;
- a bf16-compute copy of the dense config: 8 losses within 2e-2 relative of
  the reference's, falling, the masters still float32, and the cast set of
  the reference's ``cast_params_sharded`` (the embedding table and norm
  scales go to bf16 too);
- the decay mask equal to the reference's, leaf for leaf;
- no gradient through a detached copy: poisoned ``w_c``/``*_c`` change
  nothing on the train route;
- the Mamba1 train route differentiable (the serve scan's in-place writes
  are not);
- serving after the train step's ``recast``: the trained model's greedy
  streams equal those of a fresh ``LM`` loaded with its parameters.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.steps as ref_steps
from conftest import TINY_CFGS
from repro.data import DataConfig as RefDataConfig
from repro.data import TokenPipeline as RefTokenPipeline
from repro.data import extra_inputs as ref_extra_inputs
from repro.models import LM as RefLM
from repro.models.attention import Attention as RefAttention

from repro_torch.models import HybridCfg, ModelConfig, MoECfg, SSMCfg, steps
from repro_torch.models.attention import Attention
from repro_torch.models.bridge import from_reference, to_reference
from repro_torch.models.moe import MoE
from repro_torch.models.transformer import LM
from repro_torch.nn import Linear
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.engine import EngineCore

FAMILIES = list(TINY_CFGS)
B, S, STEPS = 2, 16, 8
LR = 3e-4
METRIC_TOL, GRAD_TOL, STEP_TOL = 1e-5, 1e-5, 1e-4
ADAM_STEP = 1.2
ADAM_NOISE: dict = {}       # family → leaves whose gradient is noise
METRICS = ("loss", "ce", "grad_norm", "lb_loss", "drop_frac")


def port_cfg(rcfg, **kw):
    """The port's ModelConfig equal, field for field, to a reference one."""
    d = {**dataclasses.asdict(rcfg), **kw}
    for name, cls in (("ssm", SSMCfg), ("hybrid", HybridCfg), ("moe", MoECfg)):
        if isinstance(d[name], dict):
            d[name] = cls(**d[name])
    d["m_rope_sections"] = tuple(d["m_rope_sections"])
    return ModelConfig(**d)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Tiny tensors: one intra-op thread is faster than a pool, and does not
    contend with the other test workers' pools for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in leaves(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def batches(rcfg, n, seq=S, dtype=None):
    """n batches of the reference's counted pipeline, as numpy."""
    data = RefTokenPipeline(RefDataConfig(vocab=rcfg.vocab, seq_len=seq,
                                          global_batch=B, seed=3))
    return [ref_extra_inputs(rcfg, data.batch(i)) for i in range(n)]


def torch_batch(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def ref_loss(rcfg):
    """The reference's ``loss_fn`` (``repro/models/steps.py``) for a float32
    config, where ``cast_params_sharded`` is the identity; its gradients'
    norm is held to ``make_train_step``'s own ``grad_norm`` below."""
    def loss_fn(params, batch):
        logits, aux = RefLM.apply(params, batch, rcfg)
        ce = ref_steps.cross_entropy(logits, batch["labels"])
        loss = ce
        if rcfg.moe is not None:
            loss = (loss + rcfg.moe.router_aux_coef * aux["lb_loss"]
                    + rcfg.moe.router_z_coef * aux["z_loss"])
        return loss, ce
    return loss_fn


def initial_params(rcfg):
    """Seeded weights as the reference's numpy tree: the port's init (the
    reference's distributions, drawn by torch in a fraction of the time a
    jitted ``LM.init`` takes to compile) through ``to_reference``."""
    cfg = port_cfg(rcfg)
    return to_reference(dict(LM(cfg, device="cpu").named_parameters()), cfg)


def compiled(fn, *args):
    """``jax.jit(fn)`` compiled for ``args`` at backend optimisation level
    0 (the same XLA program, less LLVM work)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def ref_train(rcfg, bs):
    """(initial params, per-step metrics, final state, the loss's gradients
    at the initial params on the first batch) of the reference's
    ``make_train_step`` over the batches ``bs``."""
    step, (opt_init, _) = ref_steps.make_train_step(rcfg, lr=LR)
    grad = jax.grad(lambda p, b: ref_loss(rcfg)(p, b)[0])
    params0 = initial_params(rcfg)
    params = jax.tree.map(jnp.asarray, params0)
    state = ref_steps.TrainState(params, opt_init(params),
                                 jnp.zeros((), jnp.int32))
    run = compiled(lambda st, b: (step(st, b), grad(st.params, b)), state,
                   bs[0])
    metrics = []
    for i, b in enumerate(bs):
        (state, m), g = run(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
        grads = jax.tree.map(np.asarray, g) if i == 0 else grads
    return params0, metrics, jax.tree.map(np.asarray, state), grads


def unrolled(rcfg):
    return dataclasses.replace(rcfg, use_scan=False, remat="none")


def reference_run(family):
    rcfg = unrolled(TINY_CFGS[family])
    bs = batches(rcfg, STEPS)
    params0, metrics, final, grads = ref_train(rcfg, bs)
    return {"params0": params0, "batches": bs, "metrics": metrics,
            "final": final, "grads": grads}


@functools.lru_cache(maxsize=None)
def references():
    """Every family's reference run, on a few threads: XLA compiles
    without the GIL while the next family traces."""
    with ThreadPoolExecutor(4) as pool:
        return dict(zip(FAMILIES, pool.map(reference_run, FAMILIES)))


def reference(family):
    return references()[family]


def port_model(family, params=None):
    ref = reference(family)
    return from_reference(ref["params0"] if params is None else params,
                          port_cfg(TINY_CFGS[family]), device="cpu")


def port_train(model, bs, cfg=None):
    """(per-step metrics, final TrainState) of the port's step."""
    step, (opt_init, _) = steps.make_train_step(cfg or model.cfg, lr=LR)
    state = steps.TrainState(model, opt_init(dict(model.named_parameters())),
                             0)
    metrics = []
    for b in bs:
        state, m = step(state, torch_batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, state


def rel_close(got, want, tol, what):
    assert abs(got - want) <= tol * max(abs(want), 1e-30) + 1e-12, (
        what, got, want)


@functools.lru_cache(maxsize=None)
def port_run(family):
    return port_train(port_model(family), reference(family)["batches"])


# ------------------------------------------------------------- one step


@pytest.mark.parametrize("family", FAMILIES)
def test_step_metrics_equal_reference(family):
    ref = reference(family)
    (m, _) = port_run(family)
    for k in METRICS:
        rel_close(m[0][k], ref["metrics"][0][k], METRIC_TOL, k)


@pytest.mark.parametrize("family", FAMILIES)
def test_gradients_equal_reference(family):
    ref = reference(family)
    (loss, (ce, aux)), grads = steps.loss_and_grads(
        port_model(family), torch_batch(ref["batches"][0]))
    rel_close(float(loss), ref["metrics"][0]["loss"], METRIC_TOL, "loss")
    got = leaves(to_reference(grads, port_cfg(TINY_CFGS[family])))
    want = leaves(ref["grads"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        top = float(np.abs(w).max())
        err = float(np.abs(got[k] - w).max())
        assert err <= GRAD_TOL * max(top, 1e-30), (k, err, top)
    # the gradients above are the reference's train step's: same norm
    norm = float(np.sqrt(sum(np.sum(np.square(g, dtype=np.float64))
                             for g in want.values())))
    rel_close(norm, ref["metrics"][0]["grad_norm"], METRIC_TOL, "grad_norm")


# ------------------------------------------------------------- 8 steps


@pytest.mark.parametrize("family", FAMILIES)
def test_eight_steps_equal_reference(family):
    ref = reference(family)
    metrics, state = port_run(family)
    for i, (m, r) in enumerate(zip(metrics, ref["metrics"])):
        rel_close(m["loss"], r["loss"], STEP_TOL, f"loss at step {i + 1}")
    assert state.step == state.opt_state.step == STEPS
    assert int(ref["final"].step) == STEPS
    cfg = port_cfg(TINY_CFGS[family])
    noise = ADAM_NOISE.get(family, ())
    bound = 2 * ADAM_STEP * LR * STEPS
    for tree, mine in ((ref["final"].params,
                        dict(state.params.named_parameters())),
                       (ref["final"].opt_state.mu, state.opt_state.mu),
                       (ref["final"].opt_state.nu, state.opt_state.nu)):
        got, want = leaves(to_reference(mine, cfg)), leaves(tree)
        assert got.keys() == want.keys()
        for k, w in want.items():
            tol = STEP_TOL + (bound if k in noise else 0.0)
            err = float(np.abs(got[k] - w).max())
            assert err <= tol, (k, err)


# ------------------------------------------------------------- chunked paths


def qkv(seed=0, Sq=64, H=4, KV=2, hd=16):
    g = np.random.default_rng(seed)
    return tuple(g.standard_normal((B, Sq, n, hd)).astype(np.float32)
                 for n in (H, KV, KV))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, None)])
def test_chunked_attention_equals_reference(causal, window, monkeypatch):
    q, k, v = qkv()
    monkeypatch.setattr(RefAttention, "CHUNK_Q", 16)
    monkeypatch.setattr(Attention, "CHUNK_Q", 16)
    want = RefAttention._sdpa_masked(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal,
                                     window=window)
    got = Attention._sdpa_masked(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=2e-6)
    monkeypatch.setattr(Attention, "CHUNK_Q", 10**9)
    full = Attention._sdpa_masked(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), full.numpy(), atol=2e-6,
                               rtol=2e-6)


def test_chunked_attention_gradients_equal_reference(monkeypatch):
    q, k, v = qkv(1)
    monkeypatch.setattr(RefAttention, "CHUNK_Q", 16)
    monkeypatch.setattr(Attention, "CHUNK_Q", 16)
    args = tuple(map(jnp.asarray, (q, k, v)))
    want = compiled(jax.grad(lambda q_, k_, v_: RefAttention._sdpa_masked(
        q_, k_, v_, causal=True, window=None).sum(), argnums=(0, 1, 2)),
        *args)(*args)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    Attention._sdpa_masked(tq, tk, tv, causal=True, window=None).sum()\
        .backward()
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=3e-6,
                                   rtol=3e-6)


@pytest.mark.parametrize("chunked", [False, True])
def test_chunked_ce_and_gradients_equal_reference(chunked):
    rcfg = unrolled(TINY_CFGS["dense"])
    ref = reference("dense")
    b = batches(rcfg, 1, seq=64)[0]
    labels = b["labels"]

    def ref_ce(params):
        if chunked:
            h, _ = RefLM.apply(params, b, rcfg, return_hidden=True)
            return ref_steps.chunked_cross_entropy(params, h, labels, rcfg,
                                                   chunk=16)
        logits, _ = RefLM.apply(params, b, rcfg)
        return ref_steps.cross_entropy(logits, labels)

    params = jax.tree.map(jnp.asarray, ref["params0"])
    want, want_g = compiled(jax.value_and_grad(ref_ce), params)(params)
    model = port_model("dense")
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_()
    tb = torch_batch(b)
    if chunked:
        h, _ = model(tb, train=True, return_hidden=True)
        got = steps.chunked_cross_entropy(model, h, tb["labels"], model.cfg,
                                          chunk=16)
    else:
        logits, _ = model(tb, train=True)
        got = steps.cross_entropy(logits, tb["labels"])
    got.backward()
    rel_close(float(got.detach()), float(want), 1e-6, "ce")
    grads = leaves(to_reference({k: p.grad for k, p in params.items()},
                                model.cfg))
    for k, w in leaves(jax.tree.map(np.asarray, want_g)).items():
        top = float(np.abs(w).max())
        assert float(np.abs(grads[k] - w).max()) <= GRAD_TOL * top, k


def test_train_step_takes_chunked_paths(monkeypatch):
    """At S > CE_CHUNK = CHUNK_Q (patched to 16, S = 32) the step takes
    chunked CE and chunked attention, as the reference's does, and its
    metrics equal the unchunked step's."""
    rcfg = TINY_CFGS["dense"]
    b = torch_batch(batches(rcfg, 1, seq=32)[0])
    step, (opt_init, _) = steps.make_train_step(port_cfg(rcfg), lr=LR)

    def run():
        model = port_model("dense")
        return step(steps.TrainState(model, opt_init(dict(
            model.named_parameters())), 0), b)[1]

    full = run()
    calls = []
    chunked_ce = steps.chunked_cross_entropy
    monkeypatch.setattr(steps, "CE_CHUNK", 16)
    monkeypatch.setattr(Attention, "CHUNK_Q", 16)
    monkeypatch.setattr(steps, "chunked_cross_entropy",
                        lambda *a, **k: calls.append(k) or chunked_ce(*a, **k))
    chunked = run()
    assert calls == [{"chunk": 16}]
    for k in METRICS:
        rel_close(float(chunked[k]), float(full[k]), 1e-6, k)


# ------------------------------------------------------------- mixed precision


def test_bf16_compute_copy_follows_reference():
    rcfg = dataclasses.replace(unrolled(TINY_CFGS["dense"]),
                               dtype="bfloat16")
    bs = batches(rcfg, STEPS, seq=32)
    params0, ref_metrics, _, _ = ref_train(rcfg, bs)
    model = from_reference(params0, port_cfg(rcfg), device="cpu")
    metrics, state = port_train(model, bs)
    for i, (m, r) in enumerate(zip(metrics, ref_metrics)):
        rel_close(m["loss"], r["loss"], 2e-2, f"loss at step {i + 1}")
    assert metrics[-1]["loss"] < metrics[0]["loss"]
    assert all(p.dtype == torch.float32 for p in state.params.parameters())
    assert all(v.dtype == torch.float32 for v in state.opt_state.mu.values())


def test_bf16_loss_casts_every_master():
    """The cast set of trap 2: every float32 master reaches the forward in
    the compute dtype, the embedding table and norm scales included."""
    rcfg = dataclasses.replace(TINY_CFGS["dense"], dtype="bfloat16")
    model = from_reference(reference("dense")["params0"], port_cfg(rcfg),
                           device="cpu")
    seen = {}
    for name, mod in model.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            mod.register_forward_pre_hook(
                lambda m, a, n=f"{name}.{pname}", pn=pname:
                seen.setdefault(n, getattr(m, pn).dtype) and None)
    steps.loss_and_grads(model, torch_batch(batches(rcfg, 1)[0]))
    assert seen.keys() == dict(model.named_parameters()).keys()
    assert set(seen.values()) == {torch.bfloat16}, seen


# ------------------------------------------------------------- the route


@pytest.mark.parametrize("family", FAMILIES)
def test_decay_mask_equals_reference(family):
    model = port_model(family)
    mask = {k: torch.full(p.shape, float(steps.decay_mask(k, p)))
            for k, p in model.named_parameters()}
    got = leaves(to_reference(mask, model.cfg))
    want = leaves(reference(family)["params0"])
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert (got[k] == float(w.ndim >= 2)).all(), k


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_train_route_never_reads_the_detached_copies(family):
    b = torch_batch(reference(family)["batches"][0])
    (loss, _), grads = steps.loss_and_grads(port_model(family), b)
    model = port_model(family)
    for m in model.modules():
        if isinstance(m, Linear) and m.w_c is not None:
            m.w_c = torch.full_like(m.w_c, float("nan"))
        if isinstance(m, MoE):
            for name in ("gate_c", "up_c", "down_c"):
                setattr(m, name, torch.full_like(getattr(m, name),
                                                 float("nan")))
    (loss2, _), grads2 = steps.loss_and_grads(model, b)
    assert float(loss2) == float(loss)
    for k, g in grads.items():
        assert torch.equal(grads2[k], g), k
        assert g.abs().sum() > 0, k


def test_mamba1_train_route_is_differentiable():
    model = port_model("ssm1")
    b = torch_batch(reference("ssm1")["batches"][0])
    for p in model.parameters():
        p.requires_grad_()
    logits, _ = model(b, train=True)
    logits.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in model.parameters())
    # the serve scan writes its states in place: autograd refuses it
    with pytest.raises(RuntimeError, match="inplace"):
        model(b)[0].sum().backward()


# ------------------------------------------------------------- serving


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_serves_after_training_as_a_fresh_model(family):
    _, state = port_run(family)
    trained = state.params
    cfg = trained.cfg
    fresh = from_reference(to_reference(dict(trained.named_parameters()),
                                        cfg), cfg, device="cpu")

    def streams(model):
        eng = ServingEngine(cfg, slots=2, max_seq=24, device="cpu",
                            core=EngineCore(cfg, 24, params=model,
                                            device="cpu"))
        g = np.random.default_rng(5)
        reqs = [Request(rid=i, prompt=g.integers(0, cfg.vocab, 8 + i),
                        gen_len=6) for i in range(3)]
        for r in reqs:
            eng.submit(r, now=0.0)
        done, t = [], 0
        while len(done) < len(reqs):
            t += 1
            done.extend(eng.step(now=float(t)))
        return {r.rid: list(r.tokens_out) for r in done}

    assert streams(trained) == streams(fresh)
