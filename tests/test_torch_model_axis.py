"""The model axis (``repro_torch.sharding.shard_map``, split-K decode,
expert-parallel MoE, the axes helpers, ``collective_bytes``,
``make_production_mesh``) against the reference, on the CPU.

* The shard map: split/join round trips by spec, views on the source's
  device, ``ShardedArray`` indexing and placement; ``psum``, ``pmax``,
  ``pmean`` and ``all_gather`` equal numpy's and are bitwise equal across a
  group's shards; each collective is one record under ``CostCounter``;
  gradients flow through ``psum``.
* The axes helpers equal the reference's leaf for leaf on every smoke
  config (structs by shape and dtype).
* Split-K decode taken exactly where the reference's ``_splitk_ctx``
  takes it, and the serve partition (``steps.make_decode_step`` given an
  ``LM`` under ``shard_ctx(SERVE_RULES, mesh)``) within 1e-4 of the
  reference's unsharded ``LM.decode`` (logits and caches, two steps) on
  (2, 4), (1, 2) and (1, 4) meshes of CPU shards: the reference's own
  split-K test config, the sliding-window smoke config (its ring wraps)
  and zamba2's.  A vector index, ``Smax % m != 0`` and a paged cache run
  no split-K body and hold to the reference's jitted step on the same
  mesh; the partition's collectives are derived from the shapes.  An
  ``LM`` and its laid-out weights give the same logits, caches and
  collectives; the one-device serve methods and the fused-decode, verify
  and chunked-prefill steps refuse a shard context.
* Expert-parallel MoE (``MoE._apply_ep``) within 1e-4 of the reference's
  global path on a dropless config (``z_loss`` within 1e-3, ``drop_frac``
  0), and the port's train-route gradients through it finite and within
  1e-4 of its global path's.
* One subprocess with 8 host devices holds the port against the
  reference's own sharded bodies (``_decode_splitk``; its jitted decode
  on the layouts split-K does not take; ``_apply_ep`` with drops at
  capacity factor 1.0 and data = 2) on meshes built with
  ``jax.sharding.Mesh`` (Auto axes): ``jax.make_mesh`` builds Explicit
  axes under this JAX, where the reference's sharding constraints raise.
* ``collective_bytes`` equal to the reference's ``hlo_cost`` formulas on
  HLO lines of the same kinds, shapes and group sizes.
* ``make_production_mesh``.
"""
import functools
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_IDS, get_smoke_config as ref_smoke_config
from repro.launch.hlo_cost import collective_bytes as ref_collective_bytes
from repro.models import LM as RefLM
from repro.models import steps as ref_steps
from repro.models.attention import Attention as RefAttention
from repro.models.config import SHAPES as REF_SHAPES
from repro.sharding import SERVE_RULES as REF_SERVE_RULES
from repro.sharding import TRAIN_RULES as REF_TRAIN_RULES
from repro.sharding import shard_ctx as ref_shard_ctx

from repro_torch.configs import get_smoke_config
from repro_torch.launch.cost import CostCounter, collective_bytes
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import LM, ModelConfig, MoECfg, SHAPES
from repro_torch.models import steps
from repro_torch.models.attention import Attention
from repro_torch.models.bridge import from_reference
from repro_torch.models.moe import MoE
from repro_torch.sharding import (
    SERVE_RULES, TRAIN_RULES, ShardedArray, device_put, serve_rules,
    shard_ctx,
)
from repro_torch.sharding import shard_map as sm

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4
# the reference's split-K and EP test configs (tests/test_perf_paths.py)
DENSE = dict(name="t", family="dense", n_layers=2, d_model=32, n_heads=8,
             n_kv_heads=2, d_ff=64, vocab=64, param_dtype="float32",
             dtype="float32")
MOE = dict(name="t", family="moe", n_layers=2, d_model=32, n_heads=4,
           n_kv_heads=2, d_ff=64, vocab=64, param_dtype="float32",
           dtype="float32")
MESHES = [(2, 4), (1, 2), (1, 4)]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def compiled(fn, *args):
    """``jax.jit(fn)(*args)`` compiled at XLA's backend optimization level
    0: the reference's tiny oracles compile in a fraction of the time, with
    the same operations."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def cpu_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"] * math.prod(shape))


class FakeMesh:
    """Duck-typed mesh read alike by both packages' contexts."""

    def __init__(self, shape, axes=("data", "model")):
        self.axis_names = tuple(axes)
        self.devices = np.empty(shape, object)


# ------------------------------------------------------------ the shard map

SPECS = [(), ("data",), (None, "model"), ("data", "model"),
         (("data", "model"),), ("model", None, "data")]


@pytest.mark.parametrize("spec", SPECS)
def test_split_join_round_trip(spec):
    mesh = cpu_mesh((2, 4))
    x = torch.arange(8 * 8 * 4, dtype=torch.float32).reshape(8, 8, 4)
    blocks = sm.split(x, spec, mesh)
    for pos in sm.positions(mesh):
        b = blocks[pos]
        assert b.untyped_storage().data_ptr() == \
            x.untyped_storage().data_ptr()                 # a view
        want = x
        for d, entry in enumerate(sm.canonical(spec)):
            k = sm.axis_size(mesh, entry)
            r = sm.axis_index(mesh, pos, entry)
            n = x.shape[d] // k
            want = want.narrow(d, r * n, n)
        assert torch.equal(b, want)
    assert torch.equal(sm.join(blocks, spec, mesh), x)
    a = sm.place(x, spec, mesh)
    assert sm.place(a, spec, mesh) is a
    assert torch.equal(sm.place(a, ("data",), mesh).full(), x)
    assert torch.equal(a.full(), x) and a.shape == x.shape


def test_sharded_array_layers_and_writes_reach_the_source():
    mesh = cpu_mesh((2, 4))
    x = torch.zeros(3, 4, 8, 2)
    a = sm.place(x, (None, "data", "model"), mesh)
    layer = a[1]
    assert isinstance(layer, ShardedArray) and layer.spec == ("data",
                                                              "model")
    assert layer.shape == (4, 8, 2)
    layer.blocks[1, 2].fill_(7.0)
    assert torch.equal(x[1, 2:4, 4:6], torch.full((2, 2, 2), 7.0))
    assert x.sum() == 7.0 * 8
    with pytest.raises(IndexError):
        layer[0]                                          # a split dim
    # replicated positions on one device share one block
    r = sm.place(x, (None, None, "model"), mesh)
    assert r.blocks[0, 1] is r.blocks[1, 1]


def test_tree_shardings_and_device_put():
    mesh = FakeMesh((2, 4))
    mesh.devices[...] = torch.device("cpu")
    axes = {"w": ("embed", "ff"), "b": ("ff",), "s": ("heads",)}
    tree = {"w": torch.randn(8, 12), "b": torch.randn(12),
            "s": torch.randn(6)}
    sh = sm.tree_shardings(axes, TRAIN_RULES, mesh, tree)
    assert {k: s.spec for k, s in sh.items()} == {
        "w": ("data", "model"), "b": ("model",), "s": ()}   # 6 % 4 != 0
    placed = sm.device_put(tree, sh)
    for k, t in tree.items():
        assert torch.equal(placed[k].full(), t)
    assert placed["w"].blocks[1, 0].shape == (4, 3)


def _values(mesh, shape, seed):
    rng = np.random.default_rng(seed)
    return sm.per_shard(mesh, lambda _: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)))


COLLECTIVES = {
    "psum": (sm.psum, lambda xs: np.sum(xs, 0), "all-reduce"),
    "pmax": (sm.pmax, lambda xs: np.max(xs, 0), "all-reduce"),
    "pmean": (sm.pmean, lambda xs: np.mean(xs, 0), "all-reduce"),
    "all_gather": (sm.all_gather, lambda xs: np.concatenate(xs, 0),
                   "all-gather"),
}


@pytest.mark.parametrize("axes", ["model", "data", ("data", "model")])
@pytest.mark.parametrize("name", sorted(COLLECTIVES))
def test_collectives_equal_numpy_and_agree_bitwise(name, axes):
    fn, want_fn, kind = COLLECTIVES[name]
    mesh = cpu_mesh((2, 4))
    vals = _values(mesh, (3, 5), 7)
    with CostCounter() as c:
        out = fn(vals, axes, mesh)
    assert c.flops == 0 and c.bytes == 0
    n = sm.axis_size(mesh, axes)
    assert len(c.collectives) == 1
    k, nbytes, group = c.collectives[0]
    assert (k, group) == (kind, n)
    assert nbytes == out[0, 0].numel() * 4
    for group in sm.groups(mesh, axes):
        want = want_fn([vals[p].numpy() for p in group])
        np.testing.assert_allclose(out[group[0]].numpy(), want, rtol=1e-6,
                                   atol=1e-6)
        for p in group:
            assert torch.equal(out[p], out[group[0]])


def test_bf16_psum_adds_in_float32_and_rounds_once():
    mesh = cpu_mesh((1, 4))
    vals = sm.per_shard(mesh, lambda p: torch.tensor(
        [1.0, 2 ** -9, 2 ** -9, 2 ** -9][p[1]]).to(torch.bfloat16))
    out = sm.psum(vals, "model", mesh)
    assert out[0, 0].dtype == torch.bfloat16
    assert out[0, 0].item() == float(torch.tensor(1 + 3 * 2 ** -9)
                                     .to(torch.bfloat16))


def test_gradients_flow_through_psum_and_join():
    mesh = cpu_mesh((2, 4))
    x = torch.randn(4, 3, requires_grad=True)
    blocks = sm.split(x, ("data",), mesh)
    s = sm.psum(sm.per_shard(mesh, lambda p: blocks[p] * (1 + p[1])),
                "model", mesh)
    y = sm.join(s, ("data",), mesh)
    y.sum().backward()
    assert torch.equal(x.grad, torch.full((4, 3), 10.0))


# ------------------------------------------------------------ axes helpers


def _flat(tree, pre=()):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, pre + (key,)).items()}
    return {pre: tree}


def _struct(s):
    return tuple(s.shape), str(np.dtype(s.dtype)) if not isinstance(
        s.dtype, torch.dtype) else str(s.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_axes_helpers_equal_the_reference(arch):
    rcfg, cfg = ref_smoke_config(arch), get_smoke_config(arch)
    r_axes, r_structs = ref_steps.params_axes_and_structs(rcfg)
    p_axes, p_structs = steps.params_axes_and_structs(cfg)
    assert _flat(p_axes) == _flat(r_axes)
    assert {k: _struct(v) for k, v in _flat(p_structs).items()} == {
        k: _struct(v) for k, v in _flat(r_structs).items()}
    ts = steps.train_state_axes(cfg)
    assert ts.step == () and ts.opt_state.step == ()
    assert ts.params == ts.opt_state.mu == ts.opt_state.nu == p_axes
    for labels in (False, True):
        assert steps.input_sharding_axes(cfg, with_labels=labels) == \
            ref_steps.input_sharding_axes(rcfg, with_labels=labels)
    for name in ("train_4k", "prefill_32k", "decode_32k"):
        got = _flat(steps.input_structs(cfg, SHAPES[name]))
        want = _flat(ref_steps.input_structs(rcfg, REF_SHAPES[name]))
        assert {k: _struct(v) for k, v in got.items()} == {
            k: _struct(v) for k, v in want.items()}


def test_train_state_axes_mirror_the_reference():
    rcfg, cfg = ref_smoke_config("olmoe-1b-7b"), \
        get_smoke_config("olmoe-1b-7b")
    want = ref_steps.train_state_axes(rcfg)
    got = steps.train_state_axes(cfg)
    assert got.step == want.step and got.opt_state.step == \
        want.opt_state.step
    for g, w in ((got.params, want.params), (got.opt_state.mu,
                                             want.opt_state.mu)):
        assert _flat(g) == _flat(w)


def test_params_structs_allocate_nothing():
    from repro_torch.configs import get_config
    _, structs = steps.params_axes_and_structs(get_config("qwen2-72b"))
    total = sum(math.prod(s.shape) for s in _flat(structs).values())
    assert total > 7e10                    # 72B parameters, on no device


# ------------------------------------------------------------ split-K decode


@pytest.mark.parametrize("rules", ["serve", "train"])
@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (1, 2), (2, 4), (1, 4),
                                   (4, 2)])
@pytest.mark.parametrize("Smax", [8, 12, 30, 32])
def test_splitk_taken_where_the_reference_takes_it(rules, shape, Smax):
    mesh = FakeMesh(shape)
    r_rules, p_rules = ((REF_SERVE_RULES, SERVE_RULES) if rules == "serve"
                        else (REF_TRAIN_RULES, TRAIN_RULES))
    with ref_shard_ctx(r_rules, mesh):
        want = RefAttention._splitk_ctx(Smax)
    with shard_ctx(p_rules, mesh):
        got = Attention._splitk_ctx(Smax)
    assert (got is None) == (want is None)
    if got is not None:
        assert got[0] is mesh and got[1:] == want[1:]


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _torch_tree(tree):
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _full(x):
    return x.full() if isinstance(x, ShardedArray) else x


def _close_trees(got, want, tol=TOL):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(_full(got[k]).numpy(), want[k], rtol=tol,
                                   atol=tol, err_msg=str(k))


@functools.lru_cache(maxsize=None)
def reference_run(key, max_seq, B=8, S=16, steps_=2):
    """The reference's unsharded prefill and ``steps_`` decode steps on the
    config named by ``key``: (params, [cache0, (tok, logits, cache) per
    step]) in numpy, greedy tokens from the reference."""
    if key in ("dense",):
        from repro.models import ModelConfig as RefModelConfig
        rcfg = RefModelConfig(**DENSE)
    else:
        rcfg = ref_smoke_config(key)
    tokens = np.random.default_rng(1).integers(0, rcfg.vocab, (B, S),
                                               dtype=np.int32)

    def run(key, tokens):          # one compile: init, prefill, the steps
        params = RefLM.init(key, rcfg)[0]
        logits, cache = RefLM.prefill(params, {"tokens": tokens}, rcfg,
                                      max_seq)
        out = [cache]
        for _ in range(steps_):
            tok = jnp.argmax(logits[:, 0], -1).astype(jnp.int32)[:, None]
            logits, cache = RefLM.decode(params, tok, rcfg, cache)
            out.append((tok, logits, cache))
        return params, out
    return _np_tree(compiled(run, jax.random.PRNGKey(0), tokens))


def port_model(key, params):
    cfg = ModelConfig(**DENSE) if key == "dense" else get_smoke_config(key)
    return from_reference(params, cfg, device="cpu")


def splitk_against_reference(key, max_seq, shape):
    params, run = reference_run(key, max_seq)
    model = port_model(key, params)
    cache = _torch_tree(run[0])
    mesh = cpu_mesh(shape)
    step = steps.make_decode_step(model.cfg)
    with shard_ctx(SERVE_RULES, mesh):
        for tok, want_logits, want_cache in run[1:]:
            logits, cache = step(model, torch.tensor(tok), cache)
            np.testing.assert_allclose(logits.numpy(), want_logits,
                                       rtol=TOL, atol=TOL)
            _close_trees(cache, want_cache)
    return cache


@pytest.mark.parametrize("shape", MESHES)
def test_splitk_decode_matches_reference(shape):
    cache = splitk_against_reference("dense", 32, shape)
    assert isinstance(cache["layers"]["k"], ShardedArray)
    assert cache["layers"]["k"].spec == (None, "data", "model")


@pytest.mark.parametrize("shape", MESHES)
def test_splitk_sliding_window_wrapped_ring_matches_reference(shape):
    # danube's window 8: an 8-slot ring after a 16-token prompt, so the two
    # steps write at indices 16 and 17, past the ring, every slot valid
    cache = splitk_against_reference("h2o-danube-1.8b", 24, shape)
    assert cache["layers"]["k"].shape[2] == 8 and int(cache["index"]) == 18


@pytest.mark.parametrize("shape", MESHES)
def test_splitk_zamba2_shared_attention_matches_reference(shape):
    cache = splitk_against_reference("zamba2-2.7b", 24, shape)
    assert isinstance(cache["attn"]["k"], ShardedArray)
    assert cache["attn"]["k"].spec[2] == "model"
    # the Mamba states are laid out by their cache axes too
    cfg = get_smoke_config("zamba2-2.7b")
    assert cache["mamba"]["h"].spec == steps.cache_specs(
        cfg, cache, SERVE_RULES, cpu_mesh(shape))["mamba"]["h"]


def test_splitk_collectives_record_and_bytes():
    params, run = reference_run("dense", 32)
    model = port_model("dense", params)
    mesh = cpu_mesh((2, 4))
    with shard_ctx(SERVE_RULES, mesh), CostCounter() as c:
        steps.make_decode_step(model.cfg)(model, torch.tensor(run[1][0]),
                                          _torch_tree(run[0]))
    # the partition on (2, 4), 8 rows (4 a data shard), float32: the
    # embedding's psum over the vocabulary; a layer: wk and wv gathered
    # whole (2 KV heads do not split over 4 ranks, their columns do), q
    # gathered over "model", split-K's pmax of m, psum of l (B/data, KV,
    # G) and psum of o (B/data, KV, G, hd), the psums of wo's and the
    # MLP's rows; the logits gathered over the vocabulary, then the batch
    cfg = model.cfg
    B, d, V, f, m = 4, cfg.d_model, cfg.vocab, 4, 4
    KV, H, hd = cfg.n_kv_heads, cfg.n_heads, cfg.hd
    G = H // KV
    layer = ([("all-gather", d * KV * hd * f, m)] * 2
             + [("all-gather", B * H * hd * f, m)]
             + [("all-reduce", B * KV * G * f, m)] * 2
             + [("all-reduce", B * KV * G * hd * f, m)]
             + [("all-reduce", B * d * f, m)] * 2)
    want = ([("all-reduce", B * d * f, m)] + layer * cfg.n_layers
            + [("all-gather", B * V * f, m), ("all-gather", 2 * B * V * f, 2)])
    assert c.collectives == want
    total, detail = collective_bytes(c)
    ar = sum(b for k, b, _ in want if k == "all-reduce")
    ag4 = sum(b for k, b, n in want if k == "all-gather" and n == 4)
    assert total == 1.5 * ar + 0.75 * ag4 + 0.5 * 2 * B * V * f
    assert detail["counts"] == {"all-reduce": 1 + 5 * cfg.n_layers,
                                "all-gather": 3 * cfg.n_layers + 2}
    assert detail["tpu_corrected_total"] == total


def test_lm_and_laid_out_weights_run_one_program():
    """An ``LM`` under a shard context is laid out once (views of its
    parameters) and runs the partition: the same logits, caches and
    collectives as ``device_put(LM, serve_shardings(...))``, prefill and
    decode, with every layout of the cache the rules give."""
    cfg = get_smoke_config("qwen2.5-3b")
    model = LM(cfg, device="cpu", seed=0)
    mesh = cpu_mesh((2, 2))
    rules = serve_rules(4)
    laid = device_put(model, steps.serve_shardings(cfg, mesh, rules))
    batch = {"tokens": torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (4, 16), dtype=np.int32))}
    tok = batch["tokens"][:, :1]
    runs = {}
    for name, params in (("lm", model), ("laid", laid)):
        with shard_ctx(rules, mesh), CostCounter() as c:
            logits, cache = steps.make_prefill_step(cfg, 24)(params, batch)
            out = [logits]
            cache["index"] = torch.tensor([16, 3, 23, 9], dtype=torch.int32)
            for _ in range(2):
                logits, cache = steps.make_decode_step(cfg)(params, tok,
                                                            cache)
                out.append(logits)
        runs[name] = (out, cache, c.collectives)
    (o1, c1, r1), (o2, c2, r2) = runs["lm"], runs["laid"]
    assert r1 == r2 and len(r1) > 0
    for a, b in zip(o1, o2):
        assert torch.equal(a, b)
    l1, l2 = sm.tree_leaves(c1), sm.tree_leaves(c2)
    assert l1.keys() == l2.keys()
    for k in l1:
        assert torch.equal(_full(l1[k]), _full(l2[k])), k
    # laid out once for the mesh and rules: the same views at every step
    with shard_ctx(rules, mesh):
        first = steps._laid_out(cfg, model)
        assert steps._laid_out(cfg, model) is first
        blk = first["embed.table"].blocks[0, 0]
        assert blk.untyped_storage().data_ptr() == \
            model.embed.table.untyped_storage().data_ptr()


def _one_device_cases(cfg, model, cache, tok):
    z = torch.zeros(tok.shape[0], dtype=torch.int32)
    return {
        "LM.prefill": lambda: model.prefill({"tokens": tok}, 8),
        "LM.decode": lambda: model.decode(tok, cache),
        "fused decode step": lambda: steps.make_fused_decode_step(cfg)(
            model, tok, cache, z, z, z, z.float()),
        "verify step": lambda: steps.make_verify_step(cfg)(
            model, tok.repeat(1, 2), cache),
        "chunked prefill step": lambda: steps.make_chunked_prefill_step(
            cfg, 8, 2)(model, {"tokens": tok.repeat(1, 4)}),
    }


@pytest.mark.parametrize("case", ["LM.prefill", "LM.decode",
                                  "fused decode step", "verify step",
                                  "chunked prefill step"])
def test_one_device_serve_refuses_a_shard_context(case):
    """Under a shard context the one-device serve route would run whole at
    every position: it raises and names the steps that run the
    partition; outside one it runs."""
    cfg = get_smoke_config("qwen2.5-3b")
    model = LM(cfg, device="cpu", seed=0)
    tok = torch.ones((2, 1), dtype=torch.int32)
    cache = LM.init_cache(cfg, 2, 8, device="cpu")
    fn = _one_device_cases(cfg, model, cache, tok)[case]
    with shard_ctx(SERVE_RULES, cpu_mesh((1, 2))):
        with pytest.raises(ValueError, match="make_decode_step"):
            fn()
    with torch.no_grad():
        fn()


# ------------------------------------------------------------ EP MoE


@pytest.mark.parametrize("shape", [(2, 4), (1, 4), (4, 2), (1, 1)])
@pytest.mark.parametrize("E", [8, 6])
@pytest.mark.parametrize("B", [4, 3])
def test_ep_taken_where_the_reference_takes_it(shape, E, B):
    mcfg = MoECfg(n_experts=E, top_k=2, d_ff_expert=8)
    moe = MoE(8, mcfg, dtype=torch.float32, device="cpu")
    mesh = FakeMesh(shape)
    with shard_ctx(TRAIN_RULES, mesh):
        got = moe._ep_ctx(B)
    # the reference's test, moe.py:81-91
    m = shape[1]
    assert (got is not None) == (m > 1 and E % m == 0 and B % shape[0] == 0)


@functools.lru_cache(maxsize=None)
def moe_pair():
    from repro.models import ModelConfig as RefModelConfig
    from repro.models import MoECfg as RefMoECfg
    kw = dict(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=4.0)
    rcfg = RefModelConfig(**MOE, moe=RefMoECfg(**kw))
    tokens = np.random.default_rng(2).integers(0, 64, (4, 16),
                                               dtype=np.int32)

    def run(key, tokens):          # one compile: init and the forward
        params = RefLM.init(key, rcfg)[0]
        return params, RefLM.apply(params, {"tokens": tokens}, rcfg)
    params, ref = _np_tree(compiled(run, jax.random.PRNGKey(0), tokens))
    model = from_reference(params, ModelConfig(**MOE, moe=MoECfg(**kw)),
                           device="cpu")
    return tokens, ref, model


def test_ep_matches_reference_global_path():
    tokens, (want, want_aux), model = moe_pair()
    with torch.no_grad(), shard_ctx(TRAIN_RULES, cpu_mesh((2, 4))):
        got, aux = model({"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert abs(float(aux["z_loss"]) - float(want_aux["z_loss"])) < 1e-3
    assert float(aux["drop_frac"]) == 0.0


def test_ep_gradients_flow_and_match_the_global_path():
    tokens, _, model = moe_pair()
    t = torch.from_numpy(tokens)
    batch = {"tokens": t, "labels": t}
    (loss0, _), g0 = steps.loss_and_grads(model, batch)
    # data = 1: the router's lb_loss is the global one (data > 1 averages
    # per-shard losses, as the reference's EP body does)
    with shard_ctx(TRAIN_RULES, cpu_mesh((1, 4))):
        (loss1, (_, aux)), g1 = steps.loss_and_grads(model, batch)
    assert float(aux["drop_frac"]) == 0.0
    assert abs(float(loss1) - float(loss0)) < TOL
    assert g1.keys() == g0.keys()
    for k in g0:
        assert torch.isfinite(g1[k]).all(), k
        torch.testing.assert_close(g1[k], g0[k], rtol=TOL, atol=TOL)
    assert any(float(g.abs().max()) > 0 for k, g in g1.items()
               if ".moe." in k)
    with shard_ctx(TRAIN_RULES, cpu_mesh((2, 4))):
        (loss2, _), g2 = steps.loss_and_grads(model, batch)
    assert all(torch.isfinite(g).all() for g in g2.values())


# ------------------------------------------------------------ the reference's
# own sharded bodies, in a subprocess with 8 host devices

SUB = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.models import LM, ModelConfig, MoECfg
from repro.models.moe import MoE
from repro.sharding import SERVE_RULES, TRAIN_RULES, shard_ctx
out = {}
def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        out[prefix] = np.asarray(tree)
# Auto axes: jax.make_mesh builds Explicit ones, where constraints raise
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
def compiled(fn, *args):        # XLA backend optimization level 0
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})
key = jax.random.PRNGKey(0)
cfg = ModelConfig(**DENSE)
params = compiled(lambda k: LM.init(k, cfg)[0], key)(key)
tokens = jax.random.randint(key, (8, 16), 0, 64)
pre = lambda p, t: LM.prefill(p, {"tokens": t}, cfg, max_seq=32)
lp, cache = compiled(pre, params, tokens)(params, tokens)
def dec(p, t, c):
    with shard_ctx(SERVE_RULES, mesh):
        return LM.decode(p, t, cfg, c)
t = jnp.argmax(lp[:, 0], -1).astype(jnp.int32)[:, None]
dec = compiled(dec, params, t, cache)
put("dense/params", params)
put("dense/cache0", cache)
cache0, tok1 = cache, t
for step in (1, 2):
    out["dense/tok%d" % step] = np.asarray(t)
    ld, cache = dec(params, t, cache)
    out["dense/logits%d" % step] = np.asarray(ld)
    put("dense/cache%d" % step, cache)
    t = jnp.argmax(ld[:, 0], -1).astype(jnp.int32)[:, None]
# the layouts the split-K body does not take, through the jitted decode
def dec_on(shape):
    m_ = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape),
              ("data", "model"))
    def f(p, t, c):
        with shard_ctx(SERVE_RULES, m_):
            return LM.decode(p, t, cfg, c)
    return f
L, B, Smax = cache0["layers"]["k"].shape[:3]
bk = 8
fallbacks = {
    "vector index": ((1, 4), dict(cache0, index=jnp.full(
        (B,), cache0["index"], jnp.int32))),
    "Smax % m": ((1, 3), cache0),
    "paged": ((1, 4), dict(cache0, layers={
        n: v.reshape(L, B * Smax // bk, bk, *v.shape[3:])
        for n, v in cache0["layers"].items()}, block_tbl=jnp.arange(
            B * Smax // bk, dtype=jnp.int32).reshape(B, Smax // bk))),
}
for case, (shape, c) in fallbacks.items():
    ld, cn = compiled(dec_on(shape), params, tok1, c)(params, tok1, c)
    out["fallback/%s/logits" % case] = np.asarray(ld)
    put("fallback/%s/cache" % case, cn)
mcfg = MoECfg(**MOE_CFG)
k1 = jax.random.PRNGKey(1)
mp = compiled(lambda k: MoE.init(k, 32, mcfg)[0], k1)(k1)
x = jax.random.normal(jax.random.PRNGKey(2), (4, 16, 32), jnp.float32)
def ep(p, x):
    with shard_ctx(TRAIN_RULES, mesh):
        return MoE.apply(p, x, mcfg)
y, aux = compiled(ep, mp, x)(mp, x)
put("moe/params", mp)
out["moe/x"] = np.asarray(x)
out["moe/y"] = np.asarray(y)
put("moe/aux", aux)
np.savez(sys.argv[1], **out)
"""
MOE_DROPS = dict(n_experts=8, top_k=2, d_ff_expert=32, capacity_factor=1.0)


@pytest.fixture(scope="module")
def reference_bodies():
    """Started when the module's first test asks for it; the other tests
    run while it works."""
    tmp = tempfile.mkdtemp(prefix="model-axis-")
    path = os.path.join(tmp, "ref.npz")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    code = f"DENSE = {DENSE!r}\nMOE_CFG = {MOE_DROPS!r}\n" + SUB
    proc = subprocess.Popen([sys.executable, "-c", code, path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def result():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        z = np.load(path)
        tree: dict = {}
        for k in z.files:
            node = tree
            *head, last = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = z[k]
        return tree
    yield functools.lru_cache(maxsize=None)(result)
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module", autouse=True)
def start_reference_bodies(reference_bodies):
    yield


def test_port_matches_the_reference_splitk_body(reference_bodies):
    d = reference_bodies()["dense"]
    model = from_reference(d["params"], ModelConfig(**DENSE), device="cpu")
    cache = _torch_tree(d["cache0"])
    step_fn = steps.make_decode_step(model.cfg)
    with shard_ctx(SERVE_RULES, cpu_mesh((2, 4))):
        for step in (1, 2):
            logits, cache = step_fn(model, torch.from_numpy(d[f"tok{step}"]),
                                    cache)
            np.testing.assert_allclose(logits.numpy(), d[f"logits{step}"],
                                       rtol=TOL, atol=TOL)
            _close_trees(cache, d[f"cache{step}"])


@pytest.mark.parametrize("case", ["vector index", "Smax % m", "paged"])
def test_splitk_fallbacks_leave_the_path(reference_bodies, monkeypatch,
                                         case):
    """The layouts the reference's split-K path does not take hold to its
    jitted decode under ``shard_ctx(SERVE_RULES, mesh)`` on the same mesh
    (its per-row and paged paths, partitioned by XLA): a ring that "model"
    does not divide (nor its 2 KV heads: every head on each rank's whole
    copy) and a paged pool run no split-K body; a vector index over a
    ring split over "model" runs the split-K body with each row's own
    index (the reference's per-row path over the split cache)."""
    d = reference_bodies()["dense"]
    model = from_reference(d["params"], ModelConfig(**DENSE), device="cpu")
    base = _torch_tree(d["cache0"])
    mesh = cpu_mesh((1, 4))
    if case == "vector index":
        base["index"] = torch.full((8,), int(base["index"]),
                                   dtype=torch.int32)
    elif case == "Smax % m":
        mesh = cpu_mesh((1, 3))                       # 32 % 3 != 0
    else:
        bk = 8
        L, B, Smax = base["layers"]["k"].shape[:3]
        base["layers"] = {n: v.reshape(L, B * Smax // bk, bk,
                                       *v.shape[3:]).clone()
                          for n, v in base["layers"].items()}
        base["block_tbl"] = torch.arange(B * Smax // bk, dtype=torch.int32
                                         ).reshape(B, Smax // bk)
    calls = []
    body = Attention.__dict__["_splitk_body"].__func__
    monkeypatch.setattr(Attention, "_splitk_body", staticmethod(
        lambda *a: calls.append(1) or body(*a)))
    with shard_ctx(SERVE_RULES, mesh):
        got, cache = steps.make_decode_step(model.cfg)(
            model, torch.from_numpy(d["tok1"]), base)
    want = reference_bodies()["fallback"][case]
    np.testing.assert_allclose(got.numpy(), want["logits"], rtol=TOL,
                               atol=TOL)
    _close_trees(cache, want["cache"])
    split = case == "vector index"
    assert len(calls) == (model.cfg.n_layers if split else 0)
    for n in ("k", "v"):                # the sequence (or the blocks) whole
        assert (cache["layers"][n].spec[2:3] == ("model",)) == split
    for k in ("index", "block_tbl"):
        if k in base:
            assert np.array_equal(_full(cache[k]).numpy(), want["cache"][k])


def test_port_matches_the_reference_ep_body_with_drops(reference_bodies):
    d = reference_bodies()["moe"]
    moe = MoE(32, MoECfg(**MOE_DROPS), dtype=torch.float32, device="cpu")
    with torch.no_grad():
        moe.router.w.copy_(torch.from_numpy(d["params"]["router"]["w"]))
        for n in ("gate", "up", "down"):
            getattr(moe, n).copy_(torch.from_numpy(d["params"][n]))
    moe.router.recast()
    moe.recast()
    with torch.no_grad(), shard_ctx(TRAIN_RULES, cpu_mesh((2, 4))):
        y, aux = moe(torch.from_numpy(d["x"]))
    want = d["aux"]
    assert float(want["drop_frac"]) > 0                 # drops were made
    assert np.array_equal(aux["drop_frac"].numpy(), want["drop_frac"])
    assert np.array_equal(aux["expert_load"].numpy(), want["expert_load"])
    np.testing.assert_allclose(y.numpy(), d["y"], rtol=TOL, atol=TOL)
    for k in ("lb_loss", "z_loss"):
        np.testing.assert_allclose(aux[k].numpy(), want[k], rtol=TOL,
                                   atol=TOL)


# ------------------------------------------------------------ collective bytes

HLO_KINDS = {"all-reduce": "all-reduce", "all-gather": "all-gather",
             "reduce-scatter": "reduce-scatter", "all-to-all": "all-to-all",
             "collective-permute": "collective-permute"}


def _hlo_line(i, kind, dims, dtype, n):
    shape = f"{dtype}[{','.join(map(str, dims))}]"
    groups = "{" + ",".join("{" + ",".join(str(g * n + j) for j in range(n))
                            + "}" for g in range(2)) + "}"
    return (f"  %{kind}.{i} = {shape}{{0}} {kind}({shape} %p{i}), "
            f"replica_groups={groups}, to_apply=%add")


@pytest.mark.parametrize("n", [1, 2, 4, 16])
def test_collective_bytes_equal_the_reference_formulas(n):
    itemsize = {"f32": 4, "bf16": 2, "s32": 4}
    cases = [(kind, dims, dt) for kind in HLO_KINDS
             for dims, dt in (((8, 2, 8), "f32"), ((16,), "bf16"),
                              ((3, 5), "s32"))]
    lines = [_hlo_line(i, kind, dims, dt, n)
             for i, (kind, dims, dt) in enumerate(cases)]
    records = [(kind, math.prod(dims) * itemsize[dt], n)
               for kind, dims, dt in cases]
    total, detail = collective_bytes(records)
    r_total, r_detail = ref_collective_bytes("\n".join(lines))
    assert total == pytest.approx(r_total, rel=1e-12)
    assert detail["counts"] == r_detail["counts"]
    assert detail["bytes"] == pytest.approx(r_detail["bytes"], rel=1e-12)
    assert detail["tpu_corrected_total"] == total


# ------------------------------------------------------------ production mesh


@pytest.mark.parametrize("multi_pod", [False, True])
def test_make_production_mesh(multi_pod):
    n = 512 if multi_pod else 256
    mesh = make_production_mesh(multi_pod=multi_pod, devices=["cpu"] * n)
    assert mesh.devices.shape == ((2, 16, 16) if multi_pod else (16, 16))
    assert mesh.axis_names == (("pod", "data", "model") if multi_pod
                               else ("data", "model"))
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    if torch.cuda.device_count() < n:
        with pytest.raises(RuntimeError, match=f"{n} CUDA devices"):
            make_production_mesh(multi_pod=multi_pod)
    with pytest.raises(ValueError):
        make_production_mesh(multi_pod=multi_pod, devices=["cpu"] * 3)

