"""Training over a ("data", "model") mesh (``models.steps``' sharded train
step, ``launch/elastic.py``, the re-sharding restore, ``--mesh``) against
the reference, on the CPU, in float32 at smoke configs.

* A subprocess with 8 host devices a config runs the reference's own mesh
  step: ``make_train_step`` under ``shard_ctx(TRAIN_RULES, mesh)``, jitted
  with the ``tree_shardings`` of ``train_state_axes`` in and out (as
  ``src/repro/launch/train.py`` builds it), on a (2, 4) mesh built with
  ``jax.sharding.Mesh`` (Auto axes: ``jax.make_mesh`` builds Explicit ones
  under this JAX, where the reference's constraints raise).  Three
  configs: qwen2.5-3b's smoke config, the padded-heads config of
  ``tests/test_perf_paths.py`` (10 heads over 2 KV heads pad to 12 on a
  4-wide "model" axis) and olmoe-1b-7b's smoke config (8 experts: the EP
  path, with capacity drops).  Over 3 steps from the weights the bridge
  carries across, every metric is within 1e-5 relative, and every leaf of
  the parameters, ``mu`` and ``nu`` within 1e-5 x max(1, max |leaf|).
* The port's mesh step against its own one-device step, same tolerances,
  on (2, 4), (2, 2) (K/V heads split over "model"), (1, 4) and (4, 1) (the
  MoE where EP and the global path agree: data = 1, or no "model" axis),
  and h2o-danube-1.8b's smoke config (a sliding window, an untied
  readout) on (2, 2).
* Block-wise properties: the global norm counts each distinct block once;
  the loss is token-weighted when the shards hold unequal numbers of valid
  labels; ``_padded_heads``, ``_wo_padded`` and the padded q projection
  equal the reference's exactly.
* The collectives ``CostCounter`` records for one (2, 2) step are what the
  layout implies, gradients' reduce-scatters and replicated leaves'
  psums included (on one device a shared block's gradient would otherwise
  simply accumulate).
* Elastic: 4 steps on (2, 2), ``elastic_restore`` onto (1, 4), 2 more
  steps equal 6 uninterrupted steps; the restored state is bitwise the
  saved one; a mesh checkpoint has a one-device one's files, shapes and
  dtypes and restores into a one-device state bitwise.  The launcher's
  ``--mesh 2,2 --device cpu --resume`` equals an uninterrupted run.
* The launcher's ``--mesh 2,2`` trains the SSM, hybrid, VLM and
  encoder-decoder families too, equal to its one-device run (the families'
  own partitions are tested in ``tests/test_torch_train_mesh_families.py``).
"""
import collections
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as RefModelConfig
from repro.models.attention import Attention as RefAttention
from repro.sharding import TRAIN_RULES as REF_TRAIN_RULES
from repro.sharding import shard_ctx as ref_shard_ctx

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, TokenPipeline, extra_inputs
from repro_torch.launch import train as launcher
from repro_torch.launch.cost import CostCounter
from repro_torch.launch.elastic import ReMesh, elastic_restore, state_shardings
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import ModelConfig, steps
from repro_torch.models.attention import Attention
from repro_torch.models.bridge import from_reference, to_reference
from repro_torch.optim import global_norm
from repro_torch.optim.adamw import global_norm_blocks
from repro_torch.sharding import TRAIN_RULES, device_put, shard_ctx
from repro_torch.sharding import shard_map as sm

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
B, S, STEPS = 4, 16, 3
# tests/test_perf_paths.py's padded-heads config: 10 heads, KV 2 → 12 on 4
PADDED = dict(name="t", family="dense", n_layers=2, d_model=40, n_heads=10,
              n_kv_heads=2, d_ff=64, vocab=64, head_dim=4,
              param_dtype="float32", dtype="float32")
CONFIGS = {"dense": "qwen2.5-3b", "padded": PADDED, "moe": "olmoe-1b-7b"}
# port-only: a sliding window (8 of 16 tokens) and an untied readout
WINDOW = "h2o-danube-1.8b"


def port_cfg(name):
    c = {**CONFIGS, "window": WINDOW}[name]
    return get_smoke_config(c) if isinstance(c, str) else ModelConfig(**c)


def cpu_mesh(shape):
    return make_mesh(shape, ("data", "model"),
                     devices=["cpu"] * math.prod(shape))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- the reference's mesh step

SUB = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.configs import get_smoke_config
from repro.data import DataConfig, TokenPipeline, extra_inputs
from repro.models import ModelConfig
from repro.models.steps import (init_train_state, make_train_step,
                                train_state_axes)
from repro.sharding import TRAIN_RULES, shard_ctx, tree_shardings
out = {}
def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        out[prefix] = np.asarray(tree)
# Auto axes: jax.make_mesh builds Explicit ones, where constraints raise
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
opts = {"xla_backend_optimization_level": 0}
cfg = get_smoke_config(C) if isinstance(C, str) else ModelConfig(**C)
step_fn, (opt_init, _) = make_train_step(cfg)
key = jax.random.PRNGKey(0)
state = jax.jit(lambda k: init_train_state(k, cfg, opt_init)).lower(
    key).compile(compiler_options=opts)(key)
sh = tree_shardings(train_state_axes(cfg), TRAIN_RULES, mesh,
                    shapes_tree=state)
def sharded(st, b):
    with shard_ctx(TRAIN_RULES, mesh):
        return step_fn(st, b)
data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=SEQ,
                                global_batch=BATCH, seed=3))
batches = [{k: jnp.asarray(v) for k, v in
            extra_inputs(cfg, data.batch(i)).items()} for i in range(STEPS)]
put("params0", state.params)
state = jax.device_put(state, sh)
step = jax.jit(sharded, in_shardings=(sh, None),
               out_shardings=(sh, None)).lower(
    state, batches[0]).compile(compiler_options=opts)
for i, b in enumerate(batches):
    put(f"batch{i}", dict(b))
    state, m = step(state, b)
    put(f"metrics{i}", m)
for part, tree in (("params", state.params), ("mu", state.opt_state.mu),
                   ("nu", state.opt_state.nu)):
    put(part, tree)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def reference_steps():
    """One subprocess a config, all started when the module's first test
    asks for them; the port-only tests run while they work."""
    tmp = tempfile.mkdtemp(prefix="train-mesh-")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for name, c in CONFIGS.items():
        code = (f"C = {c!r}\nSEQ = {S}\nBATCH = {B}\nSTEPS = {STEPS}\n"
                + SUB)
        path = os.path.join(tmp, f"{name}.npz")
        procs[name] = (path, subprocess.Popen(
            [sys.executable, "-c", code, path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    def result(name):
        path, proc = procs[name]
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
    for _, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module", autouse=True)
def start_reference_steps(reference_steps):
    yield


def _flat(tree, pre=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _flat(sub, f"{pre}/{key}").items()}
    return {pre: np.asarray(tree)}


def mesh_state(cfg, mesh, model):
    """A one-device state over ``model`` laid out on ``mesh``."""
    _, (opt_init, _) = steps.make_train_step(cfg)
    state = steps.TrainState(model, opt_init(dict(model.named_parameters())),
                             0)
    return device_put(state, state_shardings(cfg, mesh)[0])


def run(step, state, batches, mesh=None):
    out = []
    for b in batches:
        if mesh is None:
            state, m = step(state, b)
        else:
            with shard_ctx(TRAIN_RULES, mesh):
                state, m = step(state, b)
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def whole(tree: dict) -> dict:
    return {k: v.full() if isinstance(v, sm.ShardedArray) else v.detach()
            for k, v in tree.items()}


def state_leaves(state) -> dict:
    params = (dict(state.params.named_parameters())
              if isinstance(state.params, torch.nn.Module) else state.params)
    return {"params": whole(params), "mu": whole(state.opt_state.mu),
            "nu": whole(state.opt_state.nu)}


def assert_leaves_close(got: dict, want: dict, what=""):
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(w).max())),
                                   err_msg=f"{what}{k}")


def assert_metrics_close(got, want):
    for g, w in zip(got, want, strict=True):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], rtol=TOL, atol=0,
                                       err_msg=k)


def port_batches(cfg, n=STEPS, batch=B):
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=S,
                                    global_batch=batch, seed=3))
    return [{k: torch.from_numpy(v) for k, v in
             extra_inputs(cfg, data.batch(i)).items()} for i in range(n)]


# ------------------------------------------------- against one device

ONE_DEVICE = [("dense", (2, 4)), ("dense", (2, 2)), ("dense", (1, 4)),
              ("dense", (4, 1)),
              ("padded", (2, 4)), ("padded", (1, 4)), ("padded", (4, 1)),
              ("moe", (1, 4)), ("moe", (4, 1)), ("window", (2, 2))]


@pytest.mark.parametrize("name,shape", ONE_DEVICE)
def test_mesh_step_matches_the_one_device_step(name, shape):
    cfg = port_cfg(name)
    if name == "moe":       # dropless: a drop depends on the token set
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=4.0))
    step, (opt_init, _) = steps.make_train_step(cfg)
    batches = port_batches(cfg)
    one, want = run(step, steps.init_train_state(0, cfg, opt_init,
                                                 device="cpu"), batches)
    mesh = cpu_mesh(shape)
    model = steps.init_train_state(0, cfg, opt_init, device="cpu").params
    sharded, got = run(step, mesh_state(cfg, mesh, model), batches, mesh)
    assert_metrics_close(got, want)
    a, b = state_leaves(sharded), state_leaves(one)
    for part in a:
        assert_leaves_close(a[part], b[part], f"{part}/")


# ------------------------------------------------- block-wise properties

def test_global_norm_counts_each_distinct_block_once():
    mesh = cpu_mesh((2, 2))
    g = torch.Generator().manual_seed(0)
    specs = {"rep": (), "data": ("data",), "model": (None, "model"),
             "both": ("data", "model")}
    full = {k: torch.randn(4, 6, generator=g) for k in specs}
    grads = {k: {p: b.clone() for p, b in sm.split(full[k], s, mesh).items()}
             for k, s in specs.items()}
    got = global_norm_blocks(grads, specs, mesh)
    want = float(global_norm(full))
    assert len({float(v) for v in got.values()}) == 1
    assert abs(float(got[(0, 0)]) - want) <= 1e-6 * want
    every = math.sqrt(sum(float(b.square().sum()) for d in grads.values()
                          for b in d.values()))
    assert every > want * 1.1          # counting replicas would inflate it


def test_loss_is_token_weighted_over_unequal_shards():
    cfg = get_smoke_config("qwen2.5-3b")
    step, (opt_init, _) = steps.make_train_step(cfg)
    batch = port_batches(cfg, n=1, batch=2)[0]
    batch["labels"][0, 3:] = -1       # data shard 0: 3 valid labels of 16
    _, want = run(step, steps.init_train_state(0, cfg, opt_init,
                                               device="cpu"), [batch])
    mesh = cpu_mesh((2, 2))
    model = steps.init_train_state(0, cfg, opt_init, device="cpu").params
    _, got = run(step, mesh_state(cfg, mesh, model), [batch], mesh)
    assert_metrics_close(got, want)
    with torch.no_grad():
        logits, _ = model({"tokens": batch["tokens"]})
    shard_means = [float(steps.cross_entropy(logits[i:i + 1],
                                             batch["labels"][i:i + 1]))
                   for i in range(2)]
    assert abs(sum(shard_means) / 2 - want[0]["ce"]) > 1e-3


class FakeMesh:
    """Duck-typed mesh read alike by both packages' contexts."""

    def __init__(self, shape, axes=("data", "model")):
        self.axis_names = tuple(axes)
        self.devices = np.empty(shape, object)


@pytest.mark.parametrize("H,KV,m", [(10, 2, 4), (40, 8, 16), (16, 2, 4),
                                    (12, 4, 8), (14, 2, 4), (4, 4, 1)])
def test_padded_heads_equal_the_reference(H, KV, m):
    with shard_ctx(TRAIN_RULES, FakeMesh((2, m))):
        got = Attention._padded_heads((0, 0, H, 4), KV)
    with ref_shard_ctx(REF_TRAIN_RULES, FakeMesh((2, m))):
        want = RefAttention._padded_heads((0, 0, H, 4), KV)
    assert got == want
    assert Attention._padded_heads((0, 0, H, 4), KV) is None    # no context
    if got is None:
        return
    Hp, G, Gp = got
    hd, d = 4, 8
    rng = np.random.default_rng(H * 100 + m)
    w = rng.standard_normal((H * hd, d)).astype(np.float32)
    assert np.array_equal(
        Attention._wo_padded(torch.from_numpy(w), KV, G, Gp, hd).numpy(),
        np.asarray(RefAttention._wo_padded({"wo": {"w": jnp.asarray(w)}},
                                           KV, G, Gp, hd)))
    # the padded q projection: fed the identity, q is the padded weight
    # plus bias, exactly
    cfg = RefModelConfig(name="t", family="dense", n_layers=1, d_model=d,
                         n_heads=H, n_kv_heads=KV, d_ff=8, vocab=8,
                         head_dim=hd, qkv_bias=True, param_dtype="float32",
                         dtype="float32")
    wq = rng.standard_normal((d, H * hd)).astype(np.float32)
    bq = rng.standard_normal((H * hd,)).astype(np.float32)
    kv = {"w": jnp.zeros((d, KV * hd)), "b": jnp.zeros((KV * hd,))}
    params = {"wq": {"w": jnp.asarray(wq), "b": jnp.asarray(bq)},
              "wk": kv, "wv": kv}
    eye = jnp.eye(d, dtype=jnp.float32)[None]
    q, _, _ = RefAttention.qkv(params, eye, eye, cfg, pad_hp=Hp)
    pw, pb = Attention._wq_padded(torch.from_numpy(wq), torch.from_numpy(bq),
                                  KV, G, Gp, hd)
    assert np.array_equal((pw + pb).numpy(),
                          np.asarray(q).reshape(d, Hp * hd))


@pytest.mark.parametrize("remat", ["none", "full"])
def test_collectives_of_one_step_follow_the_layout(remat):
    """qwen2.5-3b smoke (2 layers, 4 heads over 2 KV heads, d_ff 64, tied
    vocab 128) on (2, 2): every weight matrix is split over "data" on its
    embed dim (7 a layer and the table), so each is all-gathered over
    "data" once and its gradient reduce-scattered once; the embedding
    lookup and each layer's attention and MLP end in a "model" psum, whose
    backward psums again; the vocab-split CE makes a pmax and two psums (2
    backward); the token mean one psum over "data" (1 backward); the
    biases (split over "model") psum their gradients over "data", the
    norms (replicated) over both axes; the global norm one psum over
    both.  With ``remat="full"`` each layer's recompute runs its forward
    collectives again: its 7 gathers and its 2 "model" psums."""
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"), remat=remat)
    L = cfg.n_layers
    again = remat != "none"
    step, (opt_init, _) = steps.make_train_step(cfg)
    mesh = cpu_mesh((2, 2))
    model = steps.init_train_state(0, cfg, opt_init, device="cpu").params
    state = mesh_state(cfg, mesh, model)
    with CostCounter() as c, shard_ctx(TRAIN_RULES, mesh):
        step(state, port_batches(cfg, n=1, batch=2)[0])
    got = collections.Counter((k, n) for k, _, n in c.collectives)
    gathered = 7 * L + 1
    want = {("all-gather", 2): gathered + again * 7 * L,
            ("reduce-scatter", 2): gathered,
            ("all-reduce", 2): (2 * (2 * L + 1)          # "model" psums
                                + again * 2 * L         # their recompute
                                + 1 + 2 * 2             # CE
                                + 2                     # token mean
                                + 3 * L),               # bias gradients
            ("all-reduce", 4): (2 * L + 1) + 1}         # norms, global norm
    assert dict(got) == want
    table = cfg.vocab // 2 * cfg.d_model * 4          # float32 bytes
    assert (("all-gather", table, 2) in c.collectives
            and ("reduce-scatter", table // 2, 2) in c.collectives)


def test_collectives_backward_reduce_scatter_and_psum():
    """An all-gather's backward reduce-scatters and a psum's backward
    psums: gradients equal plain autograd's of the global function, and
    each is one record."""
    mesh = cpu_mesh((2, 2))
    g = torch.Generator().manual_seed(1)
    w = torch.randn(4, 3, generator=g, dtype=torch.float64)
    x = torch.randn(5, 4, generator=g, dtype=torch.float64)
    leaves = {p: b.clone().requires_grad_()
              for p, b in sm.split(w, ("data",), mesh).items()}
    with CostCounter() as c:
        gathered = sm.all_gather(leaves, "data", mesh, dim=0)
        y = sm.psum({p: (x @ t).sum() * (1 + sum(p))
                     for p, t in gathered.items()}, "model", mesh)
        grads = dict(zip(leaves, torch.autograd.grad(
            y[(0, 0)] + y[(1, 0)], list(leaves.values()))))
    assert [k for k, _, _ in c.collectives] == [
        "all-gather", "all-reduce", "all-reduce", "reduce-scatter"]
    grads = sm.psum(grads, "model", mesh)     # the leaf is replicated there
    w2 = w.clone().requires_grad_()
    total = sum((x @ w2).sum() * (1 + sum(p)) for p in sm.positions(mesh))
    want, = torch.autograd.grad(total, w2)
    for p, gp in grads.items():
        assert torch.allclose(gp, want[2 * p[0]:2 * p[0] + 2])
    tm = sm.token_mean({p: torch.tensor(float(p[0] + 1))
                        for p in sm.positions(mesh)},
                       {p: torch.tensor(float(2 * p[0] + 1))
                        for p in sm.positions(mesh)}, "data", mesh)
    assert all(float(v) == 3 / 4 for v in tm.values())


# ------------------------------------------------- elastic and the launcher

def test_elastic_restore_onto_another_mesh(tmp_path):
    cfg = get_smoke_config("qwen2.5-3b")
    step, (opt_init, _) = steps.make_train_step(cfg)
    batches = port_batches(cfg, n=6)
    mesh = cpu_mesh((2, 2))
    fresh = lambda: steps.init_train_state(0, cfg, opt_init,
                                           device="cpu").params
    state, _ = run(step, mesh_state(cfg, mesh, fresh()), batches[:4], mesh)
    CheckpointManager(tmp_path / "mesh").save(4, state, blocking=True)
    restored, step2, mesh2 = elastic_restore(
        str(tmp_path / "mesh"), cfg, ReMesh(data_axis=1, model_axis=4),
        devices=["cpu"] * 4)
    assert dict(mesh2.shape) == {"data": 1, "model": 4}
    assert restored.step == 4 and restored.opt_state.step == 4
    saved, back = state_leaves(state), state_leaves(restored)
    for part in saved:
        for k in saved[part]:
            assert torch.equal(back[part][k], saved[part][k]), (part, k)
    assert restored.params["embed.table"].spec == ("model", "data")
    assert restored.params["embed.table"].blocks[(0, 3)].shape == (
        cfg.vocab // 4, cfg.d_model)
    _, got = run(step2, restored, batches[4:])
    straight, want = run(step, mesh_state(cfg, mesh, fresh()), batches, mesh)
    assert_metrics_close(got, want[4:])
    for part, leaves in state_leaves(restored).items():
        assert_leaves_close(leaves, state_leaves(straight)[part], part)
    # a mesh checkpoint: a one-device one's files, shapes and dtypes, and
    # it restores into a one-device state bitwise
    one, _ = run(step, steps.init_train_state(0, cfg, opt_init,
                                              device="cpu"), batches[:4])
    CheckpointManager(tmp_path / "one").save(4, one, blocking=True)
    files = lambda d: sorted(f.name for f in d.iterdir())
    man = lambda d: json.loads((d / "manifest.json").read_text())["leaves"]
    assert files(tmp_path / "mesh" / "step_4") == files(
        tmp_path / "one" / "step_4")
    assert man(tmp_path / "mesh" / "step_4") == man(tmp_path / "one" /
                                                    "step_4")
    into, _ = CheckpointManager(tmp_path / "mesh").restore(
        steps.init_train_state(1, cfg, opt_init, device="cpu"))
    assert isinstance(into.params, torch.nn.Module)
    for part, leaves in state_leaves(into).items():
        for k, v in leaves.items():
            assert torch.equal(v, saved[part][k]), (part, k)


ARGS = ["--arch", "qwen2.5-3b", "--smoke", "--seq", "32", "--batch", "2",
        "--device", "cpu", "--mesh", "2,2"]


def test_launcher_resumes_on_a_mesh(tmp_path):
    ck, straight = tmp_path / "ck", tmp_path / "straight"
    assert launcher.main(ARGS + ["--steps", "3", "--ckpt-dir", str(ck)]) == 0
    assert launcher.main(ARGS + ["--steps", "5", "--ckpt-dir", str(ck),
                                 "--resume", "--log",
                                 str(tmp_path / "a.jsonl")]) == 0
    assert launcher.main(ARGS + ["--steps", "5", "--ckpt-dir", str(straight),
                                 "--log", str(tmp_path / "b.jsonl")]) == 0
    read = lambda p: [{k: v for k, v in json.loads(line).items()
                       if k != "sec"} for line in p.read_text().splitlines()]
    assert read(tmp_path / "a.jsonl")[-1] == read(tmp_path / "b.jsonl")[-1]
    a, b = ck / "step_5", straight / "step_5"
    names = sorted(f.name for f in a.glob("*.npy"))
    assert names == sorted(f.name for f in b.glob("*.npy")) and names
    for n in names:
        assert np.load(a / n).tobytes() == np.load(b / n).tobytes(), n


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b",
                                  "qwen2-vl-7b", "seamless-m4t-medium"])
def test_launcher_trains_every_family_on_a_mesh(arch, tmp_path):
    """``--mesh 2,2`` trains the SSM, hybrid, VLM and encoder-decoder
    families (with the extras ``data.extra_inputs`` makes) and equals the
    one-device launcher's run."""
    args = ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
            "--seq", "8", "--batch", "4"]
    logs = {}
    for label, extra in (("one", []), ("mesh", ["--mesh", "2,2"])):
        logs[label] = tmp_path / f"{label}.jsonl"
        assert launcher.main(args + extra + ["--log",
                                             str(logs[label])]) == 0
    read = lambda p: [{k: v for k, v in json.loads(line).items()
                       if k != "sec"} for line in p.read_text().splitlines()]
    one, mesh = read(logs["one"]), read(logs["mesh"])
    assert [r["step"] for r in mesh] == [r["step"] for r in one] == [1, 2]
    assert_metrics_close(mesh, one)


# ------------------------------------------------- the reference, read last
# (the port-only tests above run while its subprocess works)

@pytest.mark.parametrize("name", list(CONFIGS))
def test_mesh_step_matches_the_reference_mesh_step(reference_steps, name):
    ref = reference_steps(name)
    cfg = port_cfg(name)
    mesh = cpu_mesh((2, 4))
    model = from_reference(ref["params0"], cfg, device="cpu")
    step, _ = steps.make_train_step(cfg)
    batches = [{k: torch.from_numpy(v) for k, v in ref[f"batch{i}"].items()}
               for i in range(STEPS)]
    state, got = run(step, mesh_state(cfg, mesh, model), batches, mesh)
    want = [{k: float(v) for k, v in ref[f"metrics{i}"].items()}
            for i in range(STEPS)]
    assert_metrics_close(got, want)
    if name == "moe":
        assert want[0]["drop_frac"] > 0                 # drops were made
    for part, leaves in state_leaves(state).items():
        assert_leaves_close(_flat(to_reference(leaves, cfg)),
                            _flat(ref[part]), f"{part}")
