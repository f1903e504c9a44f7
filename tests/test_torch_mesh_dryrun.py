"""The dry-run on the production mesh (``launch/dryrun.py``'s mesh cells,
``sharding.shard_map.LoneMesh``), the serve steps partitioned under
``serve_rules`` (``models/steps.py``'s prefill and decode over laid-out
weights) and ``cfg.remat`` on the train route, on the CPU, at smoke
configs, against the reference.

* remat: ``"full"`` checkpoints each layer (each hybrid group) of the train
  route, one device and (2, 4): gradients bitwise equal to ``"none"``'s
  (dense, MoE, zamba2), with fewer tensors saved for the backward; over a
  mesh the updated state (AdamW's first moment is (1 - b1) x the clipped
  gradient) bitwise, and the recompute's gathers recorded again.
* One subprocess with 8 host devices runs the reference's jitted prefill
  and decode steps under ``shard_ctx(serve_rules(B), mesh)`` with the
  dry-run's shardings (``out_shardings``: the logits replicated, the cache
  laid out by ``cache_axes``), on Auto-typed (2, 4) and (2, 2, 2) meshes,
  for qwen2.5-3b, olmoe-1b-7b (expert-parallel, with capacity drops) and
  h2o-danube-1.8b's windowed ``long_500k`` at batch 1 (the small-batch
  rules), float32; the port's partitioned steps over the same weights
  (the bridge) hold its logits and caches to 1e-4.
* A lone position's collective records equal the whole mesh run's, at the
  first and the last position of (2, 4), for prefill, decode and a train
  step; its matmul FLOPs and K4 regions equal a count from the config, the
  cell's shape and ``spec_for``'s layouts, to the FLOP.
* The CLI: ``--mesh single --mesh-shape 2,4`` writes per-device records
  with the reference's keys; ``--mesh card`` writes the one-card cells.
  (The other families' serve partition: ``test_torch_serve_mesh_families``.)

``python tests/test_torch_mesh_dryrun.py`` prints the port's lone-position
counts of the (2, 4) smoke cells beside the reference's XLA per-device
FLOPs and wire bytes (a comparison, not a gate: XLA fuses and counts
differently).
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

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, TokenPipeline, extra_inputs
from repro_torch.kernels import flash_attention as k4
from repro_torch.launch import dryrun
from repro_torch.launch.cost import CostCounter
from repro_torch.launch.elastic import state_shardings
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LM, ModelConfig, ShapeCfg, steps
from repro_torch.models.bridge import from_reference
from repro_torch.models.moe import capacity
from repro_torch.sharding import (
    TRAIN_RULES, device_put, serve_rules, shard_ctx, spec_for,
)
from repro_torch.sharding import shard_map as sm

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4
# (config, rows, prompt tokens, max_seq): the serve cells held to the
# reference; danube's is long_500k's shape at smoke scale: one row, a ring
# of its 8-token window under a longer max_seq
CELLS = {"qwen2.5-3b": (4, 16, 24), "olmoe-1b-7b": (4, 16, 24),
         "h2o-danube-1.8b": (1, 16, 32)}
MESHES = {"single": ((2, 4), ("data", "model")),
          "multi": ((2, 2, 2), ("pod", "data", "model"))}
DECODE_STEPS = 2
# tests/test_perf_paths.py's padded-heads config: 10 heads, KV 2 → 12 on 4
PADDED = dict(name="t", family="dense", n_layers=2, d_model=40, n_heads=10,
              n_kv_heads=2, d_ff=64, vocab=64, head_dim=4,
              param_dtype="float32", dtype="float32")


def f32(arch):
    return dataclasses.replace(get_smoke_config(arch), dtype="float32")


def cpu_mesh(shape, axes=None):
    axes = axes or ("data", "model")[-len(shape):]
    return make_mesh(shape, axes, devices=["cpu"] * math.prod(shape))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------ the reference's partitioned steps

SUB = r"""
import dataclasses, os, sys
# one compute thread: the test's cost is CPU time on a loaded host
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=8 "
                           "--xla_cpu_multi_thread_eigen=false "
                           "intra_op_parallelism_threads=1")
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.models import LM
from repro.models.steps import (cache_axes, make_decode_step,
                                make_prefill_step, params_axes_and_structs)
from repro.sharding import serve_rules, shard_ctx, spec_for, tree_shardings
out = {}
def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        out[prefix] = np.asarray(tree)
opts = {"xla_backend_optimization_level": 0}
for arch, (B, S, MAX) in CELLS.items():
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda k: LM.init(k, cfg)[0]).lower(key).compile(
        compiler_options=opts)(key)
    put(arch + "/params", params)
    rng = np.random.default_rng(5)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab, (B, S), dtype=np.int32))
    feed = rng.integers(0, cfg.vocab, (DECODE_STEPS, B, 1), dtype=np.int32)
    out[arch + "/tokens"] = np.asarray(tokens)
    out[arch + "/feed"] = feed
    axes, _ = params_axes_and_structs(cfg)
    for tag, (shape, names) in MESHES.items():
        # Auto axes: jax.make_mesh builds Explicit ones, where constraints
        # raise
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), names)
        rules = serve_rules(B)
        repl = NamedSharding(mesh, P())
        p_sh = tree_shardings(axes, rules, mesh, shapes_tree=params)
        pstep = make_prefill_step(cfg, max_seq=MAX)
        def prefill(p, b):
            with shard_ctx(rules, mesh):
                return pstep(p, b)
        cache0 = jax.eval_shape(lambda p, b: pstep(p, b)[1], params,
                                {"tokens": tokens})
        c_sh = tree_shardings(cache_axes(cfg, B, MAX), rules, mesh,
                              shapes_tree=cache0)
        b_sh = {"tokens": NamedSharding(mesh, spec_for(
            ("batch", "seq"), rules, mesh, (B, S)))}
        fn = jax.jit(prefill, in_shardings=(p_sh, b_sh),
                     out_shardings=(repl, c_sh)).lower(
            params, {"tokens": tokens}).compile(compiler_options=opts)
        logits, cache = fn(jax.device_put(params, p_sh), {"tokens": tokens})
        pre = arch + "/" + tag
        out[pre + "/prefill"] = np.asarray(logits)
        put(pre + "/cache0", cache)
        dstep = make_decode_step(cfg)
        def decode(p, t, c):
            with shard_ctx(rules, mesh):
                return dstep(p, t, c)
        t_sh = NamedSharding(mesh, spec_for(("batch", "seq"), rules, mesh,
                                            (B, 1)))
        dfn = jax.jit(decode, in_shardings=(p_sh, t_sh, c_sh),
                      out_shardings=(repl, c_sh)).lower(
            params, jnp.asarray(feed[0]), cache).compile(
            compiler_options=opts)
        for i in range(DECODE_STEPS):
            logits, cache = dfn(jax.device_put(params, p_sh),
                                jnp.asarray(feed[i]), cache)
            out[pre + "/decode%d" % i] = np.asarray(logits)
        put(pre + "/cache", cache)
np.savez(sys.argv[1], **out)
"""


def _tree(path):
    z = np.load(path)
    tree: dict = {}
    for k in z.files:
        node = tree
        *head, last = k.split("/")
        for h in head:
            node = node.setdefault(h, {})
        node[last] = z[k]
    return tree


@pytest.fixture(scope="module")
def reference_serve():
    """One subprocess, started when the module's first test asks for it;
    the port-only tests run while it works."""
    tmp = tempfile.mkdtemp(prefix="mesh-dryrun-")
    path = os.path.join(tmp, "ref.npz")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    code = (f"CELLS = {CELLS!r}\nMESHES = {MESHES!r}\n"
            f"DECODE_STEPS = {DECODE_STEPS}\n" + SUB)
    proc = subprocess.Popen([sys.executable, "-c", code, path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)

    def result():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        return _tree(path)
    yield functools.lru_cache(maxsize=None)(result)
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module", autouse=True)
def start_reference(reference_serve):
    yield


# ------------------------------------------------------------------ remat


def _batch(cfg, rows=4, seq=16):
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=rows, seed=3))
    return {k: torch.from_numpy(v)
            for k, v in extra_inputs(cfg, data.batch(0)).items()}


def _saved_bytes(fn):
    """(fn(), the bytes of the tensors autograd saved for its backward)."""
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total[0]


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmoe-1b-7b",
                                  "zamba2-2.7b"])
def test_remat_gradients_bitwise_one_device(arch):
    """remat "full" against "none" on one device: the loss and every
    gradient bitwise equal; fewer bytes saved for the backward (each layer
    or group keeps its input alone)."""
    base = get_smoke_config(arch)
    batch = _batch(base)
    got = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        model = LM(cfg, device="cpu", seed=0)
        got[remat] = _saved_bytes(lambda: steps.loss_and_grads(model, batch))
    ((l0, _), g0), saved0 = got["none"]
    ((l1, _), g1), saved1 = got["full"]
    assert torch.equal(l0, l1)
    assert g0.keys() == g1.keys()
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k
    assert saved1 < saved0 / 2, (saved1, saved0)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "olmoe-1b-7b",
                                  "zamba2-2.7b"])
def test_remat_state_bitwise_on_a_mesh(arch):
    """One train step on (2, 4), remat "full" against "none": the loss,
    grad_norm, the updated parameters and AdamW's first moment (the
    clipped gradient × (1 - b1)) bitwise equal; the recompute's
    all-gathers recorded again, its reduce-scatters not."""
    base = get_smoke_config(arch)
    batch = _batch(base, seq=8)
    mesh = cpu_mesh((2, 4))
    out = {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        step, (opt_init, _) = steps.make_train_step(cfg)
        state = steps.init_train_state(0, cfg, opt_init, device="cpu")
        state = device_put(state, state_shardings(cfg, mesh)[0])
        with shard_ctx(TRAIN_RULES, mesh), CostCounter() as c:
            state, m = step(state, batch)
        kinds = collections.Counter(k for k, _, _ in c.collectives)
        out[remat] = (m, {k: a.full() for k, a in state.params.items()},
                      {k: a.full() for k, a in state.opt_state.mu.items()},
                      kinds)
    (m0, p0, mu0, k0), (m1, p1, mu1, k1) = out["none"], out["full"]
    for k in ("loss", "grad_norm"):
        assert torch.equal(m0[k], m1[k]), k
    for k in p0:
        assert torch.equal(p0[k], p1[k]) and torch.equal(mu0[k], mu1[k]), k
    assert k1["all-gather"] > k0["all-gather"]
    assert k1["reduce-scatter"] == k0["reduce-scatter"]


# ---------------------------------------------------------- lone positions


def _lone(tree, lone):
    return {k: sm.ShardedArray({lone.position: a.blocks[lone.position].clone()},
                               a.spec, lone, a.shape, a.dtype)
            for k, a in tree.items()}


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_lone_position_records_the_full_runs_collectives(kind):
    """The first and the last position of (2, 4) alone record the whole
    mesh run's collectives, in order, and a mesh-size-th of its kernel
    regions."""
    cfg = f32("olmoe-1b-7b") if kind == "decode" else f32("qwen2.5-3b")
    mesh = cpu_mesh((2, 4))
    B, S, MAX = 4, 16, 24
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (B, S), dtype=np.int32))
    if kind == "train":
        rules = TRAIN_RULES
        step, (opt_init, _) = steps.make_train_step(cfg)
        state = device_put(steps.init_train_state(0, cfg, opt_init,
                                                  device="cpu"),
                           state_shardings(cfg, mesh)[0])
        batch = {"tokens": tokens, "labels": tokens}

        def args(m):
            if not sm.is_lone(m):
                return (state, batch)
            return (steps.TrainState(_lone(state.params, m), steps.AdamWState(
                0, _lone(state.opt_state.mu, m),
                _lone(state.opt_state.nu, m)), 0), batch)
    else:
        rules = serve_rules(B)
        model = LM(cfg, device="cpu", seed=0)
        params = device_put(model, steps.serve_shardings(cfg, mesh, rules))
        pre = steps.make_prefill_step(cfg, MAX)
        with shard_ctx(rules, mesh):
            _, cache = pre(params, {"tokens": tokens})
        tok = tokens[:, :1]
        if kind == "prefill":
            step = pre
            args = lambda m: ((params if not sm.is_lone(m) else
                               _lone(params, m)), {"tokens": tokens})
        else:
            step = steps.make_decode_step(cfg)
            args = lambda m: (
                params if not sm.is_lone(m) else _lone(params, m), tok,
                {**cache, "layers": (cache["layers"] if not sm.is_lone(m)
                                     else _lone(cache["layers"], m))})
    with shard_ctx(rules, mesh), CostCounter() as full:
        step(*args(mesh))
    for pos in (sm.positions(mesh)[0], sm.positions(mesh)[-1]):
        lone = sm.LoneMesh(mesh, pos)
        with shard_ctx(rules, lone), CostCounter() as c:
            step(*args(lone))
        assert c.collectives == full.collectives, pos
        for name, k in full.kernels.items():
            assert c.kernels[name] == {f: v // mesh.size
                                       for f, v in k.items()}, pos


MATMULS = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm")


def _matmul_flops(counter):
    return sum(counter.by_op[op][1] for op in MATMULS if op in counter.by_op)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("name", ["qwen2.5-3b", "padded", "olmoe-1b-7b"])
def test_lone_matmul_flops_and_k4_regions_from_the_config(name, kind):
    """A lone position of (2, 4): its matmul FLOPs equal the count the
    config, the cell and ``spec_for``'s layouts give, to the FLOP — each
    rank's q heads (padded where they do not divide), its KV heads or every
    KV head, its ``wo`` rows, its MLP columns or its experts' slabs at one
    data shard's capacity, split-K's two products over its sequence block,
    and its vocabulary range of the readout — and its K4 regions one a
    layer at its heads' shapes."""
    cfg = ModelConfig(**PADDED) if name == "padded" else f32(name)
    mesh = cpu_mesh((2, 4))
    shape = ShapeCfg(f"{kind}_32k", 24, 4, kind)
    lone = sm.LoneMesh(mesh, (1, 3))
    with CostCounter() as c:
        state, step, args, rules = dryrun.build_lone_cell(cfg, shape, lone)
        with shard_ctx(rules, lone):
            step(*args)
    B, S = shape.global_batch, shape.seq_len
    d, hd, H, KV, L = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads, \
        cfg.n_layers
    m = 4
    rows = B // sm.axis_size(lone, spec_for(("batch", "seq"), rules, lone,
                                            (B, 1))[0] or ())
    Hp = H
    while Hp % m or Hp % KV:
        Hp += KV
    n = Hp // m                                   # q heads a rank
    kv_cols = KV * hd // m if KV % m == 0 else KV * hd
    T = S if kind == "prefill" else 1             # tokens a row
    layer = 2 * rows * T * d * (n * hd + 2 * kv_cols) + 2 * rows * T * n * hd * d
    if cfg.moe is not None:
        mc = cfg.moe
        C = capacity(rows * T, mc)
        layer += 2 * rows * T * d * mc.n_experts  # the router
        layer += 3 * 2 * (mc.n_experts // m) * C * d * mc.d_ff_expert
    else:
        layer += 3 * 2 * rows * T * d * (cfg.d_ff // m)
    if kind == "decode":                          # split-K over S / m slots
        layer += 2 * 2 * rows * H * (S // m) * hd
    readout = 2 * rows * 1 * d * (cfg.vocab // m)
    assert _matmul_flops(c) == L * layer + readout
    if kind == "prefill":
        # each rank attends with its n heads over the KV heads they read:
        # its own KV heads where they split, else whole groups or one KV
        # head (Gc q heads read one), else one a q head
        Gc = Hp // KV
        kv_read = (KV // m if KV % m == 0 else max(n // Gc, 1)
                   if n % Gc == 0 or Gc % n == 0 else n)
        want = k4.cost(rows, S, S, n, kv_read, hd, causal=True,
                       window=cfg.sliding_window, itemsize=4)
        assert c.kernels["flash_attention"] == {
            "calls": L, "flops": L * want.flops, "bytes": L * want.bytes,
            "transcendentals": L * want.transcendentals}
    else:
        assert "flash_attention" not in c.kernels


# ------------------------------------------------------------------ the CLI


def test_cli_writes_per_device_mesh_records(tmp_path, capsys):
    assert dryrun.main(["--smoke", "--mesh", "single", "--mesh-shape", "2,4",
                        "--device", "cpu", "--arch", "qwen2.5-3b",
                        "--shape", "decode_32k,prefill_32k,train_4k",
                        "--reps", "1", "--out", str(tmp_path)]) == 0
    for name in ("decode_32k", "prefill_32k", "train_4k"):
        rec = json.loads(dryrun.cell_path(tmp_path, "qwen2.5-3b", name,
                                          "single").read_text())
        for key in ("arch", "shape", "mesh", "chips", "cost", "memory",
                    "collective_bytes", "collective_detail", "device",
                    "step_s", "launches", "kernel_regions",
                    "scan_flops_counted", "lone_position",
                    "step_s_excludes_wire"):
            assert key in rec, key
        assert (rec["mesh"], rec["chips"], rec["lone_position"]) == (
            [2, 4], 8, [0, 0])
        assert rec["collective_bytes"] > 0 and rec["step_s_excludes_wire"]
        assert set(rec["cost"]) == {"flops", "bytes", "transcendentals"}
    assert "refused:" not in capsys.readouterr().out


def test_cli_card_cells_are_the_one_card_share(tmp_path):
    """``--mesh card`` writes what ``analyze_cell`` counts for one card's
    share, under ``…__card.json``."""
    assert dryrun.main(["--smoke", "--mesh", "card", "--device", "cpu",
                        "--arch", "h2o-danube-1.8b", "--shape",
                        "decode_32k,prefill_32k", "--reps", "1", "--out",
                        str(tmp_path)]) == 0
    cfg = dryrun.smoke_config("h2o-danube-1.8b")
    for name in ("decode_32k", "prefill_32k"):
        rec = json.loads(dryrun.cell_path(tmp_path, cfg.name, name,
                                          "card").read_text())
        want = dryrun.analyze_cell(cfg, dryrun.smoke_shape(
            dryrun.SHAPES[name]), "cpu", reps=1)
        assert (rec["mesh"], rec["chips"]) == ([1, 1], 1)
        for key in ("cost", "collective_bytes", "replica_batch",
                    "kernel_regions", "launches"):
            assert rec[key] == want[key], key


# ------------------- the serve partition, the reference (last: its subprocess
# works while the tests above run)


def _port_serve(arch, tag, ref):
    """The port's partitioned prefill and decode on ``tag``'s mesh over the
    reference's weights, fed its tokens → (prefill logits, [decode
    logits], the prefill's cache, the last cache)."""
    cfg = f32(arch)
    B, S, MAX = CELLS[arch]
    model = from_reference(ref[arch]["params"], cfg, device="cpu")
    shape, names = MESHES[tag]
    mesh = cpu_mesh(shape, names)
    rules = serve_rules(B)
    params = device_put(model, steps.serve_shardings(cfg, mesh, rules))
    tokens = torch.from_numpy(ref[arch]["tokens"])
    with shard_ctx(rules, mesh):
        logits, cache = steps.make_prefill_step(cfg, MAX)(
            params, {"tokens": tokens})
        first = {n: a.full() for n, a in cache["layers"].items()}
        dec = []
        for t in ref[arch]["feed"]:
            d, cache = steps.make_decode_step(cfg)(
                params, torch.from_numpy(t), cache)
            dec.append(d)
    return logits, dec, first, cache


@pytest.mark.parametrize("tag", list(MESHES))
@pytest.mark.parametrize("arch", list(CELLS))
def test_partitioned_serve_matches_the_reference(reference_serve, arch,
                                                 tag):
    ref = reference_serve()
    logits, dec, first, cache = _port_serve(arch, tag, ref)
    got = ref[arch][tag]
    np.testing.assert_allclose(logits.numpy(), got["prefill"], rtol=0,
                               atol=TOL)
    for i, d in enumerate(dec):
        np.testing.assert_allclose(d.numpy(), got[f"decode{i}"], rtol=0,
                                   atol=TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(first[n].numpy(),
                                   got["cache0"]["layers"][n], rtol=0,
                                   atol=TOL)
        np.testing.assert_allclose(cache["layers"][n].full().numpy(),
                                   got["cache"]["layers"][n], rtol=0,
                                   atol=TOL)
    assert int(cache["index"]) == int(got["cache"]["index"])
    kv_spec = steps.cache_specs(
        f32(arch), steps.cache_structs(f32(arch), CELLS[arch][0],
                                       CELLS[arch][2]),
        serve_rules(CELLS[arch][0]), cpu_mesh(*MESHES[tag]))["layers"]["k"]
    assert cache["layers"]["k"].spec == kv_spec


# -------------------------------------------- the reference's XLA, printed

CMP = r"""
import dataclasses, os, sys, json
os.environ["DRYRUN_DEVICES"] = "8"
import jax, numpy as np
from jax.sharding import Mesh
import repro.launch.dryrun as rd
from repro.configs import get_smoke_config
from repro.models import ShapeCfg
for name, (seq, batch, kind) in CELLS.items():
    rd.SHAPES[name] = ShapeCfg(name, seq, batch, kind)
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
# unrolled: XLA counts a lax.scan body once, the port every layer
cfg = dataclasses.replace(get_smoke_config(ARCH), dtype="float32",
                          use_scan=False)
out = {}
for name in CELLS:
    rec = rd.analyze_cell(cfg, name, mesh)
    out[name] = (rec["cost"]["flops"], rec["collective_bytes"])
print(json.dumps(out))
"""


def compare_with_xla(arch="qwen2.5-3b"):
    """The port's lone-position FLOPs and wire bytes of the (2, 4) smoke
    cells beside the reference's XLA per-device counts of the same cells,
    its layers unrolled (``use_scan=False``)."""
    cells = {"decode_32k": (24, 8, "decode"), "prefill_32k": (24, 4,
                                                             "prefill"),
             "train_4k": (16, 8, "train")}
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, "-c", f"CELLS = {cells!r}\n"
                           f"ARCH = {arch!r}\n" + CMP], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    xla = json.loads(proc.stdout.strip().splitlines()[-1])
    cfg = dataclasses.replace(f32(arch), name=arch)
    for name, (seq, batch, kind) in cells.items():
        rec = dryrun.analyze_mesh_cell(cfg, ShapeCfg(name, seq, batch, kind),
                                       cpu_mesh((2, 4)), "cpu", reps=1)
        print(f"{arch} smoke {name} ({batch} x {seq}) on (2, 4), a device: "
              f"port {rec['cost']['flops']:.0f} FLOPs, "
              f"{rec['collective_bytes']:.0f} wire bytes; reference XLA "
              f"{xla[name][0]:.0f} FLOPs, {xla[name][1]:.0f} wire bytes")


if __name__ == "__main__":
    compare_with_xla()
