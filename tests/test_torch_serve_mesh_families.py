"""The serve steps partitioned over a mesh for the families beyond the
dense and MoE ones — Mamba1 (falcon-mamba-7b), the zamba2 hybrid (Mamba2
towers and shared attention), the VLM (qwen2-vl-7b: M-RoPE over a patch
prefix) and the encoder-decoder (seamless-m4t-medium: cross attention) —
on the CPU, at smoke configs in float32, against the reference.

* One subprocess with 8 host devices (started with the module, so that
  the port-only tests run while it works) runs the reference's jitted
  prefill and 2 decode steps under ``shard_ctx(serve_rules(B), mesh)``
  with the dry-run's shardings (the logits replicated, the cache laid out
  by ``cache_axes``) on Auto-typed (2, 4) and (2, 2, 2) meshes: every
  family at 4 rows, falcon-mamba-7b and zamba2-2.7b at 1 row too (the
  small-batch rules), and a qwen2-vl variant with 6 heads over 2 KV
  heads, whose heads pad on (2, 4).  Patches and frames come from numpy
  at a fixed seed; the encoder's 12 frames differ from the cache's 24
  slots, so the cross K/V come back at the encoder's length.  The port's
  partitioned steps over the same weights (the bridge) hold the logits
  and every cache leaf (``h``, ``conv``, self, attention and cross K/V,
  ``cross_len``, ``index``) to 1e-4, each leaf laid out by ``spec_for``
  of its ``cache_axes``.
* The first and the last position of (2, 4) alone (``LoneMesh``) record
  the whole mesh run's collectives for zamba2's and seamless's prefill
  and decode, and an eighth of its kernel regions: K7 once a Mamba2
  layer and K4 once a shared-block application on each position.
* The fused ``in_proj`` moves the fewer bytes: a decode all-gathers each
  rank's product, a long prompt the weight.
* The CLI: ``--smoke --mesh single --mesh-shape 2,4`` writes every serve
  record of the four families, and ``--mesh both`` refuses none.
* Every cache layout ``SERVE_RULES`` gives a decode, on (2, 4): a ring
  split over "model" with each row at its own position (a (B,) index,
  one row's ring wrapped), a 30-slot ring that 4 does not divide (the KV
  heads split over "model" where 4 divides them, else nothing does) and
  the paged pool (a block table, half its ids global ones that
  ``rem(block_tbl, NB)`` folds).  The same subprocess runs the
  reference's jitted ``make_decode_step`` under ``shard_ctx(SERVE_RULES,
  mesh)`` on qwen2.5-3b's and seamless-m4t-medium's smoke configs from its
  one-device prefill; the port's step, given the ``LM`` under the same
  context, holds every logit and cache leaf to 1e-4 and the index, the
  table and ``cross_len`` exactly.  zamba2-2.7b (its shared attention),
  qwen2-vl-7b (M-RoPE at each row's position) and olmoe-1b-7b take the
  three layouts beside the port's one-device decode.
"""
import dataclasses
import functools
import inspect
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
from repro_torch.launch import dryrun
from repro_torch.launch.cost import CostCounter
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LM, steps
from repro_torch.models.bridge import from_reference
from repro_torch.sharding import (
    SERVE_RULES, device_put, serve_rules, shard_ctx, spec_for,
)
from repro_torch.sharding import shard_map as sm

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-4
ROWS, PROMPT, MAX_SEQ, FRAMES = 4, 16, 24, 12
DECODE_STEPS = 2
# name: (arch, config overrides, rows, the meshes it runs on)
CASES = {
    "falcon-mamba-7b": ("falcon-mamba-7b", {}, ROWS, ("single", "multi")),
    "falcon-mamba-7b-b1": ("falcon-mamba-7b", {}, 1, ("single", "multi")),
    "zamba2-2.7b": ("zamba2-2.7b", {}, ROWS, ("single", "multi")),
    "zamba2-2.7b-b1": ("zamba2-2.7b", {}, 1, ("single", "multi")),
    "qwen2-vl-7b": ("qwen2-vl-7b", {}, ROWS, ("single", "multi")),
    # 6 heads over 2 KV heads: padded to 8 on a model axis of 4
    "qwen2-vl-7b-padded": ("qwen2-vl-7b", dict(n_heads=6, n_kv_heads=2,
                                               head_dim=8), ROWS,
                           ("single",)),
    "seamless-m4t-medium": ("seamless-m4t-medium", {}, ROWS,
                            ("single", "multi")),
}
MESHES = {"single": ((2, 4), ("data", "model")),
          "multi": ((2, 2, 2), ("pod", "data", "model"))}
FAMILIES = ("falcon-mamba-7b", "zamba2-2.7b", "qwen2-vl-7b",
            "seamless-m4t-medium")
# the decode layouts: (ring length, paged); each row at its own position,
# row 2's ring wrapped
LAYOUTS = {"vector": (24, False), "odd": (30, False), "paged": (24, True)}
INDICES = (16, 23, 30, 9)
BLOCK = 8
LAYOUT_ARCHS = ("qwen2.5-3b", "seamless-m4t-medium")


def to_layout(cache, layout, seed=11):
    """A one-device prefill's cache (numpy leaves) in ``layout``: the
    (B,) index INDICES; paged, the self-attention K/V re-laid as a pool of
    B x nk + 1 blocks of BLOCK slots in a shuffled order, the (B, nk)
    table naming them, every other row's ids offset by NB (global ids,
    folded by ``rem``)."""
    import numpy as np
    out = dict(cache)
    name = ("self" if "self" in cache else "attn" if "attn" in cache
            else "layers")
    L, B, S = np.asarray(cache[name]["k"]).shape[:3]
    out["index"] = np.asarray(INDICES[:B], np.int32)
    if not LAYOUTS[layout][1]:
        return out
    nk = S // BLOCK
    NB = B * nk + 1
    ids = np.random.default_rng(seed).permutation(NB)[:B * nk]
    pool = {}
    for n, leaf in cache[name].items():
        leaf = np.asarray(leaf)
        p = np.zeros((L, NB, BLOCK) + leaf.shape[3:], leaf.dtype)
        p[:, ids] = leaf.reshape((L, B * nk, BLOCK) + leaf.shape[3:])
        pool[n] = p
    tbl = ids.reshape(B, nk).astype(np.int32)
    tbl[::2] += NB
    out[name] = pool
    out["block_tbl"] = tbl
    return out


def config(name):
    arch, kw, _, _ = CASES[name]
    return dataclasses.replace(get_smoke_config(arch, **kw), dtype="float32")


def cpu_mesh(tag):
    shape, axes = MESHES[tag]
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
from repro.models.steps import (cache_axes, input_sharding_axes,
                                make_decode_step, make_prefill_step,
                                params_axes_and_structs)
from repro.sharding import (SERVE_RULES, serve_rules, shard_ctx, spec_for,
                            tree_shardings)
out = {}
def put(prefix, tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            put(prefix + "/" + k, v)
    else:
        out[prefix] = np.asarray(tree)
opts = {"xla_backend_optimization_level": 0}
for name, (arch, kw, B, tags) in CASES.items():
    cfg = dataclasses.replace(get_smoke_config(arch, **kw), dtype="float32")
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda k: LM.init(k, cfg)[0]).lower(key).compile(
        compiler_options=opts)(key)
    put(name + "/params", params)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, PROMPT),
                                    dtype=np.int32)}
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.n_vision_patches, cfg.d_model)).astype(np.float32)
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    feed = rng.integers(0, cfg.vocab, (DECODE_STEPS, B, 1), dtype=np.int32)
    put(name + "/batch", batch)
    out[name + "/feed"] = feed
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    axes, _ = params_axes_and_structs(cfg)
    in_axes = input_sharding_axes(cfg, with_labels=False)
    for tag in tags:
        shape, names = MESHES[tag]
        # Auto axes: jax.make_mesh builds Explicit ones, where constraints
        # raise
        mesh = Mesh(np.array(jax.devices()[:8]).reshape(shape), names)
        rules = serve_rules(B)
        repl = NamedSharding(mesh, P())
        p_sh = tree_shardings(axes, rules, mesh, shapes_tree=params)
        pstep = make_prefill_step(cfg, max_seq=MAX_SEQ)
        def prefill(p, b):
            with shard_ctx(rules, mesh):
                return pstep(p, b)
        cache0 = jax.eval_shape(lambda p, b: pstep(p, b)[1], params, batch)
        c_sh = tree_shardings(cache_axes(cfg, B, MAX_SEQ), rules, mesh,
                              shapes_tree=cache0)
        b_sh = {k: NamedSharding(mesh, spec_for(in_axes[k], rules, mesh,
                                                v.shape))
                for k, v in batch.items()}
        fn = jax.jit(prefill, in_shardings=(p_sh, b_sh),
                     out_shardings=(repl, c_sh)).lower(
            params, batch).compile(compiler_options=opts)
        logits, cache = fn(jax.device_put(params, p_sh), batch)
        pre = name + "/" + tag
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
# every decode layout of SERVE_RULES on (2, 4), from a one-device prefill
mesh = Mesh(np.array(jax.devices()[:8]).reshape(MESHES["single"][0]),
            MESHES["single"][1])
repl = NamedSharding(mesh, P())
for arch in LAYOUT_ARCHS:
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    key = jax.random.PRNGKey(0)
    params = jax.jit(lambda k: LM.init(k, cfg)[0]).lower(key).compile(
        compiler_options=opts)(key)
    pre = "layouts/" + arch
    put(pre + "/params", params)
    rng = np.random.default_rng(9)
    B = CASES_ROWS
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, PROMPT),
                                    dtype=np.int32)}
    if cfg.enc_dec:
        batch["frames"] = rng.standard_normal(
            (B, FRAMES, cfg.d_model)).astype(np.float32)
    feed = rng.integers(0, cfg.vocab, (DECODE_STEPS, B, 1), dtype=np.int32)
    out[pre + "/feed"] = feed
    batch = {k: jnp.asarray(v) for k, v in batch.items()}
    axes, _ = params_axes_and_structs(cfg)
    p_sh = tree_shardings(axes, SERVE_RULES, mesh, shapes_tree=params)
    t_sh = NamedSharding(mesh, spec_for(("batch", "seq"), SERVE_RULES, mesh,
                                        (B, 1)))
    dstep = make_decode_step(cfg)
    def decode(p, t, c):
        with shard_ctx(SERVE_RULES, mesh):
            return dstep(p, t, c)
    prefilled = {}
    for layout, (max_seq, paged) in LAYOUTS.items():
        if max_seq not in prefilled:
            pstep = make_prefill_step(cfg, max_seq=max_seq)
            prefilled[max_seq] = jax.jit(pstep).lower(params, batch).compile(
                compiler_options=opts)(params, batch)[1]
        cache = to_layout(jax.tree.map(np.asarray, prefilled[max_seq]),
                          layout)
        put(pre + "/" + layout + "/cache0", cache)
        ax = dict(cache_axes(cfg, B, max_seq), index=("batch",))
        if paged:
            name = "self" if cfg.enc_dec else "layers"
            ax[name] = {n: ("layers", "cache_blocks", None, "kv_heads", None)
                        for n in ax[name]}
            ax["block_tbl"] = ("batch", None)
        c_sh = tree_shardings(ax, SERVE_RULES, mesh, shapes_tree=cache)
        cache = jax.device_put(cache, c_sh)
        dfn = jax.jit(decode, in_shardings=(p_sh, t_sh, c_sh),
                      out_shardings=(repl, c_sh)).lower(
            params, jnp.asarray(feed[0]), cache).compile(
            compiler_options=opts)
        for i in range(DECODE_STEPS):
            logits, cache = dfn(jax.device_put(params, p_sh),
                                jnp.asarray(feed[i]), cache)
            out[pre + "/" + layout + "/decode%d" % i] = np.asarray(logits)
        put(pre + "/" + layout + "/cache", cache)
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
    """One subprocess, started with the module; its result is read by the
    tests at the end of the file."""
    tmp = tempfile.mkdtemp(prefix="serve-mesh-families-")
    path = os.path.join(tmp, "ref.npz")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    code = (f"CASES = {CASES!r}\nMESHES = {MESHES!r}\n"
            f"PROMPT, MAX_SEQ, FRAMES = {PROMPT}, {MAX_SEQ}, {FRAMES}\n"
            f"DECODE_STEPS = {DECODE_STEPS}\nLAYOUTS = {LAYOUTS!r}\n"
            f"INDICES, BLOCK = {INDICES!r}, {BLOCK}\n"
            f"LAYOUT_ARCHS, CASES_ROWS = {LAYOUT_ARCHS!r}, {ROWS}\n"
            + inspect.getsource(to_layout) + SUB)
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


# ------------------------------------------------------------ helpers


def whole(leaf):
    """A copy of the whole leaf (a replicated leaf's ``full()`` is its
    block, which a decode writes in place)."""
    return np.array(leaf.full() if isinstance(leaf, sm.ShardedArray)
                    else torch.as_tensor(leaf))


def inputs(cfg, rows, seed=1):
    rng = np.random.default_rng(seed)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (rows, PROMPT), dtype=np.int32))}
    if cfg.family == "vlm":
        batch["patches"] = torch.from_numpy(rng.standard_normal(
            (rows, cfg.n_vision_patches, cfg.d_model)).astype(np.float32))
    if cfg.enc_dec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (rows, FRAMES, cfg.d_model)).astype(np.float32))
    return batch


def laid_out(cfg, mesh, rules, model=None):
    model = LM(cfg, device="cpu", seed=0) if model is None else model
    return device_put(model, steps.serve_shardings(cfg, mesh, rules))


# ---------------------------------------------------------- lone positions


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "seamless-m4t-medium"])
def test_lone_position_records_the_full_runs_collectives(arch, kind):
    """The first and the last position of (2, 4) alone record the whole
    mesh run's collectives, in order, and an eighth of its kernel
    regions; a prefill runs K7 once a Mamba2 layer and K4 once a
    shared-block application (zamba2) or decoder layer (seamless) on each
    position, a decode no kernel."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    mesh = cpu_mesh("single")
    rules = serve_rules(ROWS)
    params = laid_out(cfg, mesh, rules)
    batch = inputs(cfg, ROWS)
    pre = steps.make_prefill_step(cfg, MAX_SEQ)
    with shard_ctx(rules, mesh):
        _, cache = pre(params, batch)
    if kind == "prefill":
        step = pre
        args = lambda m: (params if not sm.is_lone(m)
                          else sm.lone_tree(params, m, clone=True), batch)
    else:
        step = steps.make_decode_step(cfg)
        tok = batch["tokens"][:, :1]
        args = lambda m: ((params, tok, sm.clone_tree(cache))
                          if not sm.is_lone(m) else
                          (sm.lone_tree(params, m, clone=True), tok,
                           sm.lone_tree(cache, m, clone=True)))
    with shard_ctx(rules, mesh), CostCounter() as full:
        step(*args(mesh))
    if kind == "decode":
        assert not full.kernels
    elif cfg.hybrid is not None:
        groups = cfg.n_layers // cfg.hybrid.attn_every
        assert full.kernels["ssm_scan"]["calls"] == cfg.n_layers * mesh.size
        assert full.kernels["flash_attention"]["calls"] == groups * mesh.size
    else:
        assert full.kernels["flash_attention"]["calls"] == (
            cfg.n_layers * mesh.size)
    for pos in (sm.positions(mesh)[0], sm.positions(mesh)[-1]):
        lone = sm.LoneMesh(mesh, pos)
        with shard_ctx(rules, lone), CostCounter() as c:
            step(*args(lone))
        assert c.collectives == full.collectives, pos
        for name, k in full.kernels.items():
            assert c.kernels[name] == {f: v // mesh.size
                                       for f, v in k.items()}, pos


def _gathers(counter, mesh):
    """The all-gathers over "model" a run recorded: their result bytes."""
    m = sm.axis_size(mesh, "model")
    return sorted({b for kind, b, n in counter.collectives
                   if kind == "all-gather" and n == m})


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "zamba2-2.7b"])
def test_in_proj_moves_the_fewer_bytes(arch):
    """On (2, 4) a decode step all-gathers each rank's product with the
    ``in_proj`` columns it holds (rows x width), never the weight (d x
    width); a prompt of at least d_model tokens a batch shard gathers the
    weight."""
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    mesh = cpu_mesh("single")
    rules = serve_rules(ROWS)
    params = laid_out(cfg, mesh, rules)
    d = cfg.d_model
    width = (2 * cfg.d_inner if cfg.ssm.version == 1 else
             2 * cfg.d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
             + cfg.ssm_heads)
    rows = ROWS // 2                    # a batch shard's rows on (2, 4)
    weight, product = d * width * 4, rows * width * 4
    batch = {"tokens": torch.zeros((ROWS, 2 * d), dtype=torch.int32)}
    with shard_ctx(rules, mesh), CostCounter() as pre:
        _, cache = steps.make_prefill_step(cfg, 4 * d)(params, batch)
    with shard_ctx(rules, mesh), CostCounter() as dec:
        steps.make_decode_step(cfg)(params, batch["tokens"][:, :1], cache)
    assert weight in _gathers(pre, mesh)
    assert product in _gathers(dec, mesh)
    assert weight not in _gathers(dec, mesh)


# ------------------------------------------------------------------ the CLI


def test_cli_writes_every_serve_record_of_the_four_families(tmp_path,
                                                            capsys):
    assert dryrun.main(["--smoke", "--mesh", "single", "--mesh-shape", "2,4",
                        "--device", "cpu", "--arch", ",".join(FAMILIES),
                        "--shape", "decode_32k,prefill_32k,long_500k",
                        "--reps", "1", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "refused:" not in out and "FAILED" not in out
    for arch in FAMILIES:
        cfg = dryrun.smoke_config(arch)
        for name in ("decode_32k", "prefill_32k", "long_500k"):
            path = dryrun.cell_path(tmp_path, arch, name, "single")
            if name not in dryrun.applicable_shapes(cfg):
                assert not path.exists()
                continue
            rec = json.loads(path.read_text())
            assert (rec["mesh"], rec["chips"], rec["lone_position"]) == (
                [2, 4], 8, [0, 0])
            assert rec["collective_bytes"] > 0 and rec["step_s_excludes_wire"]
            want = ({} if dryrun.SHAPES[name].kind == "decode" else
                    {"flash_attention": cfg.n_layers} if cfg.ssm is None else
                    {"ssm_scan": cfg.n_layers,
                     "flash_attention": cfg.n_layers
                     // cfg.hybrid.attn_every} if cfg.hybrid else {})
            assert {k: v["calls"] for k, v in
                    rec["kernel_regions"].items()} == want, (arch, name)


def test_cli_refuses_no_serve_cell_on_both_meshes(tmp_path, capsys):
    """``--mesh both`` (``--mesh-shape`` the single mesh, (2, 16, 16) the
    multi one) counts the four families' serve cells; only ``train_4k``
    on ``card`` and ``--probe`` stay refused."""
    assert dryrun.main(["--smoke", "--mesh", "both", "--mesh-shape", "2,4",
                        "--device", "cpu", "--arch", ",".join(FAMILIES),
                        "--shape", "decode_32k", "--reps", "1", "--out",
                        str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "refused:" not in out and "done: ok=8 fail=0" in out
    assert dryrun.refused("train_4k", "card") is not None
    assert all(dryrun.refused(n, t) is None for n in dryrun.SHAPES
               for t in ("single", "multi"))


# ------------------- the serve partition, the reference (last: its subprocess
# works while the tests above run)


def _port_serve(name, tag, ref):
    """The port's partitioned prefill and decode on ``tag``'s mesh over the
    reference's weights, fed its inputs → (prefill logits, [decode
    logits], the prefill's cache leaves gathered, the last cache)."""
    cfg = config(name)
    rows = CASES[name][2]
    model = from_reference(ref[name]["params"], cfg, device="cpu")
    mesh = cpu_mesh(tag)
    rules = serve_rules(rows)
    params = laid_out(cfg, mesh, rules, model)
    batch = {k: torch.from_numpy(v) for k, v in ref[name]["batch"].items()}
    with shard_ctx(rules, mesh):
        logits, cache = steps.make_prefill_step(cfg, MAX_SEQ)(params, batch)
        first = {k: whole(v) for k, v in sm.tree_leaves(cache).items()}
        dec = []
        for t in ref[name]["feed"]:
            d, cache = steps.make_decode_step(cfg)(
                params, torch.from_numpy(t), cache)
            dec.append(d)
    return logits, dec, first, cache


@pytest.mark.parametrize("name,tag", [(n, t) for n, c in CASES.items()
                                      for t in c[3]])
def test_partitioned_serve_matches_the_reference(reference_serve, name, tag):
    ref = reference_serve()
    logits, dec, first, cache = _port_serve(name, tag, ref)
    got = ref[name][tag]
    np.testing.assert_allclose(logits.numpy(), got["prefill"], rtol=0,
                               atol=TOL)
    for i, d in enumerate(dec):
        np.testing.assert_allclose(d.numpy(), got[f"decode{i}"], rtol=0,
                                   atol=TOL, err_msg=f"decode {i}")
    want0, want = sm.tree_leaves(got["cache0"]), sm.tree_leaves(got["cache"])
    assert first.keys() == want0.keys() == sm.tree_leaves(cache).keys()
    for k, v in first.items():
        np.testing.assert_allclose(v, want0[k], rtol=0, atol=TOL,
                                   err_msg=f"prefill {k}")
    cfg, rows = config(name), CASES[name][2]
    axes = sm.tree_leaves(steps.cache_axes(cfg, rows, MAX_SEQ))
    mesh = cpu_mesh(tag)
    for k, leaf in sm.tree_leaves(cache).items():
        np.testing.assert_allclose(whole(leaf), want[k], rtol=0, atol=TOL,
                                   err_msg=k)
        if k != "index":
            assert leaf.spec == spec_for(axes[k], serve_rules(rows), mesh,
                                         tuple(leaf.shape)), k


# ------------- every decode layout of SERVE_RULES (the reference's, then the
# port's one device)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return tree.numpy()


def _held(got, want, mesh, cfg, exact=("index", "block_tbl", "cross_len")):
    """Every leaf of cache ``got`` within TOL of ``want``'s (integer
    state equal), each K/V and state leaf laid out by ``cache_specs``."""
    g, w = sm.tree_leaves(got), sm.tree_leaves(want)
    assert g.keys() == w.keys()
    specs = sm.tree_leaves(steps.cache_specs(cfg, got, SERVE_RULES, mesh))
    for k, leaf in g.items():
        if k.split("/")[0] in exact:
            assert np.array_equal(whole(leaf), np.asarray(w[k])), k
            continue
        np.testing.assert_allclose(whole(leaf), np.asarray(w[k]), rtol=0,
                                   atol=TOL, err_msg=k)
        assert leaf.spec == specs[k], k


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", LAYOUT_ARCHS)
def test_every_decode_layout_matches_the_reference(reference_serve, arch,
                                                   layout):
    ref = reference_serve()["layouts"][arch]
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = from_reference(ref["params"], cfg, device="cpu")
    mesh = cpu_mesh("single")
    cache = _torch(ref[layout]["cache0"])
    step = steps.make_decode_step(cfg)
    with shard_ctx(SERVE_RULES, mesh):
        for i, t in enumerate(ref["feed"]):
            logits, cache = step(model, torch.from_numpy(t), cache)
            np.testing.assert_allclose(logits.numpy(),
                                       ref[layout][f"decode{i}"], rtol=0,
                                       atol=TOL, err_msg=f"decode {i}")
    _held(cache, ref[layout]["cache"], mesh, cfg)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "qwen2-vl-7b",
                                  "olmoe-1b-7b"])
def test_every_decode_layout_matches_one_device(arch, layout):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = LM(cfg, device="cpu", seed=0)
    batch = inputs(cfg, ROWS, seed=3)
    _, cache = steps.make_prefill_step(cfg, LAYOUTS[layout][0])(model, batch)
    cache = to_layout(_numpy(cache), layout)
    one, mesh_cache = _torch(cache), _torch(cache)
    mesh = cpu_mesh("single")
    step = steps.make_decode_step(cfg)
    feed = np.random.default_rng(4).integers(0, cfg.vocab, (DECODE_STEPS,
                                                            ROWS, 1))
    for t in feed:
        t = torch.from_numpy(t.astype(np.int32))
        want, one = step(model, t, one)
        with shard_ctx(SERVE_RULES, mesh):
            got, mesh_cache = step(model, t, mesh_cache)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=TOL)
    _held(mesh_cache, one, mesh, cfg)
