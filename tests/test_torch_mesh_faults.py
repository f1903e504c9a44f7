"""Two checks of the serve partition that one card's aliasing could hide or
that the cost model left unexplained, on the CPU at smoke width.

* Distinct blocks (``shard_map.distinct_blocks``).  One card's mesh
  positions share one tensor wherever they hold the same block, so a
  position that misses a write to its copy of a replicated leaf cannot
  show.  Under the mode each position's block is its own tensor, as on
  distinct devices.  The decode layouts that keep a replicated copy —
  ``SERVE_RULES``' per-row index over a split ring, a ring "model" does
  not divide (the KV heads split where they divide it, else every head at
  every rank) and the paged pool, whole at each position while its rows
  split over "data" — run two steps on (2, 4) for the families of
  ``tests/test_torch_serve_mesh_families.py``' layout cases, and the
  fallback cases of ``tests/test_torch_model_axis.py`` (a per-row index
  on (1, 4), a 32-slot ring on (1, 3), a pool on (1, 4)) on its split-K
  config.  After every step the logits and every cache leaf equal the
  aliased run's bitwise, and every position's copy of a leaf equals each
  other position's copy of the same block bitwise.
* zamba2's decode FLOPs by module.  Over a ``LoneMesh`` of (2, 4) on the
  zamba2 smoke config (float32 and bfloat16), ``CostCounter``'s FLOPs of
  one decode step inside each module — ``in_proj`` through
  ``project_columns``, the conv step, the state update (``_ssd_step``),
  the gate and the gated norm with ``out_proj`` — equal the counts derived
  from the shapes, the state update over the rank's H / m heads alone (the
  reference's per-device program updates its heads of ``h`` and
  all-gathers them); the shared attention's, its MLP's and the per-group
  down projection's matmul FLOPs equal theirs.  ``python
  tests/test_torch_mesh_faults.py`` prints the same derivation for the
  full zamba2-2.7b ``decode_32k`` cell on (16, 16), module by module.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from test_torch_model_axis import DENSE
from test_torch_serve_mesh_families import (
    DECODE_STEPS, LAYOUTS, ROWS, inputs, to_layout,
)

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import dryrun
from repro_torch.launch.cost import CostCounter
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import LM, ModelConfig, ShapeCfg, steps
from repro_torch.models import attention, blocks, mamba, transformer
from repro_torch.sharding import SERVE_RULES, shard_ctx
from repro_torch.sharding import shard_map as sm


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(shape, axes=("data", "model")):
    return make_mesh(shape, axes, devices=["cpu"] * math.prod(shape))


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    return np.array(tree)


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _whole(leaf):
    return leaf.full() if isinstance(leaf, sm.ShardedArray) else leaf


def copies_agree(cache):
    """Every position's block of each ``ShardedArray`` leaf, grouped by the
    block it holds: distinct tensors, bitwise equal within a group.
    Returns the number of leaves that are replicated somewhere."""
    replicated = 0
    for name, leaf in sm.tree_leaves(cache).items():
        if not isinstance(leaf, sm.ShardedArray):
            continue
        by_block: dict = {}
        for pos, blk in leaf.blocks.items():
            by_block.setdefault(sm._block_key(leaf.spec, leaf.mesh, pos),
                                []).append((pos, blk))
        replicated += any(len(g) > 1 for g in by_block.values())
        for group in by_block.values():
            p0, b0 = group[0]
            for p, b in group[1:]:
                assert b.data_ptr() != b0.data_ptr(), (name, p0, p)
                assert torch.equal(b, b0), (name, p0, p)
    return replicated


def _run_both(cfg, model, cache, feed, mesh):
    """Decode ``feed`` over ``cache`` under ``shard_ctx(SERVE_RULES,
    mesh)`` twice, aliased and under ``distinct_blocks``, holding them
    after every step → the number of replicated cache leaves."""
    step = steps.make_decode_step(cfg)
    alias, clone = _torch(cache), _torch(cache)
    for t in feed:
        t = torch.from_numpy(np.asarray(t, np.int32))
        with shard_ctx(SERVE_RULES, mesh):
            want, alias = step(model, t, alias)
        with sm.distinct_blocks(), shard_ctx(SERVE_RULES, mesh):
            got, clone = step(model, t, clone)
        assert torch.equal(got, want)
        a, c = sm.tree_leaves(alias), sm.tree_leaves(clone)
        assert a.keys() == c.keys()
        for k in a:
            assert torch.equal(_whole(c[k]), _whole(a[k])), k
        replicated = copies_agree(clone)
    return replicated


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "seamless-m4t-medium",
                                  "zamba2-2.7b", "qwen2-vl-7b",
                                  "olmoe-1b-7b"])
def test_family_decode_layouts_hold_with_distinct_blocks(arch, layout):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    model = LM(cfg, device="cpu", seed=0)
    _, cache = steps.make_prefill_step(cfg, LAYOUTS[layout][0])(
        model, inputs(cfg, ROWS, seed=3))
    cache = to_layout(_numpy(cache), layout)
    feed = np.random.default_rng(4).integers(0, cfg.vocab,
                                             (DECODE_STEPS, ROWS, 1))
    replicated = _run_both(cfg, model, cache, feed, cpu_mesh((2, 4)))
    # the pool lies whole at each position; an odd ring whose KV heads do
    # not split over "model" lies whole at each "model" rank
    if layout == "paged" or (layout == "odd" and cfg.n_kv_heads % 4):
        assert replicated > 0


@pytest.mark.parametrize("case", ["vector index", "Smax % m", "paged"])
def test_splitk_fallback_layouts_hold_with_distinct_blocks(case):
    cfg = ModelConfig(**DENSE)
    model = LM(cfg, device="cpu", seed=0)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, (8, 16))
    _, cache = steps.make_prefill_step(cfg, 32)(
        model, {"tokens": torch.from_numpy(tokens.astype(np.int32))})
    cache = _numpy(cache)
    mesh = cpu_mesh((1, 4))
    if case == "vector index":
        cache["index"] = np.full((8,), int(cache["index"]), np.int32)
    elif case == "Smax % m":
        mesh = cpu_mesh((1, 3))                       # 32 % 3 != 0
    else:
        bk = 8
        L, B, Smax = cache["layers"]["k"].shape[:3]
        cache["layers"] = {n: v.reshape(L, B * Smax // bk, bk, *v.shape[3:])
                           for n, v in cache["layers"].items()}
        cache["block_tbl"] = np.arange(B * Smax // bk, dtype=np.int32
                                       ).reshape(B, Smax // bk)
    feed = np.random.default_rng(6).integers(0, cfg.vocab, (DECODE_STEPS, 8,
                                                            1))
    assert _run_both(cfg, model, cache, feed, mesh) == (
        0 if case == "vector index" else 2)


def test_a_missed_write_to_one_copy_shows():
    """The check has teeth: under the mode, one position's copy of a
    replicated leaf changed alone fails it; aliased, the positions share
    one tensor and nothing can differ."""
    cfg = dataclasses.replace(get_smoke_config("qwen2.5-3b"),
                              dtype="float32")
    model = LM(cfg, device="cpu", seed=0)
    _, cache = steps.make_prefill_step(cfg, 30)(model, inputs(cfg, ROWS))
    cache = to_layout(_numpy(cache), "odd")
    mesh = cpu_mesh((2, 4))
    tok = torch.zeros((ROWS, 1), dtype=torch.int32)
    with shard_ctx(SERVE_RULES, mesh):
        _, alias = steps.make_decode_step(cfg)(model, tok, _torch(cache))
    k = alias["layers"]["k"]
    assert len({b.data_ptr() for b in k.blocks.values()}) < len(k.blocks)
    with sm.distinct_blocks(), shard_ctx(SERVE_RULES, mesh):
        _, clone = steps.make_decode_step(cfg)(model, tok, _torch(cache))
    copies_agree(clone)
    last = sm.positions(mesh)[-1]
    clone["layers"]["k"].blocks[last][0, 0, 0] += 1.0
    with pytest.raises(AssertionError):
        copies_agree(clone)


# ------------------------------------------------- zamba2's decode FLOPs


def derive_zamba2_decode(cfg, rows, m, ring):
    """{module: FLOPs of one decode step at one position} from the shapes:
    ``rows`` the position's rows, ``m`` the "model" axis, ``ring`` the
    shared attention's ring length (split over "model": split-K).  The
    Mamba2 modules count every op (a dtype conversion 1 an element, as
    ``CostCounter`` does), the others their matmul-class FLOPs ("mm:").
    Each Mamba2 entry is per layer, each shared one per application."""
    B, d, di = rows, cfg.d_model, cfg.d_inner
    H, hd, N = cfg.ssm_heads, cfg.ssm.headdim, cfg.ssm.d_state
    G, k = cfg.ssm.n_groups, cfg.ssm.d_conv
    bf = cfg.dtype != "float32"         # the casts to and from float32
    n, c = H // m, H // m * hd
    width = 2 * di + 2 * G * N + H
    cb = (di + 2 * G * N) // m
    d2, f = 2 * d, cfg.d_ff // m
    nq, nkv, ahd = cfg.n_heads // m, cfg.n_kv_heads // m, cfg.hd
    BnP, Bnp = B * n * hd * N, B * n * hd
    return {
        "in_proj": 2 * B * d * (width // m),
        "conv": 2 * B * k * cb + 2 * B * cb,
        "state update": 5 * BnP + 3 * Bnp + 3 * B * n + n
        + bf * (B * n + 3 * n),
        "gate": 4 * B * c + bf * 2 * B * c,
        "norm, out_proj": 2 * B * c * d + 2 * B * c + 2 * B
        + bf * (c + B * c),
        "mamba2 rest": bf * (B * c + 2 * B * G * N),
        "mm: shared attention": 2 * B * d2 * (nq + 2 * nkv) * ahd
        + 2 * B * nq * ahd * d2
        + 2 * 2 * B * cfg.n_heads * (ring // m) * ahd,
        "mm: shared mlp": 3 * 2 * B * d2 * f,
        "mm: down": 2 * B * d2 * d,
    }


def count_zamba2_decode(cfg, shape, mesh_shape):
    """{module: (FLOPs, matmul FLOPs, calls)} of one lone decode step."""
    lone = sm.LoneMesh(cpu_mesh(mesh_shape), (0,) * len(mesh_shape))
    _, step, args, rules = dryrun.build_lone_cell(cfg, shape, lone)
    counter = CostCounter()
    got: dict = {}

    def mm():
        return sum(counter.by_op[k][1] for k in ("aten.mm", "aten.bmm"))

    def wrap(fn, name):
        def run(*a, **kw):
            f0, m0 = counter.flops, mm()
            out = fn(*a, **kw)
            row = got.setdefault(name, [0, 0, 0])
            row[0] += counter.flops - f0
            row[1] += mm() - m0
            row[2] += 1
            return out
        return run

    patches = [(mamba, "project_columns", "in_proj", False),
               (mamba.Mamba2, "_conv_step", "conv", True),
               (mamba.Mamba2, "_ssd_step", "state update", True),
               (mamba.Mamba2, "_gate", "gate", False),
               (mamba.Mamba2, "_norm_out", "norm, out_proj", False),
               (mamba.Mamba2, "decode_mesh", "mamba2", False),
               (attention.Attention, "decode_mesh", "shared attention",
                False),
               (blocks.SharedAttnBlock, "_mlp_mesh", "shared mlp", False),
               (transformer.LM, "_down_mesh", "down", False)]
    saved = [(obj, attr, obj.__dict__[attr]) for obj, attr, _, _ in patches]
    try:
        for obj, attr, name, static in patches:
            fn = getattr(obj, attr)
            setattr(obj, attr, staticmethod(wrap(fn, name)) if static
                    else wrap(fn, name))
        with shard_ctx(rules, lone), counter:
            step(*args)
    finally:
        for obj, attr, fn in saved:
            setattr(obj, attr, fn)
    return got, counter


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_zamba2_decode_flops_by_module(dtype):
    cfg = dataclasses.replace(get_smoke_config("zamba2-2.7b"),
                              name="zamba2-2.7b", dtype=dtype)
    m, rows, ring = 4, 8, 64
    shape = ShapeCfg("decode_32k", ring, 2 * rows, "decode")
    got, counter = count_zamba2_decode(cfg, shape, (2, m))
    want = derive_zamba2_decode(cfg, rows, m, ring)
    layers = cfg.n_layers
    apps = layers // cfg.hybrid.attn_every
    for name in ("in_proj", "conv", "state update", "gate",
                 "norm, out_proj"):
        assert got[name][2] == layers, name
        assert got[name][0] == want[name] * layers, name
    inner = sum(got[n][0] for n in ("in_proj", "conv", "state update",
                                    "gate", "norm, out_proj"))
    assert got["mamba2"][0] - inner == want["mamba2 rest"] * layers
    assert got["norm, out_proj"][1] == 2 * rows * (
        cfg.ssm_heads // m * cfg.ssm.headdim) * cfg.d_model * layers
    for name in ("shared attention", "shared mlp", "down"):
        assert got[name][2] == apps, name
        assert got[name][1] == want[f"mm: {name}"] * apps, name
    # the in_proj product moved, not its weight: one all-gather of each
    # rank's columns a layer
    width = 2 * cfg.d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state \
        + cfg.ssm_heads
    assert counter.collectives.count(
        ("all-gather", rows * width * cfg.cdtype.itemsize, m)) == layers


def main():
    """The derivation for the full zamba2-2.7b ``decode_32k`` cell at a
    lone position of (16, 16): 8 rows, a 32768-slot ring, bf16."""
    cfg = get_config("zamba2-2.7b")
    m, rows, ring = 16, 8, 32768
    want = derive_zamba2_decode(cfg, rows, m, ring)
    layers, apps = cfg.n_layers, cfg.n_layers // cfg.hybrid.attn_every
    total = 0
    for name, v in want.items():
        each = apps if name.startswith("mm: ") else layers
        total += v * each
        print(f"{name:24s} {v:>14,d} x {each:2d} = {v * each:.4e}")
    every_head = derive_zamba2_decode(cfg, rows, 1, ring)["state update"]
    print(f"{'sum':24s} {total:.4e}; the state update over all {cfg.ssm_heads}"
          f" heads at each rank: {every_head * layers:.4e}")
    # split-K's casts of each K/V block to float32, a shared application
    print(f"split-K K/V casts a step: "
          f"{2 * rows * (ring // m) * cfg.n_kv_heads * cfg.hd * apps:.4e}")


if __name__ == "__main__":
    main()
