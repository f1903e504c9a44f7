"""The port's logical-axis partition rules (``repro_torch.sharding``)
against the reference's (``repro.sharding``), on the CPU.

* ``tests/test_sharding.py``'s rule tests, on the port: basic specs, the
  divisibility fallback, the partial-divisibility prefix, no mesh axis
  used twice, a property test of valid specs, ``tree_specs`` structure,
  serve rules, ``constrain`` a no-op, ``replace`` functional.
* ``spec_for`` equal to the reference's over an enumerated set of
  (dims, logical names, rule table, mesh shape): both read the same
  stand-in mesh (``axis_names`` and a numpy ``devices`` array), and the
  port's canonical tuple equals the reference's ``PartitionSpec`` as a
  tuple.
* ``pod_decode_rules`` and the per-leaf cache specs of a sharded pool for
  every smoke family, dense and paged, equal to the specs the reference's
  ``make_sharded_decode`` derives.
"""
import itertools

import jax
import numpy as np
import pytest
import torch
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models.steps import cache_axes as ref_cache_axes
from repro.serving.slots import paged_cache_spec as ref_paged_cache_spec
from repro.serving.slots import pool_geometry as ref_pool_geometry
from repro.sharding import rules as ref_rules

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.serving.slots import _map_tree, make_pool
from repro_torch.sharding import (
    AxisRules, SERVE_RULES, SERVE_RULES_SMALL_BATCH, TRAIN_RULES, constrain,
    current_ctx, logical, no_shard_ctx, pod_decode_rules, serve_rules,
    shard_ctx, spec_for, tree_specs,
)


class FakeMesh:
    """Duck-typed mesh (axis_names + devices.shape), read alike by both
    packages' ``spec_for``."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.devices = np.empty(shape, object)


MESH_2D = FakeMesh((16, 16), ("data", "model"))
MESH_3D = FakeMesh((2, 16, 16), ("pod", "data", "model"))


# ------------------------------------------------------- the rule tests


def test_basic_specs():
    rules = TRAIN_RULES
    assert spec_for(("batch", "seq"), rules, MESH_2D, (256, 4096)) == \
        ("data",)
    assert spec_for(("batch", "seq"), rules, MESH_3D, (256, 4096)) == \
        (("pod", "data"),)
    assert spec_for(("embed", "ff"), rules, MESH_2D, (4096, 16384)) == \
        ("data", "model")


def test_divisibility_fallback_replicates():
    # 40 heads % 16 != 0 → replicated (the qwen2.5-14b case)
    assert spec_for(("embed", "heads"), TRAIN_RULES, MESH_2D,
                    (5120, 40)) == ("data",)
    assert spec_for(("embed", "heads"), TRAIN_RULES, MESH_2D,
                    (5120, 64)) == ("data", "model")


def test_batch_partial_divisibility_keeps_prefix():
    # batch 2 on ("pod", "data") = (2, 16): 32 doesn't divide 2, the "pod"
    # prefix does
    assert spec_for(("batch", None), TRAIN_RULES, MESH_3D, (2, 128)) == \
        ("pod",)


def test_no_mesh_axis_used_twice():
    rules = AxisRules({"a": ("model",), "b": ("model",)})
    assert spec_for(("a", "b"), rules, MESH_2D, (64, 64)) == ("model",)


@settings(max_examples=40, deadline=None)
@given(
    dims=st.lists(st.sampled_from([1, 2, 3, 5, 8, 16, 40, 64, 256]),
                  min_size=1, max_size=4),
    names=st.lists(st.sampled_from(["batch", "embed", "heads", "ff", "vocab",
                                    "experts", None]),
                   min_size=1, max_size=4),
)
def test_spec_always_valid(dims, names):
    """Every spec names only real mesh axes, never repeats one, and every
    sharded dim divides by its axes' product — and equals the
    reference's."""
    n = min(len(dims), len(names))
    dims, names = dims[:n], names[:n]
    spec = spec_for(names, TRAIN_RULES, MESH_2D, dims)
    sizes = dict(zip(MESH_2D.axis_names, MESH_2D.devices.shape))
    seen = []
    for i, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        for a in axes:
            assert a in sizes and a not in seen
            seen.append(a)
        if axes:
            assert dims[i] % int(np.prod([sizes[a] for a in axes])) == 0
    assert spec == tuple(ref_rules.spec_for(names, ref_rules.TRAIN_RULES,
                                            MESH_2D, dims))


def test_tree_specs_mirrors_structure():
    axes_tree = {"w": ("embed", "ff"), "b": ("ff",), "s": [("batch",)]}
    shapes = {"w": np.zeros((128, 64)), "b": (64,), "s": [(32,)]}
    specs = tree_specs(axes_tree, TRAIN_RULES, MESH_2D, shapes)
    assert specs == {"w": ("data", "model"), "b": ("model",),
                     "s": [("data",)]}
    assert tree_specs(axes_tree, TRAIN_RULES) == {
        "w": ("data", "model"), "b": ("model",), "s": [(("pod", "data"),)]}


def test_serve_rules_shard_cache_seq():
    assert spec_for(("batch", "cache_seq", "kv_heads", None), SERVE_RULES,
                    MESH_2D, (128, 32768, 8, 128)) == ("data", "model")
    assert spec_for(("batch", "cache_seq", "kv_heads", None), TRAIN_RULES,
                    MESH_2D, (128, 32768, 8, 128)) == ("data",)
    assert serve_rules(16) is SERVE_RULES
    assert serve_rules(1) is SERVE_RULES_SMALL_BATCH
    assert SERVE_RULES_SMALL_BATCH.get("embed") == ("data",)


def test_constrain_is_a_no_op_with_or_without_context():
    assert current_ctx() is None
    x = torch.ones(4, 4)
    assert constrain(x, ("batch", "embed")) is x
    with shard_ctx(SERVE_RULES, MESH_2D):
        assert current_ctx() == (SERVE_RULES, MESH_2D)
        assert constrain(x, ("batch", "embed")) is x
        with no_shard_ctx():
            assert current_ctx() is None
        assert current_ctx() == (SERVE_RULES, MESH_2D)
    assert current_ctx() is None
    assert logical.act("batch", None) == ("batch", None)


def test_replace_is_functional():
    r2 = TRAIN_RULES.replace(embed=())
    assert TRAIN_RULES.get("embed") == ("data",)
    assert r2.get("embed") == ()
    assert r2.get(None) == () and r2.get("nonexistent") == ()


# ------------------------------------------- spec_for against the reference

NAMES = ["batch", "seq", "embed", "heads", "kv_heads", "ff", "vocab",
         "cache_seq", "cache_blocks", "layers", None]
DIMS = [1, 2, 3, 4, 6, 8, 16, 40]
MESHES = [((1,), ("data",)), ((2,), ("data",)), ((4,), ("model",)),
          ((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
          ((2, 1, 2), ("pod", "data", "model"))]


def _cases():
    rng = np.random.default_rng(0)
    out = []
    for n in (1, 2, 3, 4, 5):
        for _ in range(12):
            names = tuple(NAMES[i] for i in rng.integers(0, len(NAMES), n))
            dims = tuple(int(DIMS[i]) for i in rng.integers(0, len(DIMS), n))
            out.append((names, dims))
    return out


@pytest.mark.parametrize("shape,axes", MESHES,
                         ids=["x".join(map(str, s)) for s, _ in MESHES])
def test_spec_for_equals_reference(shape, axes):
    mesh = FakeMesh(shape, axes)
    tables = [(TRAIN_RULES, ref_rules.TRAIN_RULES),
              (SERVE_RULES, ref_rules.SERVE_RULES),
              (SERVE_RULES_SMALL_BATCH, ref_rules.SERVE_RULES_SMALL_BATCH),
              (pod_decode_rules(mesh), ref_rules.pod_decode_rules(mesh))]
    assert pod_decode_rules(mesh).rules == \
        ref_rules.pod_decode_rules(mesh).rules
    n = 0
    for (mine, theirs), (names, dims) in itertools.product(tables,
                                                          _cases()):
        for m, d in ((mesh, dims), (mesh, None), (None, None)):
            got = spec_for(names, mine, m, d)
            want = ref_rules.spec_for(names, theirs, m, d)
            assert got == tuple(want), (names, dims, got, want)
            n += 1
    assert n == 4 * 60 * 3


# ---------------------------------------- per-leaf cache specs of a pool

FAMILIES = ["qwen2.5-3b", "zamba2-2.7b", "olmoe-1b-7b", "falcon-mamba-7b",
            "qwen2-vl-7b", "seamless-m4t-medium", "h2o-danube-1.8b"]
POOL_MESHES = [((2,), ("data",)), ((4,), ("model",)),
               ((2, 2), ("data", "model"))]
SLOTS, MAX_SEQ = 4, 16


def _ref_cache_specs(cfg, mesh, pool):
    """The per-leaf specs the reference's make_sharded_decode derives."""
    rules = ref_rules.pod_decode_rules(mesh)
    if pool == "paged":
        bk, nb = ref_pool_geometry(SLOTS, MAX_SEQ,
                                   partitions=int(mesh.devices.size))
        spec = ref_paged_cache_spec(cfg, SLOTS, MAX_SEQ, block_size=bk,
                                    num_blocks=nb)
        axes = jax.tree.map(lambda leaf: leaf[2], spec,
                            is_leaf=lambda x: isinstance(x, tuple)
                            and len(x) == 3 and isinstance(x[0], tuple))
    else:
        axes = ref_cache_axes(cfg, SLOTS, MAX_SEQ)
    specs = jax.tree.map(lambda ax: tuple(ref_rules.spec_for(ax, rules,
                                                             mesh)),
                         axes, is_leaf=ref_rules._is_axes_leaf)
    specs["index"] = tuple(ref_rules.spec_for(("batch",), rules, mesh))
    if "cross_len" in specs:
        specs["cross_len"] = tuple(ref_rules.spec_for(("batch",), rules,
                                                      mesh))
    return specs


@pytest.mark.parametrize("pool", ["dense", "paged"])
@pytest.mark.parametrize("arch", FAMILIES)
def test_pool_cache_specs_equal_reference(arch, pool):
    """Each leaf of a sharded pool splits as the reference's sharded decode
    shards it, on every mesh; the split dim is the one the spec names, and
    each shard holds its 1/N of the leaf."""
    for shape, axes in POOL_MESHES:
        n = int(np.prod(shape))
        mesh = make_mesh(shape, axes, devices=["cpu"] * n)
        p = make_pool(get_smoke_config(arch), SLOTS, MAX_SEQ, pool=pool,
                      mesh=mesh)
        want = _ref_cache_specs(ref_smoke_config(arch), FakeMesh(shape, axes),
                                pool)
        assert p.specs == want
        # the shards, put back together along their split dims, are the
        # unsharded pool with the same partitions (block tables included:
        # they keep global block ids)
        whole = make_pool(get_smoke_config(arch), SLOTS, MAX_SEQ, pool=pool,
                          partitions=n, device="cpu").cache

        def check(spec, dim, leaf, *shards):
            assert spec[dim] is not None and all(x is None
                                                 for x in spec[dim + 1:])
            assert all(x.shape[dim] * n == leaf.shape[dim] for x in shards)
            assert torch.equal(torch.cat(shards, dim), leaf)

        _map_tree(check, p.specs, p.cache.dims, whole, *p.cache.shards)
