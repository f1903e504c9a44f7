"""Logical-axis partition rules (``repro.sharding.rules``).

Every parameter / activation dimension in the model code is tagged with a
*logical* axis name ("embed", "heads", "vocab", "batch", ...).  A rule
table maps each logical name to zero or more *mesh* axes, so the same
model code can be laid over any mesh by swapping the rule table.

Mesh axes (launch/mesh.py):
  pod    — data parallelism across pods
  data   — data parallelism / FSDP within a pod
  model  — tensor / expert parallelism within a pod

Rules may map a logical axis to an axis that does not exist in the current
mesh (e.g. "pod" on the single-pod mesh) — such entries are silently
dropped, and a logical dim whose mesh-axis product does not divide the
actual dim size falls back to its largest divisible prefix (down to
replication).

``spec_for`` returns a plain tuple in ``PartitionSpec``'s canonical form:
per dim ``None``, one mesh axis name or a tuple of names, trailing ``None``
dropped.  It reads a mesh only through ``axis_names`` and
``devices.shape``.  The port has no partitioner: a sharded replica
(``serving/replica.py``) places each shard on its device itself from these
specs, so ``constrain`` returns its input unchanged.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Mapping logical axis name -> tuple of mesh axis names (in order)."""

    rules: Mapping[str, tuple[str, ...]]

    def get(self, name: str | None) -> tuple[str, ...]:
        if name is None:
            return ()
        return tuple(self.rules.get(name, ()))

    def replace(self, **kw: tuple[str, ...]) -> "AxisRules":
        d = dict(self.rules)
        d.update(kw)
        return AxisRules(d)


# Training: FSDP over ("data",) on the embed dim of weights, tensor parallel
# over ("model",) on heads / ff / vocab / experts; batch over (pod, data).
TRAIN_RULES = AxisRules({
    "batch": ("pod", "data"),
    "seq": (),
    "embed": ("data",),          # FSDP shard dim of weight matrices
    "embed_act": (),             # activations keep d_model replicated
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),
    "qkv": ("model",),           # fused qkv output dim
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_ff": (),
    "layers": (),                # stacked leading layer dim
    "d_inner": ("model",),       # mamba inner channels
    "d_state": (),
    "conv_kernel": (),
    "cache_seq": (),             # decode KV cache sequence dim
    "enc_seq": (),
})

# Serving: pure tensor parallelism — weights sharded over "model" only and
# replicated over "data"/"pod"; the decode KV cache shards its sequence dim
# over "model" (split-K decode).
SERVE_RULES = TRAIN_RULES.replace(cache_seq=("model",), embed=())

# Weight-distributed serving for tiny batches: with nothing to amortize
# weight reads over, spreading the weights over every device wins.
SERVE_RULES_SMALL_BATCH = SERVE_RULES.replace(embed=("data",))


def serve_rules(global_batch: int) -> AxisRules:
    """Layout choice is batch-dependent: big-batch decode amortizes local
    weight reads (TP-only); tiny-batch decode wants weights spread over
    every device (weight-distributed)."""
    return SERVE_RULES if global_batch >= 16 else SERVE_RULES_SMALL_BATCH


def pod_decode_rules(mesh, base: AxisRules = SERVE_RULES) -> AxisRules:
    """SERVE_RULES specialized for a replica's sharded decode tick on
    ``mesh`` (ShardedReplica, one process or each rank of a pod).

    The decode is collective-free — purely batch-parallel — so the
    slot/batch axis absorbs EVERY mesh axis.  ``spec_for``'s first-use-wins
    rule then drops the base table's model-axis mappings (cache_seq,
    kv_heads, vocab) on every cache/logits leaf: batch is the leading
    sharded dim of every decode-state leaf, so no leaf can demand a
    collective the decode does not perform.

    "cache_blocks" (the physical-block axis of a paged KV pool) maps to the
    same axes as "batch": a shard owns a contiguous range of blocks exactly
    as it owns a contiguous range of slots, and the paged allocator pins a
    slot's blocks to its own partition."""
    axes = tuple(mesh.axis_names)
    return base.replace(batch=axes, cache_blocks=axes)


def _mesh_axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def spec_for(logical_axes: Sequence[str | None], rules: AxisRules,
             mesh=None, dim_sizes: Sequence[int] | None = None) -> tuple:
    """Partition spec (canonical tuple) for one array whose dims are named
    by ``logical_axes``.

    If ``mesh``/``dim_sizes`` are given, any mapping that would not divide
    the dim size (or names a mesh axis that doesn't exist) is dropped →
    replicate.  No mesh axis is used twice across dims (first wins).
    """
    sizes = _mesh_axis_sizes(mesh) if mesh is not None else None
    used: set[str] = set()
    out: list = []
    for i, name in enumerate(logical_axes):
        axes = [a for a in rules.get(name) if (sizes is None or a in sizes)]
        axes = [a for a in axes if a not in used]
        if sizes is not None and dim_sizes is not None and axes:
            total = int(np.prod([sizes[a] for a in axes]))
            if dim_sizes[i] % total != 0:
                # keep the largest divisible prefix of the axis list
                keep: list[str] = []
                prod = 1
                for a in axes:
                    if dim_sizes[i] % (prod * sizes[a]) == 0:
                        keep.append(a)
                        prod *= sizes[a]
                    else:
                        break
                axes = keep
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(tuple(axes))
    while out and out[-1] is None:   # canonical form
        out.pop()
    return tuple(out)


def _is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(a, (str, type(None)))
                                        for a in x)


def _map(fn, tree, *rest):
    """fn over the axes-tuple leaves of nested dicts / lists / tuples."""
    if _is_axes_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"not an axes tree leaf: {tree!r}")


def _shape(x) -> tuple:
    return tuple(x.shape) if hasattr(x, "shape") else tuple(x)


def tree_specs(axes_tree, rules: AxisRules, mesh=None, shapes_tree=None):
    """Map a tree of logical-axis tuples to a tree of partition specs.

    ``axes_tree`` mirrors the params (or cache) tree with tuples of logical
    names as leaves.  ``shapes_tree`` (optional, same structure, tuples of
    ints or anything with a ``shape``) enables the divisibility fallback.
    """
    if shapes_tree is None:
        return _map(lambda ax: spec_for(ax, rules, mesh), axes_tree)
    shapes = _shapes_like(axes_tree, shapes_tree)
    return _map(lambda ax, shp: spec_for(ax, rules, mesh, shp), axes_tree,
                shapes)


def _shapes_like(axes_tree, shapes_tree):
    """``shapes_tree`` cut to ``axes_tree``'s structure, leaves as tuples."""
    if _is_axes_leaf(axes_tree):
        return _shape(shapes_tree)
    if isinstance(axes_tree, dict):
        return {k: _shapes_like(v, shapes_tree[k])
                for k, v in axes_tree.items()}
    return type(axes_tree)(_shapes_like(v, shapes_tree[i])
                           for i, v in enumerate(axes_tree))


# ---------------------------------------------------------------------------
# Ambient shard context: model code calls constrain() without knowing the mesh.
# ---------------------------------------------------------------------------

_TLS = threading.local()


@contextlib.contextmanager
def shard_ctx(rules: AxisRules, mesh):
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = (rules, mesh)
    try:
        yield
    finally:
        _TLS.ctx = prev


@contextlib.contextmanager
def no_shard_ctx():
    """Suspend the ambient context (inside a per-shard body, which already
    works on explicit per-device blocks)."""
    prev = getattr(_TLS, "ctx", None)
    _TLS.ctx = None
    try:
        yield
    finally:
        _TLS.ctx = prev


def current_ctx():
    return getattr(_TLS, "ctx", None)


def constrain(x, logical_axes: Sequence[str | None]):
    """The reference's sharding constraint through the ambient table.

    The port has no partitioner to hand a constraint to: its sharded
    replica places every shard on its device explicitly, from
    ``spec_for``.  So this returns ``x`` unchanged, with or without a shard
    context."""
    return x


class logical:
    """Helper namespace: shorthand constructors for axis tuples."""

    @staticmethod
    def act(*names: str | None):
        return tuple(names)
