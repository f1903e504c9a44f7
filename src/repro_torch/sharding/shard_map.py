"""The shard map and its collectives: the port's counterpart of
``repro.sharding.shard_map`` and of the ``jax.lax`` collectives its bodies
call (``axis_index``, ``psum``, ``pmax``, ``pmean``, ``all_gather``).

The port has no SPMD partitioner.  A body the reference runs under
``shard_map`` is written here as loops over the mesh's positions, broken
at each collective, all on the host thread: between two collectives every
shard runs its part in turn, and a collective takes the per-shard values
of the whole mesh (a dict from mesh position to tensor, ``per_shard``) and
returns the per-shard results.  One thread keeps what
lives per thread — grad mode, the ambient shard context, a cost counter's
dispatch mode, the kernels' launch counts — which one thread per shard
would lose.

Layout.  A spec is ``spec_for``'s canonical tuple: per dim ``None``, a mesh
axis or a tuple of axes (row-major in the order given).  ``split`` cuts a
tensor into one block per position; positions that hold the same block on
the same device share one tensor, and a block on the tensor's own device
is a view of it — nothing is copied on a one-card mesh, and an in-place
write to such a block reaches the tensor.  Under ``distinct_blocks()`` (a
mode for tests) every position's block is a tensor of its own, as on a
mesh of distinct devices: ``split`` copies, and each member of a
collective gets its own copy of the result, so a position that misses a
write to its copy of a replicated leaf shows.  ``join`` puts blocks back
together (the first position holding each block gives it).
``ShardedArray`` keeps a tensor's blocks between calls: the port's
stand-in for a jax Array under a ``NamedSharding``, as ``ShardedCache``
(``serving/slots.py``) keeps a pool's shards.  ``device_put`` places a
tensor (or a tree, by a tree of ``NamedSharding`` from
``tree_shardings``) that way.  ``relayout`` moves blocks from one
layout to another (gathers over the axes the first splits, then a local
slice).  ``LoneMesh`` is one position of a mesh alone: the dry-run counts
one device's program with it.

Collectives reduce over one mesh axis or a tuple of axes.  A reduction
runs once per group, in rank order, on the device of the group's first
member (a narrower float type adds in float32 and rounds once, as XLA:CPU
promotes it), and its result is copied to each member's device (members
on one device share it).  So every shard holds bitwise the same value.
``psum``, ``pmean`` and ``all_gather`` are each one autograd node whose
backward is a collective too, as the reference's transposes are: a psum's
backward psums the cotangents, an all-gather's reduce-scatters them
(``lax.psum_scatter``).  The backward counts each distinct result once:
members on one device share one result, into which autograd has already
summed their uses.  ``token_mean`` is the loss's mean over every valid
token of a batch split over the batch axes.  Under a cost counter
(``launch.cost.CostCounter``) each call, forward or backward, is one
region: its own ops count no FLOPs and no bytes, and it records ``(kind,
result bytes, group size)`` once, as every device runs each collective
once in the reference's per-device program; over a ``LoneMesh`` it
returns a stand-in and records the same.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from repro_torch.kernels.region import active_counter
from repro_torch.sharding.rules import _map, tree_specs


# ------------------------------------------------------------------ the mesh


def axes_of(entry) -> tuple[str, ...]:
    """A spec entry (None, an axis name or a tuple of names) as a tuple."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def canonical(spec) -> tuple:
    """``spec`` with trailing ``None`` dropped and 1-tuples unwrapped."""
    out = [None if not axes_of(e) else
           (axes_of(e)[0] if len(axes_of(e)) == 1 else tuple(axes_of(e)))
           for e in spec]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def positions(mesh) -> list[tuple[int, ...]]:
    """Every mesh position, row-major; a lone mesh's one position."""
    if isinstance(mesh, LoneMesh):
        return [mesh.position]
    return list(np.ndindex(mesh.devices.shape))


class LoneMesh:
    """One position of a mesh: the per-device program of the reference's
    dry-run, counted on one card.  It keeps the whole mesh's ``axis_names``
    and ``devices`` (so ``spec_for``, ``axis_size`` and ``axis_index`` read
    the full mesh's sizes and this position's indices), but ``positions``
    yields ``position`` alone, and only its blocks exist.  A collective
    over it has one member a group and returns a stand-in of its result's
    shape and dtype: a reduction its member's value (a mean divided by the
    group's size), an all-gather that value repeated over the group, a
    reduce-scatter its rank's slice; it records ``(kind, result bytes,
    group size)`` as the whole mesh's run does.  So a lone run's FLOPs,
    bytes and collectives are one device's, and its values are not the
    model's: only their shapes and finiteness can be checked."""

    def __init__(self, mesh, position):
        self.mesh = mesh
        self.axis_names = tuple(mesh.axis_names)
        self.devices = mesh.devices
        self.position = tuple(int(i) for i in position)
        if len(self.position) != self.devices.ndim or any(
                not 0 <= i < n for i, n in zip(self.position,
                                               self.devices.shape)):
            raise ValueError(f"position {self.position} is not in a mesh of "
                             f"shape {self.devices.shape}")


def is_lone(mesh) -> bool:
    return isinstance(mesh, LoneMesh)


def axis_size(mesh, axes) -> int:
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    return math.prod(sizes[a] for a in axes_of(axes))


def axis_index(mesh, pos, axes) -> int:
    """``lax.axis_index``: the rank of ``pos`` along ``axes``, row-major
    over the axes in the order given."""
    r = 0
    for a in axes_of(axes):
        i = mesh.axis_names.index(a)
        r = r * mesh.devices.shape[i] + pos[i]
    return r


def replicated_axes(spec, mesh) -> tuple:
    """The mesh axes (of more than one position) ``spec`` does not split:
    those a leaf laid out by it is replicated on."""
    used = {a for e in spec for a in axes_of(e)}
    return tuple(a for a, n in zip(mesh.axis_names, mesh.devices.shape)
                 if n > 1 and a not in used)


def per_shard(mesh, fn) -> dict:
    """{position: ``fn(position)``} over the mesh, row-major."""
    return {pos: fn(pos) for pos in positions(mesh)}


_DISTINCT = [False]


@contextlib.contextmanager
def distinct_blocks():
    """Within it, no two positions share a tensor: ``split`` (and so
    ``place``) copies each position's block, views on the source's device
    included, and a collective hands each member its own copy of the
    result.  One card's positions then behave as distinct devices' do; a
    test mode, for it copies every replicated leaf once a position."""
    old, _DISTINCT[0] = _DISTINCT[0], True
    try:
        yield
    finally:
        _DISTINCT[0] = old


def _device_key(dev: torch.device):
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return ("cuda", torch.cuda.current_device())
    return (dev.type, dev.index)


def _block_slices(shape, spec, mesh, pos) -> tuple:
    out = []
    for d, n in enumerate(shape):
        entry = spec[d] if d < len(spec) else None
        k = axis_size(mesh, entry)
        if n % k:
            raise ValueError(f"dim {d} of size {n} does not split over "
                             f"{axes_of(entry)} ({k} shards)")
        r = axis_index(mesh, pos, entry)
        out.append(slice(r * (n // k), (r + 1) * (n // k)))
    return tuple(out)


def _block_key(spec, mesh, pos) -> tuple:
    return tuple(axis_index(mesh, pos, e) for e in spec)


def split(x: torch.Tensor, spec, mesh) -> dict:
    """``x`` as one block per position under ``spec``: a view where the
    position's device is ``x``'s, a copy elsewhere; positions holding the
    same block on one device share it (under ``distinct_blocks`` each
    position gets a copy of its own)."""
    spec = canonical(spec)
    memo: dict = {}
    here = _device_key(x.device)
    distinct = _DISTINCT[0]

    def one(pos):
        dev = mesh.devices[pos]
        key = (_block_key(spec, mesh, pos), _device_key(dev),
               pos if distinct else None)
        if key not in memo:
            blk = x[_block_slices(x.shape, spec, mesh, pos)]
            memo[key] = (blk.to(dev) if key[1] != here
                         else blk.clone() if distinct else blk)
        return memo[key]
    return per_shard(mesh, one)


def join(blocks: dict, spec, mesh, device=None) -> torch.Tensor:
    """The tensor whose blocks under ``spec`` are ``blocks``, on ``device``
    (default: the first block's).  A replicated dim takes the first
    position's block."""
    spec = canonical(spec)
    first = blocks[positions(mesh)[0]]
    device = first.device if device is None else torch.device(device)
    if not spec:
        return first.to(device)
    if is_lone(mesh):
        raise ValueError("a lone mesh position holds one block: the whole "
                         "tensor cannot be joined from it")
    shape = tuple(n * axis_size(mesh, spec[d] if d < len(spec) else None)
                  for d, n in enumerate(first.shape))
    out = torch.empty(shape, dtype=first.dtype, device=device)
    seen = set()
    for pos in positions(mesh):
        key = _block_key(spec, mesh, pos)
        if key not in seen:
            seen.add(key)
            out[_block_slices(shape, spec, mesh, pos)] = blocks[pos]
    return out


def _map_blocks(blocks: dict, fn) -> dict:
    """``fn`` over the blocks, once per shared tensor."""
    memo: dict = {}
    for b in blocks.values():
        if id(b) not in memo:
            memo[id(b)] = fn(b)
    return {pos: memo[id(b)] for pos, b in blocks.items()}


class ShardedArray:
    """A global tensor held as one block per mesh position (``blocks``, a
    dict from position to tensor) under ``spec``.  ``shape``
    and ``dtype`` are the global tensor's.  Integer indices on leading
    unsplit dims (a layer of a stacked cache: ``leaf[i]``) give the blocks'
    views."""

    def __init__(self, blocks, spec, mesh, shape, dtype):
        self.blocks = blocks
        self.spec = canonical(spec)
        self.mesh = mesh
        self.shape = torch.Size(shape)
        self.dtype = dtype

    def __getitem__(self, index):
        index = index if isinstance(index, tuple) else (index,)
        if not all(isinstance(i, int) for i in index) or any(
                e is not None for e in self.spec[:len(index)]):
            raise IndexError(f"a ShardedArray under {self.spec} takes "
                             f"integer indices on its leading unsplit dims "
                             f"only, not {index}")
        n = len(index)
        return ShardedArray(_map_blocks(self.blocks, lambda b: b[index]),
                            self.spec[n:], self.mesh, self.shape[n:],
                            self.dtype)

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor (a gather: for checks, not the hot path)."""
        return join(self.blocks, self.spec, self.mesh, device)

    def __repr__(self) -> str:
        axes = dict(zip(self.mesh.axis_names, self.mesh.devices.shape))
        return (f"ShardedArray(shape={tuple(self.shape)}, dtype={self.dtype},"
                f" spec={self.spec}, mesh={axes})")


def same_mesh(m1, m2) -> bool:
    """Two meshes (or lone positions) of the same axes, devices and
    position."""
    return (is_lone(m1) == is_lone(m2)
            and getattr(m1, "position", None) == getattr(m2, "position",
                                                         None)
            and m1.axis_names == m2.axis_names
            and m1.devices.shape == m2.devices.shape
            and all(_device_key(d1) == _device_key(d2) for d1, d2 in zip(
                m1.devices.flat, m2.devices.flat)))


def same_layout(a: ShardedArray, spec, mesh) -> bool:
    return a.spec == canonical(spec) and same_mesh(a.mesh, mesh)


def place(x, spec, mesh) -> ShardedArray:
    """``x`` laid out under ``spec``: a ``ShardedArray`` already so laid is
    returned as it is, one laid otherwise is gathered and split again, and a
    tensor is split (views on its own device)."""
    if isinstance(x, ShardedArray):
        if same_layout(x, spec, mesh):
            return x
        x = x.full()
    return ShardedArray(split(x, spec, mesh), spec, mesh, x.shape, x.dtype)


def tree_leaves(tree, prefix: str = "") -> dict:
    """{"a/b": leaf} of a nested dict (a cache or parameter tree)."""
    if isinstance(tree, dict):
        return {k: v for n, t in tree.items()
                for k, v in tree_leaves(t, f"{prefix}{n}/").items()}
    return {prefix[:-1]: tree}


def clone_tree(tree):
    """``tree`` with each ``ShardedArray``'s blocks cloned, every other
    leaf as it is."""
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if not isinstance(tree, ShardedArray):
        return tree
    return ShardedArray({p: b.clone() for p, b in tree.blocks.items()},
                        tree.spec, tree.mesh, tree.shape, tree.dtype)


def lone_tree(tree, lone, clone: bool = False):
    """A lone position's view of ``tree``: each ``ShardedArray``'s block at
    ``lone.position`` (cloned with ``clone``) over the ``LoneMesh``
    ``lone``, every other leaf as it is."""
    if isinstance(tree, dict):
        return {k: lone_tree(v, lone, clone) for k, v in tree.items()}
    if not isinstance(tree, ShardedArray):
        return tree
    blk = tree.blocks[lone.position]
    return ShardedArray({lone.position: blk.clone() if clone else blk},
                        tree.spec, lone, tree.shape, tree.dtype)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a mesh and a spec."""
    mesh: object
    spec: tuple


def tree_shardings(axes_tree, rules, mesh, shapes_tree=None):
    """The reference's ``tree_shardings``: a tree of logical-axes tuples →
    a tree of ``NamedSharding`` (``spec_for`` per leaf, with the
    divisibility fallback when ``shapes_tree`` is given)."""
    specs = tree_specs(axes_tree, rules, mesh, shapes_tree)
    return _map(lambda _, s: NamedSharding(mesh, s), axes_tree, specs)


def device_put(tree, shardings):
    """``jax.device_put``: each tensor leaf of ``tree`` placed by the
    ``NamedSharding`` at the same place of ``shardings`` (one sharding
    places every leaf; ``None`` leaves its subtree as it is).  A module in
    ``tree`` stands for {name: parameter}, as in a checkpoint."""
    if shardings is None:
        return tree
    if isinstance(shardings, NamedSharding):
        if isinstance(tree, dict):
            return {k: device_put(v, shardings) for k, v in tree.items()}
        return place(tree, shardings.spec, shardings.mesh)
    if isinstance(shardings, dict):
        if hasattr(tree, "named_parameters"):
            tree = {k: p.detach() for k, p in tree.named_parameters()}
        return {k: device_put(tree[k], s) for k, s in shardings.items()}
    kids = (device_put(t, s) for t, s in zip(tree, shardings))
    return (type(shardings)(*kids) if hasattr(shardings, "_fields")
            else type(shardings)(kids))


# --------------------------------------------------------------- collectives


def groups(mesh, axes) -> list[list[tuple[int, ...]]]:
    """The positions grouped by their coordinates off ``axes``, each group
    in rank order along ``axes``."""
    names = set(axes_of(axes))
    out: dict = {}
    for pos in positions(mesh):
        key = tuple(c for a, c in zip(mesh.axis_names, pos) if a not in names)
        out.setdefault(key, []).append(pos)
    for g in out.values():
        g.sort(key=lambda p: axis_index(mesh, p, axes))
    return list(out.values())


def _sum(xs):
    dt = xs[0].dtype
    wide = dt.is_floating_point and torch.finfo(dt).bits < 32
    acc = xs[0].float() if wide else xs[0]
    for x in xs[1:]:
        acc = acc + (x.float() if wide else x)
    return acc.to(dt) if wide else acc


def _max(xs):
    acc = xs[0]
    for x in xs[1:]:
        acc = torch.maximum(acc, x)
    return acc


def _region(kind, axes, mesh):
    """Under a cost counter, one collective region recording ``(kind,
    result bytes, group size)``; else a dict nobody reads."""
    counter = active_counter()
    return (contextlib.nullcontext({}) if counter is None else
            counter.collective_region(kind, axis_size(mesh, axes)))


def _collective(kind, vals, axes, mesh, combine, *, scatter=None,
                distinct=False):
    """``combine`` over each group's values, in rank order, on the device of
    the group's first member; every member gets the result on its own
    device (members on one device share it), or with ``scatter`` = (dim,
    size) its rank's slice of it along dim.  ``distinct`` combines each
    distinct tensor of a group once: a backward's cotangents, where members
    on one device share one result and autograd has already summed their
    uses into it."""
    out = {}
    with _region(kind, axes, mesh) as rec:
        for group in groups(mesh, axes):
            members = group
            if distinct:
                first = {id(vals[p]): p for p in reversed(group)}
                members = [p for p in group if first[id(vals[p])] == p]
            dev = vals[members[0]].device
            res = combine([vals[p].to(dev) for p in members])
            memo: dict = {}
            for r, p in enumerate(group):
                piece = res if scatter is None else res.narrow(
                    scatter[0], r * scatter[1], scatter[1])
                key = (r if scatter else None, _device_key(vals[p].device),
                       p if _DISTINCT[0] else None)
                if key not in memo:
                    memo[key] = (piece.to(vals[p].device)
                                 if _device_key(dev) != key[1]
                                 else piece.clone() if _DISTINCT[0]
                                 else piece)
                out[p] = memo[key]
            rec["bytes"] = piece.numel() * piece.element_size()
    return out


def _distinct(vals: dict):
    """(the distinct tensors among ``vals``' values, {position: index})."""
    uniq, index, seen = [], {}, {}
    for p, t in vals.items():
        if id(t) not in seen:
            seen[id(t)] = len(uniq)
            uniq.append(t)
        index[p] = seen[id(t)]
    return uniq, index


class _Exchange(torch.autograd.Function):
    """One collective over the mesh as one autograd node.  ``plan`` =
    (forward, backward, {position: input index}, {}); ``forward`` and
    ``backward`` map a per-shard dict to a per-shard dict.  Returns the
    distinct results and fills the last dict of ``plan`` with {position:
    output index}.  The backward runs ``backward`` over the results'
    cotangents and sums what each input receives: an input that several
    positions share was used once by each."""

    @staticmethod
    def forward(ctx, plan, *xs):
        fwd, _, index, out_index = plan
        out = fwd({p: xs[i] for p, i in index.items()})
        uniq, where = _distinct(out)
        out_index.update(where)
        ctx.plan, ctx.n_in = plan, len(xs)
        # a result that is an input (a group of one) must be a new tensor
        return tuple(u.clone() if any(u is x for x in xs) else u
                     for u in uniq)

    @staticmethod
    def backward(ctx, *gs):
        _, bwd, index, out_index = ctx.plan
        got = bwd({p: gs[i] for p, i in out_index.items()})
        grads: list = [None] * ctx.n_in
        for p, i in index.items():
            grads[i] = got[p] if grads[i] is None else grads[i] + got[p]
        return (None, *grads)


def _exchange(vals: dict, fwd, bwd) -> dict:
    uniq, index = _distinct(vals)
    out_index: dict = {}
    outs = _Exchange.apply((fwd, bwd, index, out_index), *uniq)
    return {p: outs[i] for p, i in out_index.items()}


def _reduction(kind, vals, axes, mesh, combine) -> dict:
    """A reduction whose backward is the same reduction of the results'
    cotangents, each distinct result once (``lax.psum``'s transpose on
    values replicated over ``axes``)."""
    return _exchange(
        vals, lambda v: _collective(kind, v, axes, mesh, combine),
        lambda g: _collective(kind, g, axes, mesh, combine, distinct=True))


def psum(vals, axes, mesh) -> dict:
    """``lax.psum`` over ``axes``; its backward is a psum of the
    cotangents."""
    return _reduction("all-reduce", vals, axes, mesh, _sum)


def pmax(vals, axes, mesh) -> dict:
    """``lax.pmax`` over ``axes`` (on values that carry no gradient)."""
    return _collective("all-reduce", vals, axes, mesh, _max)


def pmean(vals, axes, mesh) -> dict:
    """``lax.pmean``: the sum over ``axes`` over the group's size."""
    n = axis_size(mesh, axes)
    return _reduction("all-reduce", vals, axes, mesh,
                      lambda xs: _sum(xs) / n)


def all_gather(vals, axes, mesh, dim: int = 0) -> dict:
    """``lax.all_gather(..., tiled=True)``: the group's values in rank
    order, concatenated along ``dim``.  Its backward is a reduce-scatter
    of the cotangents, each distinct result once (FSDP's gradient)."""
    size = next(iter(vals.values())).shape[dim]
    n = axis_size(mesh, axes)

    def bwd(g):
        return _collective("reduce-scatter", g, axes, mesh, _sum,
                           scatter=(dim, size), distinct=True)
    # a lone mesh's group has one member: its value stands for each rank's
    return _exchange(vals, lambda v: _collective(
        "all-gather", v, axes, mesh,
        lambda xs: torch.cat(xs * (n // len(xs)), dim)), bwd)


def relayout(vals: dict, src, dst, mesh) -> dict:
    """Per-position blocks of one global tensor laid out by ``src`` → its
    blocks under ``dst``: a dim split over other axes in ``src`` is
    all-gathered over them first (``all_gather``), then each position
    slices its own part of each dim ``dst`` splits.  What the
    partitioner inserts between two layouts, as gathers and local
    slices."""
    src, dst = canonical(src), canonical(dst)
    ndim = next(iter(vals.values())).ndim
    entry = lambda spec, d: axes_of(spec[d] if d < len(spec) else None)
    for d in range(ndim):
        a, b = entry(src, d), entry(dst, d)
        if a and a != b and axis_size(mesh, a) > 1:
            vals = all_gather(vals, a, mesh, dim=d)
    out = {}
    for pos, x in vals.items():
        for d in range(ndim):
            a, b = entry(src, d), entry(dst, d)
            k = axis_size(mesh, b)
            if b and b != a and k > 1:
                n = x.shape[d] // k
                x = x.narrow(d, axis_index(mesh, pos, b) * n, n)
        out[pos] = x
    return out


def token_mean(num, den, axes, mesh) -> dict:
    """The reference's mean over every valid token of a batch split over
    ``axes``: Σ num / max(Σ den, 1), one all-reduce of the (num, den)
    pairs; not a mean of the shards' means.  ``num``/``den``: per-shard
    0-d float32 tensors."""
    pairs = per_shard(mesh, lambda p: torch.stack([num[p], den[p]]))
    if axis_size(mesh, axes) > 1:
        pairs = psum(pairs, axes, mesh)
    return {p: t[0] / torch.clamp(t[1], min=1.0) for p, t in pairs.items()}
