"""Dry-run: count and time the port's own programs, one cell at a time
(the counterpart of ``repro.launch.dryrun``).

The reference lowers each (arch × shape × mesh) cell on the production
mesh, (16, 16) ("data", "model") for ``single`` and (2, 16, 16) ("pod",
"data", "model") for ``multi``, and reads XLA's per-device cost of the
compiled program.  Here a mesh cell counts one **lone position** of that
mesh (``sharding.shard_map.LoneMesh``; by default the first, ``--position``
another): the full mesh's axis sizes and the position's own indices, only
its blocks of the weights, optimizer state, cache and inputs, each drawn
on the device from SEED and the leaf's name at the block's shape (the
whole leaf is never built), and each collective a stand-in of its
result's shape that records ``(kind, result bytes, group size)`` as the
whole mesh's run does.  The step is the port's own partition: the train
step over ``TRAIN_RULES`` (``train_4k``, with ``cfg.remat``), the prefill
and decode steps over laid-out weights under ``serve_rules(global_batch)``
(every family; a decode cell draws each leaf of the family's cache at its
block, a prefill cell its tokens and the family's patches or frames).
So a record's FLOPs, bytes, transcendentals and collective bytes are one
device's, as the reference's are; ``step_s`` is the position's compute
alone (``"step_s_excludes_wire": true``: no collective crosses a wire),
and the values are not the model's (``"lone_position"``: its check is the
output's shape and finiteness).  ``--mesh-shape`` overrides the mesh, as
in the reference.

``--mesh card`` is one card's share of a cell instead (``…__card.json``): the batch ``max(1, global_batch // 16)`` at the cell's
``seq_len`` on one device, no mesh — ``decode_32k`` is 8 rows over a
32768-token ring (a sliding-window model's ring is its window), every
row's index at ``seq_len - 1``; ``prefill_32k`` 2 prompts of 32768
tokens; weights in the compute dtype, as the reference's serve cells
stream bf16 weights; ``train_4k`` has no card cell.

Each cell runs once under ``launch.cost.CostCounter`` (which also warms it
up), then ``reps`` more runs are timed (CUDA events on the card, the host
clock on the CPU), with the kernels' launches in the counted step and the
peak device memory.  A record has the reference's keys (``arch``,
``shape``, ``mesh``, ``chips``, ``cost``, ``memory``,
``collective_bytes``, ``collective_detail``, per device) and the
measurement's own: ``device`` (name and power limit), ``replica_batch``
(the rows one device holds), ``step_s`` (the median) and ``step_s_runs``,
``launches``, ``kernel_regions`` (each kernel's counted cost), a mesh
cell's ``collective_sizes`` (each distinct collective's kind, result
bytes, group, count and wire bytes) and ``scan_flops_counted: true`` —
the eager count sees every scan step, so ``sim.roofline_db`` adds no SSM
correction.  A cell that fails (one whose
lone position does not fit on the card among them) leaves
``<cell>.FAILED`` with its traceback.

Refused by name: ``--probe`` (the reference fits a per-layer count because
XLA counts a ``lax.scan`` body once; an eager count is already per layer),
and ``train_4k`` on ``card``: named, the CLI refuses; under ``--arch all``
it is skipped with the reason printed.

Usage (resumable: a cell whose JSON exists is skipped unless ``--force``):
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --mesh both \\
      --shape decode_32k,prefill_32k,train_4k --out results/torch_dryrun
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b --mesh single \\
      --mesh-shape 2,4 --device cpu --shape decode_32k
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import time
import traceback
import zlib
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.cost import (
    CostCounter, collective_bytes, cost_summary, memory_summary,
)
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.models import LM, SHAPES, ShapeCfg, applicable_shapes
from repro_torch.models.steps import (
    TrainState, cache_specs, cache_structs, input_sharding_axes,
    make_decode_step, make_prefill_step, make_train_step, model_inputs,
    param_axes_and_structs,
)
from repro_torch.optim import AdamWState
from repro_torch.sharding import (
    TRAIN_RULES, serve_rules, shard_ctx, spec_for,
)
from repro_torch.sharding import shard_map as sm

DATA_AXIS = 16          # the reference's production mesh: 16 data x 16 model
SEED = 0                # of the random weights and the inputs
PROBE_REFUSED = ("--probe is refused: the reference fits a per-layer count "
                 "because XLA counts a lax.scan body once; the port's eager "
                 "count already sees every layer and every scan step")


def smoke_shape(shape) -> ShapeCfg:
    """A cell cut for ``--smoke``: its sequence / 512 (at least 8) and its
    batch / 8 (at least 1), the kind kept."""
    return ShapeCfg(shape.name, max(8, shape.seq_len // 512),
                    max(1, shape.global_batch // 8), shape.kind)


def smoke_config(arch: str):
    """``arch``'s smoke config under the arch's own name."""
    return dataclasses.replace(get_smoke_config(arch), name=arch)


def replica_batch(shape) -> int:
    """One card's share of a cell's global batch."""
    return max(1, shape.global_batch // DATA_AXIS)


def serve_config(cfg):
    """The config with its weights held in the compute dtype."""
    return dataclasses.replace(cfg, param_dtype=cfg.dtype)


def build_cell(cfg, shape, device="cuda", *, params=None):
    """(params, step, args) of one card's share of a cell: ``step(*args)``
    runs it.  ``params`` (an ``LM`` on ``device``) is drawn from SEED in
    the compute dtype unless given; inputs come from numpy at SEED."""
    if shape.kind not in ("prefill", "decode"):
        raise ValueError(f"{shape.name}: one card's share runs prefill and "
                         f"decode cells only (train_4k counts a position "
                         f"of the production mesh)")
    dev = resolve_device(device)
    if params is None:
        params = LM(serve_config(cfg), device=dev, seed=SEED)
    B = replica_batch(shape)
    rng = np.random.default_rng(SEED)
    if shape.kind == "prefill":
        batch = {}
        for name, (shp, dtype) in model_inputs(cfg, B, shape.seq_len,
                                               with_labels=False).items():
            batch[name] = (torch.from_numpy(rng.integers(
                0, cfg.vocab, shp, dtype=np.int32)).to(dev)
                if name == "tokens" else torch.zeros(shp, dtype=dtype,
                                                     device=dev))
        return params, make_prefill_step(cfg, max_seq=shape.seq_len), (
            params, batch)
    cache = LM.init_cache(cfg, B, shape.seq_len, device=dev)
    cache["index"] = torch.full((B,), shape.seq_len - 1, dtype=torch.int32,
                                device=dev)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1),
                                           dtype=np.int32)).to(dev)
    return params, make_decode_step(cfg), (params, tokens, cache)


# ------------------------------------------------------- a lone position


def production_mesh(tag: str, device, shape=None):
    """The reference's mesh of ``tag`` ("single" or "multi"), or ``shape``
    over its axes ("single": ("data", "model")[:len(shape)]), every
    position naming ``device``."""
    multi = tag == "multi"
    if shape is None:
        return make_production_mesh(multi_pod=multi,
                                    devices=[device] * (512 if multi
                                                        else 256))
    axes = ("pod", "data", "model") if multi else ("data", "model")
    return make_mesh(shape, axes[:len(shape)],
                     devices=[device] * math.prod(shape))


def _generator(name: str, dev: torch.device) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(
        SEED * 1_000_003 + zlib.crc32(name.encode()))


def draw_block(name: str, shape, spec, mesh, dtype, *, fill: str = "normal",
               std: float = 1.0, ints=(0, 1)):
    """The lone position's block of a leaf of global ``shape`` under
    ``spec``, drawn on its device from SEED and ``name`` at the block's
    shape: ``fill`` "normal" (× ``std``), "ones", "zeros" or "ints" in
    [``ints[0]``, ``ints[1]``) → a ``ShardedArray`` holding that one
    block."""
    pos = mesh.position
    dev = mesh.devices[pos]
    block = tuple(s.stop - s.start for s in sm._block_slices(
        tuple(shape), sm.canonical(spec), mesh, pos))
    if fill == "ints":
        blk = torch.randint(*ints, block, generator=_generator(name, dev),
                            device=dev, dtype=torch.int32)
    elif fill == "normal":
        blk = torch.randn(block, generator=_generator(name, dev), device=dev,
                          dtype=torch.float32).mul_(std).to(dtype)
    else:
        blk = (torch.ones if fill == "ones" else torch.zeros)(
            block, device=dev, dtype=dtype)
    return sm.ShardedArray({pos: blk}, spec, mesh, shape, dtype)


def _param_fill(name: str, shape) -> dict:
    """How a weight is drawn: norm scales and Mamba's D ones, biases
    zeros, the embedding table at std 0.02, every other leaf at 1/sqrt
    of its input dim."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf in ("scale", "D"):
        return {"fill": "ones"}
    if leaf in ("b", "bias", "dt_bias"):
        return {"fill": "zeros"}
    if name == "embed.table":
        return {"std": 0.02}
    return {"std": (shape[-2] if len(shape) >= 2 else 1) ** -0.5}


def lone_params(cfg, mesh, rules, dtype=None) -> dict:
    """{parameter name: the lone position's block} of every leaf, laid
    out by ``spec_for`` under ``rules``, in ``dtype`` (default the
    config's param dtype)."""
    axes, structs = param_axes_and_structs(cfg)
    return {k: draw_block(k, s.shape, spec_for(axes[k], rules, mesh,
                                                s.shape), mesh,
                          dtype or s.dtype, **_param_fill(k, s.shape))
            for k, s in structs.items()}


def _own_ids(cfg, mesh, rules) -> tuple[int, int]:
    """The token ids whose embedding rows the lone position holds: its
    range of the vocabulary.  The lone run's ids are drawn there: an id
    outside it embeds to zeros at this position (the other ranks' rows
    come in by the psum, which a lone position stands in for), and a row
    of zeros through the RMS norms makes a deep backward overflow."""
    V = cfg.vocab
    axes = sm.axes_of((spec_for(("vocab", "embed"), rules, mesh,
                                (V, cfg.d_model)) or (None,))[0])
    V_loc = V // sm.axis_size(mesh, axes)
    lo = sm.axis_index(mesh, mesh.position, axes) * V_loc
    return lo, lo + V_loc


def _lone_inputs(cfg, shape, mesh, rules, *, with_labels: bool) -> dict:
    """The lone position's blocks of a train or prefill cell's inputs."""
    axes = input_sharding_axes(cfg, with_labels=with_labels)
    ids = _own_ids(cfg, mesh, rules)
    out = {}
    for name, (shp, dtype) in model_inputs(
            cfg, shape.global_batch, shape.seq_len,
            with_labels=with_labels).items():
        spec = spec_for(axes[name], rules, mesh, shp)
        out[name] = (draw_block(name, shp, spec, mesh, dtype, fill="ints",
                                ints=ids)
                     if dtype == torch.int32 else
                     draw_block(name, shp, spec, mesh, dtype))
    return out


def build_lone_cell(cfg, shape, mesh):
    """(state or weights, step, args, rules) of a cell at the lone
    position ``mesh`` (a ``LoneMesh``): ``step(*args)`` runs it under
    ``shard_ctx(rules, mesh)``."""
    if shape.kind == "train":
        rules = TRAIN_RULES
        params = lone_params(cfg, mesh, rules)
        zeros = lambda a: sm.ShardedArray(
            {p: torch.zeros_like(b, dtype=torch.float32)
             for p, b in a.blocks.items()}, a.spec, mesh, a.shape,
            torch.float32)
        state = TrainState(params, AdamWState(
            0, {k: zeros(a) for k, a in params.items()},
            {k: zeros(a) for k, a in params.items()}), 0)
        step, _ = make_train_step(cfg)
        return state, step, (state, _lone_inputs(
            cfg, shape, mesh, rules, with_labels=True)), rules
    rules = serve_rules(shape.global_batch)
    params = lone_params(cfg, mesh, rules, cfg.cdtype)
    if shape.kind == "prefill":
        return params, make_prefill_step(cfg, max_seq=shape.seq_len), (
            params, _lone_inputs(cfg, shape, mesh, rules,
                                 with_labels=False)), rules
    B, S = shape.global_batch, shape.seq_len
    structs = cache_structs(cfg, B, S)
    first = mesh.devices[mesh.position]

    def draw(name, struct, spec):
        if isinstance(struct, dict):
            return {k: draw(f"{name}.{k}", struct[k], spec[k])
                    for k in struct}
        if name == "cache.cross_len":   # every row's encoder length: S
            return draw_block(name, struct.shape, spec, mesh, struct.dtype,
                              fill="ints", ints=(S, S + 1))
        return draw_block(name, struct.shape, spec, mesh, struct.dtype)
    specs = cache_specs(cfg, structs, rules, mesh)
    cache = {"index": torch.tensor(S - 1, dtype=torch.int32, device=first),
             **{k: draw(f"cache.{k}", v, specs[k])
                for k, v in structs.items() if k != "index"}}
    tok_spec = spec_for(("batch", "seq"), rules, mesh, (B, 1))
    tokens = draw_block("tokens", (B, 1), tok_spec, mesh, torch.int32,
                        fill="ints", ints=_own_ids(cfg, mesh, rules))
    return params, make_decode_step(cfg), (params, tokens, cache), rules


def _blocks(tree) -> list:
    """The tensors of a tree, a ``ShardedArray``'s blocks among them."""
    if isinstance(tree, sm.ShardedArray):
        return list(tree.blocks.values())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _blocks(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _blocks(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


# -------------------------------------------------------------- measuring


def device_info(dev: torch.device) -> dict:
    """The card's name and power limit (nvidia-smi), or the CPU's name."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    limit = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        if out.returncode == 0:
            limit = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return {"name": torch.cuda.get_device_name(dev), "power_limit": limit}


def _timed(step, args, dev, reps: int, ctx=None) -> list[float]:
    ctx = ctx or (lambda: contextlib.nullcontext())
    if dev.type != "cuda":
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            with ctx():
                step(*args)
            runs.append(time.perf_counter() - t0)
        return runs
    events = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        with ctx():
            step(*args)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize(dev)
    return [a.elapsed_time(b) / 1e3 for a, b in events]


def _check_out(cfg, shape, out, what, rows):
    """The counted step's output: logits (rows, 1, vocab), or a train
    step's metrics, all finite."""
    if shape.kind == "train":
        bad = {k: float(v) for k, v in out[1].items()
               if not bool(torch.isfinite(v).all())}
        if bad:
            raise RuntimeError(f"{what}: metrics not finite: {bad}")
        return
    logits = out[0]
    if (tuple(logits.shape) != (rows, 1, cfg.vocab)
            or not bool(torch.isfinite(logits).all())):
        raise RuntimeError(f"{what}: logits of shape {tuple(logits.shape)}, "
                           f"finite {bool(torch.isfinite(logits).all())}")


def analyze_cell(cfg, shape, device="cuda", *, reps: int = 3,
                 params=None) -> dict:
    """One card's share of a cell (``--mesh card``): count one step, time
    ``reps`` more, and return its record.  Raises unless the counted
    step's logits are finite and of shape (batch, 1, vocab)."""
    dev = resolve_device(device)
    params, step, args = build_cell(cfg, shape, dev, params=params)
    B = replica_batch(shape)
    before = ops.launch_counts()
    with CostCounter() as counter:
        out = step(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {k: n - before[k] for k, n in ops.launch_counts().items()
                if n != before[k]}
    _check_out(cfg, shape, out, f"{cfg.name} {shape.name}", B)
    del out
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    runs = _timed(step, args, dev, reps)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    cache = args[2] if shape.kind == "decode" else None
    inputs = args[1]
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": [1, 1],
        "chips": 1,
        "cost": cost_summary(counter),
        "memory": memory_summary(params, cache, inputs, peak),
        "collective_bytes": 0.0,
        "collective_detail": {},
        "device": device_info(dev),
        "replica_batch": B,
        "step_s": statistics.median(runs) if runs else None,
        "step_s_runs": runs,
        "launches": launches,
        "kernel_regions": counter.kernels,
        "scan_flops_counted": True,
    }


def analyze_mesh_cell(cfg, shape, mesh, device="cuda", *, position=None,
                      reps: int = 3) -> dict:
    """One lone position of ``mesh`` (by default its first) for a cell:
    build its blocks, count one step under ``CostCounter``, time ``reps``
    more, and return its record, per device.
    Raises unless the counted step's output has its shape and is
    finite."""
    dev = resolve_device(device)
    position = tuple(position or (0,) * mesh.devices.ndim)
    lone = sm.LoneMesh(make_mesh(mesh.devices.shape, mesh.axis_names,
                                 devices=[dev] * mesh.size), position)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    state, step, args, rules = build_lone_cell(cfg, shape, lone)
    ctx = lambda: shard_ctx(rules, lone)
    counter = CostCounter()
    before = ops.launch_counts()
    with ctx(), counter:
        out = step(*args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {k: n - before[k] for k, n in ops.launch_counts().items()
                if n != before[k]}
    _check_out(cfg, shape, out, f"{cfg.name} {shape.name} at {position}",
               shape.global_batch)
    del out
    runs = _timed(step, args, dev, reps, ctx)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None
    wire, detail = collective_bytes(counter)
    tok_spec = spec_for(("batch", "seq"), rules, lone,
                        (shape.global_batch, 1))
    rows = shape.global_batch // sm.axis_size(
        lone, tok_spec[0] if tok_spec else None)
    args_bytes = sum(t.untyped_storage().nbytes() for t in {
        (t.untyped_storage().data_ptr(), t.device): t
        for t in _blocks(args)}.values())
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": list(mesh.devices.shape),
        "chips": int(mesh.devices.size),
        "cost": cost_summary(counter),
        "memory": {"argument_size_in_bytes": int(args_bytes),
                   "temp_size_in_bytes": int(max(0, peak - args_bytes))
                   if peak is not None else 0},
        "collective_bytes": wire,
        "collective_detail": detail,
        "collective_sizes": collective_sizes(counter),
        "device": device_info(dev),
        "lone_position": list(position),
        "replica_batch": rows,
        "step_s": statistics.median(runs) if runs else None,
        "step_s_runs": runs,
        "step_s_excludes_wire": True,
        "peak_bytes": peak,
        "launches": launches,
        "kernel_regions": counter.kernels,
        "scan_flops_counted": True,
    }


def collective_sizes(counter) -> list:
    """[kind, result bytes, group size, count, wire bytes] of each distinct
    collective a run recorded, the most wire bytes first: where a step's
    wire bytes come from."""
    seen: dict = {}
    for rec in counter.collectives:
        seen[rec] = seen.get(rec, 0) + 1
    rows = [[k, b, n, c, collective_bytes([(k, b, n)])[0] * c]
            for (k, b, n), c in seen.items()]
    return sorted(rows, key=lambda r: -r[4])


def cell_path(outdir, arch: str, shape_name: str, tag: str = "card") -> Path:
    return Path(outdir) / f"{arch}__{shape_name}__{tag}.json"


def refused(shape_name: str, tag: str) -> str | None:
    """Why the port runs no such cell, or None."""
    kind = SHAPES[shape_name].kind
    if tag == "card" and kind == "train":
        return ("train_4k has no one-card share: it counts a position of "
                "the production mesh (--mesh single or multi)")
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both", "card"])
    ap.add_argument("--mesh-shape", default=None,
                    help="override the mesh, e.g. 2,4 (single) or 2,2,2 "
                         "(multi)")
    ap.add_argument("--position", default=None,
                    help="the lone mesh position counted, e.g. 0,3 "
                         "(default: the first)")
    ap.add_argument("--probe", action="store_true",
                    help="refused: an eager count is already per layer")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs, each cell's sequence / 512 "
                         "and batch / 8 (a run on the CPU)")
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.probe:
        ap.error(PROBE_REFUSED)
    named = [] if args.shape == "all" else args.shape.split(",")
    for name in named:
        if name not in SHAPES:
            ap.error(f"--shape {name}: unknown (one of {sorted(SHAPES)})")
    tags = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])
    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    config = smoke_config if args.smoke else get_config
    cell = smoke_shape if args.smoke else (lambda shape: shape)
    if args.arch != "all":          # a cell named outright: refused here
        for arch, name, t in ((a, n, t) for a in archs for n in named
                              for t in tags):
            why = refused(name, t)
            if why is not None:
                ap.error(f"{arch} {name} on --mesh {t} is refused: {why}")
    dev = resolve_device(args.device)
    override = (tuple(int(x) for x in args.mesh_shape.split(","))
                if args.mesh_shape else None)
    meshes = {t: production_mesh(t, dev, override if (
        args.mesh != "both" or t == "single") else None)
        for t in tags if t != "card"}
    position = (tuple(int(x) for x in args.position.split(","))
                if args.position else None)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    n_ok = n_fail = n_skip = n_refused = 0
    for arch in archs:
        cfg = config(arch)
        shapes = [s for s in applicable_shapes(cfg)
                  if not named or s in named]
        params = None
        for shape_name in shapes:
            for tag in tags:
                cell_id = f"{arch}__{shape_name}__{tag}"
                why = refused(shape_name, tag)
                if why is not None:
                    print(f"=== {cell_id} === refused: {why}", flush=True)
                    n_refused += 1
                    continue
                if (cell_path(outdir, arch, shape_name, tag).exists()
                        and not args.force):
                    n_skip += 1
                    continue
                print(f"=== {cell_id} ===", flush=True)
                try:
                    if tag == "card":
                        if params is None:
                            params = LM(serve_config(cfg), device=dev,
                                        seed=SEED)
                        rec = analyze_cell(cfg, cell(SHAPES[shape_name]), dev,
                                           reps=args.reps, params=params)
                    else:
                        rec = analyze_mesh_cell(
                            cfg, cell(SHAPES[shape_name]), meshes[tag], dev,
                            position=position, reps=args.reps)
                    cell_path(outdir, arch, shape_name, tag).write_text(
                        json.dumps(rec, indent=1))
                    print(f"  ok: step {rec['step_s']:.4f} s "
                          f"flops={rec['cost']['flops']:.3e} "
                          f"bytes={rec['cost']['bytes']:.3e} "
                          f"coll={rec['collective_bytes']:.3e}B "
                          f"launches={rec['launches']}", flush=True)
                    n_ok += 1
                except Exception:
                    n_fail += 1
                    err = traceback.format_exc()
                    (outdir / f"{cell_id}.FAILED").write_text(err)
                    print(f"  FAILED:\n{err}", flush=True)
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(f"done: ok={n_ok} fail={n_fail} skip={n_skip} "
          f"refused={n_refused}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
