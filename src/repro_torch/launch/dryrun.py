"""One-card dry-run: count and time the port's own serve programs, one
cell at a time (the counterpart of ``repro.launch.dryrun``).

The reference lowers each (arch × shape × mesh) cell on a 16 × 16
(data × model) production mesh and reads XLA's compiled cost.  One port
replica is one card, so a cell here is one card's share of the reference's:
the batch ``max(1, global_batch // 16)`` at the cell's ``seq_len`` —
``decode_32k`` is 8 rows over a 32768-token ring (a sliding-window model's
ring is its window), every row's index at ``seq_len - 1`` so that decode
attention reads the whole live ring; ``prefill_32k`` is 2 prompts of 32768
tokens.  Weights are built in the compute dtype, as the reference's serve
cells stream bf16 weights, and the steps are the port's own
``make_decode_step`` and ``make_prefill_step``.

``analyze_cell`` runs the step once under ``launch.cost.CostCounter``
(which also warms it up), then times ``reps`` more runs (CUDA events on the
card, the host clock on the CPU), and records the kernels' launches in one
step and the peak device memory.  Its record has the reference's keys
(``arch``, ``shape``, ``mesh`` [1, 1], ``chips`` 1, ``cost``, ``memory``,
``collective_bytes`` 0.0, ``collective_detail`` {}) and the measurement's
own: ``device`` (name and power limit), ``replica_batch``, ``step_s`` (the
median) and ``step_s_runs``, ``launches``, ``kernel_regions`` (each
kernel's counted cost) and ``scan_flops_counted: true`` — the eager count
sees every scan step, so ``sim.roofline_db`` adds no SSM correction.

Refused by name: ``--probe`` (the reference fits a per-layer count because
XLA counts a ``lax.scan`` body once; an eager count is already per layer),
the ``train_4k`` cell (one card's share of 16 × 4096 tokens does not fit
beside the float32 state) and ``--mesh multi`` (the multi-device slice).

Usage (resumable: a cell whose JSON exists is skipped unless ``--force``):
  python -m repro_torch.launch.dryrun --arch qwen2.5-3b \\
      --shape decode_32k,prefill_32k --out results/torch_dryrun
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.cost import CostCounter, cost_summary, memory_summary
from repro_torch.models import LM, SHAPES, applicable_shapes
from repro_torch.models.steps import (
    make_decode_step, make_prefill_step, model_inputs,
)

DATA_AXIS = 16          # the reference's production mesh: 16 data x 16 model
SEED = 0                # of the random weights and the inputs
REFUSED_SHAPES = {
    "train_4k": "one card's share of train_4k (16 x 4096 tokens) does not "
                "fit beside the float32 weights, gradients and moments"}
PROBE_REFUSED = ("--probe is refused: the reference fits a per-layer count "
                 "because XLA counts a lax.scan body once; the port's eager "
                 "count already sees every layer and every scan step")
MULTI_REFUSED = "--mesh multi is refused: multi-device meshes are not ported"


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
        raise ValueError(f"{shape.name}: {REFUSED_SHAPES.get(shape.name, '')}"
                         f" (only prefill and decode cells run here)")
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


def _timed(step, args, dev, reps: int) -> list[float]:
    if dev.type != "cuda":
        runs = []
        for _ in range(reps):
            t0 = time.perf_counter()
            step(*args)
            runs.append(time.perf_counter() - t0)
        return runs
    events = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        step(*args)
        e1.record()
        events.append((e0, e1))
    torch.cuda.synchronize(dev)
    return [a.elapsed_time(b) / 1e3 for a, b in events]


def analyze_cell(cfg, shape, device="cuda", *, reps: int = 3,
                 params=None) -> dict:
    """Count one step of the cell, time ``reps`` more, and return its
    record.  Raises unless the counted step's logits are finite and of
    shape (batch, 1, vocab)."""
    dev = resolve_device(device)
    params, step, args = build_cell(cfg, shape, dev, params=params)
    B = replica_batch(shape)
    before = ops.launch_counts()
    with CostCounter() as counter:
        logits = step(*args)[0]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    launches = {k: n - before[k] for k, n in ops.launch_counts().items()
                if n != before[k]}
    if (tuple(logits.shape) != (B, 1, cfg.vocab)
            or not bool(torch.isfinite(logits).all())):
        raise RuntimeError(f"{cfg.name} {shape.name}: logits of shape "
                           f"{tuple(logits.shape)}, finite "
                           f"{bool(torch.isfinite(logits).all())}")
    del logits
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


def cell_path(outdir, arch: str, shape_name: str) -> Path:
    return Path(outdir) / f"{arch}__{shape_name}__single.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--probe", action="store_true",
                    help="refused: an eager count is already per layer")
    ap.add_argument("--out", default="results/torch_dryrun")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    if args.probe:
        ap.error(PROBE_REFUSED)
    if args.mesh == "multi":
        ap.error(MULTI_REFUSED)
    named = [] if args.shape == "all" else args.shape.split(",")
    for name in named:
        if name in REFUSED_SHAPES:
            ap.error(f"--shape {name} is refused: {REFUSED_SHAPES[name]}")
        if name not in SHAPES:
            ap.error(f"--shape {name}: unknown (one of {sorted(SHAPES)})")
    dev = resolve_device(args.device)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    n_ok = n_fail = n_skip = 0
    for arch in archs:
        cfg = get_config(arch)
        shapes = [s for s in applicable_shapes(cfg)
                  if s not in REFUSED_SHAPES and (not named or s in named)]
        todo = [s for s in shapes
                if args.force or not cell_path(outdir, arch, s).exists()]
        n_skip += len(shapes) - len(todo)
        params = None
        for shape_name in todo:
            cell_id = f"{arch}__{shape_name}__single"
            print(f"=== {cell_id} ===", flush=True)
            try:
                if params is None:
                    params = LM(serve_config(cfg), device=dev, seed=SEED)
                rec = analyze_cell(cfg, SHAPES[shape_name], dev,
                                   reps=args.reps, params=params)
                cell_path(outdir, arch, shape_name).write_text(
                    json.dumps(rec, indent=1))
                print(f"  ok: step {rec['step_s']:.4f} s "
                      f"flops={rec['cost']['flops']:.3e} "
                      f"bytes={rec['cost']['bytes']:.3e} "
                      f"launches={rec['launches']}", flush=True)
                n_ok += 1
            except Exception:
                n_fail += 1
                err = traceback.format_exc()
                (outdir / f"{cell_id}.FAILED").write_text(err)
                print(f"  FAILED:\n{err}", flush=True)
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    print(f"done: ok={n_ok} fail={n_fail} skip={n_skip}")
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
