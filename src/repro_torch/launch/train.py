"""End-to-end trainer: data pipeline → train step → async checkpoints (the
port of ``repro.launch.train``, plus ``--device``).

Runs on the card by default, and on the CPU at smoke size:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --smoke --device cpu --steps 6 --seq 32 --batch 2 --ckpt-dir /tmp/ck

Fault tolerance, as the reference's:
  * an async checkpoint every --ckpt-every steps (atomic commit),
  * SIGTERM/SIGINT (preemption) takes a final checkpoint before exit,
  * --resume restores the parameters, the optimizer and the step, and the
    counted data pipeline continues from that step: the same batches as
    an uninterrupted run.
A JSON record of the metrics goes to stdout (and ``--log``) every 10 steps
and at the last; its ``sec`` is the host clock since the previous record.

``--mesh D,M`` trains over a ("data", "model") mesh under ``TRAIN_RULES``
(every family, with the extras ``data.extra_inputs`` makes): the state is
initialised (or restored) on the device and then laid out on the mesh,
and each step runs under the mesh's shard context.  The mesh covers
``cuda:0 ..`` and raises with fewer cards than positions; with ``--device
cpu`` every position is on the CPU, and ``train(args, mesh_devices=...)``
lays the positions on any devices, one card several times:

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \\
        --smoke --device cpu --mesh 2,2 --steps 3 --seq 32 --batch 2
"""
from __future__ import annotations

import argparse
import json
import math
import signal
import sys
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data import DataConfig, TokenPipeline, extra_inputs
from repro_torch.device import resolve_device
from repro_torch.launch.elastic import state_shardings
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.steps import (
    TrainState, init_train_state, make_train_step,
)
from repro_torch.sharding import TRAIN_RULES, device_put, shard_ctx


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None, help="e.g. 2,4 → (data, model)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap.parse_args(argv)


def train(args: argparse.Namespace, mesh_devices=None) -> TrainState:
    """The training loop of ``main``; returns the final state.
    ``mesh_devices``: the devices of ``--mesh``'s positions, row-major
    (default: the CPU for each with ``--device cpu``, else ``cuda:0 ..``)."""
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    device = resolve_device(args.device)
    mesh = None
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        if mesh_devices is None and device.type == "cpu":
            mesh_devices = ["cpu"] * math.prod(shape)
        mesh = make_mesh(shape, ("data", "model")[:len(shape)], mesh_devices)
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                    global_batch=args.batch, seed=args.seed))
    train_step, (opt_init, _) = make_train_step(cfg, lr=args.lr)
    state = init_train_state(args.seed, cfg, opt_init, device=device)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state, manifest = ckpt.restore(state)
        print(f"resumed from step {manifest['step']}", flush=True)
    if mesh is not None:
        state = device_put(state, state_shardings(cfg, mesh)[0])
        step_fn = train_step

        def train_step(st, batch):
            with shard_ctx(TRAIN_RULES, mesh):
                return step_fn(st, batch)

    stop = {"flag": False}

    def _on_signal(sig, frame):
        print(f"signal {sig}: checkpoint + exit", flush=True)
        stop["flag"] = True

    handlers = {s: signal.signal(s, _on_signal)
                for s in (signal.SIGTERM, signal.SIGINT)}
    logf = open(args.log, "a") if args.log else None
    try:
        t_prev = time.time()
        for step in range(state.step, args.steps):
            batch = {k: torch.from_numpy(v).to(device) for k, v in
                     extra_inputs(cfg, data.batch(step)).items()}
            state, metrics = train_step(state, batch)
            if stop["flag"]:
                break
            if step % 10 == 0 or step == args.steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t_prev
                t_prev = time.time()
                rec = {"step": step + 1, **m, "sec": round(dt, 3)}
                print(json.dumps(rec), flush=True)
                if logf:
                    logf.write(json.dumps(rec) + "\n")
                    logf.flush()
            if ckpt and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step + 1, state)
        if ckpt:
            ckpt.save(state.step, state, blocking=True)
            print(f"checkpointed step {state.step}", flush=True)
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)
        if logf:
            logf.close()
    return state


def main(argv=None) -> int:
    train(parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
