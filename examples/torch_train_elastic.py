"""Fault-tolerant training with an elastic re-mesh on the PyTorch port, as
``examples/train_elastic.py`` does: the control plane's scaling action
applied to a training job.

  1. train a reduced MoE model with periodic async checkpoints;
  2. simulate a preemption (the job dies mid-run);
  3. the allocator's ``ReMesh`` action restores the checkpoint onto a mesh
     (``--remesh D,M``, default 1 x 1; its positions laid on the one
     device, which may repeat) and training continues, the counted data
     pipeline replaying the same batches.

The resumed run's batches and losses are held equal, bitwise, to those of
a run that was never interrupted: the same steps, its state moved onto the
same mesh in memory at the preemption step.

Run on the card:  PYTHONPATH=src python examples/torch_train_elastic.py
On the CPU:       PYTHONPATH=src python examples/torch_train_elastic.py \\
                      --device cpu
"""
import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.elastic import (
    ReMesh, elastic_restore, state_shardings,
)
from repro_torch.models.steps import init_train_state, make_train_step
from repro_torch.sharding import TRAIN_RULES, device_put, shard_ctx

PREEMPT_AT, RESUMED, LR = 8, 4, 1e-3


def pipeline(cfg):
    return TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=4, seed=7))


def batch_at(data, step, dev):
    return {k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in data.batch(step).items()}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--remesh", default="1,1", metavar="D,M",
                    help="the mesh the job resumes on (data, model)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint root (default: a new temporary "
                         "directory)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    data_axis, model_axis = (int(x) for x in args.remesh.split(","))
    cfg = get_smoke_config("olmoe-1b-7b")       # a MoE: the richest state
    root = Path(args.ckpt_dir or tempfile.mkdtemp()) / "ckpt"
    data = pipeline(cfg)

    print(f"[phase 1] training {cfg.name} ({cfg.n_params() / 1e6:.1f}M "
          f"params) on {dev}")
    train_step, (opt_init, _) = make_train_step(cfg, lr=LR)
    state = init_train_state(0, cfg, opt_init, device=dev)
    mgr = CheckpointManager(root)
    for step in range(PREEMPT_AT):
        state, metrics = train_step(state, batch_at(data, step, dev))
        loss = float(metrics["loss"])
        if (step + 1) % 4 == 0:
            mgr.save(step + 1, state)           # async: training continues
            print(f"  step {step + 1}: loss={loss:.4f} [checkpoint queued]")
        else:
            print(f"  step {step + 1}: loss={loss:.4f}")
    mgr.wait()
    del state
    print(f"[phase 2] PREEMPTION at step {PREEMPT_AT}: process gone; latest "
          f"checkpoint: step {mgr.latest_step()}")

    action = ReMesh(data_axis=data_axis, model_axis=model_axis)
    print(f"[phase 3] allocator emits ReMesh(data={data_axis}, "
          f"model={model_axis}): elastic restore")
    devices = [dev] * (data_axis * model_axis)
    state2, step_fn, mesh = elastic_restore(root, cfg, action, lr=LR,
                                            devices=devices)
    resume_step = int(state2.step)
    print(f"  restored onto mesh "
          f"{dict(zip(mesh.axis_names, mesh.devices.shape))} at step "
          f"{resume_step}")
    resumed, batches = [], []
    for step in range(resume_step, resume_step + RESUMED):
        batch = batch_at(data, step, dev)
        batches.append(batch["tokens"].cpu())
        state2, metrics = step_fn(state2, batch)
        resumed.append(float(metrics["loss"]))
        print(f"  step {step + 1}: loss={resumed[-1]:.4f} (resumed)")

    # the run that was never interrupted, over a fresh pipeline: the same
    # steps, the state moved onto the new mesh in memory at the preemption
    # step (no checkpoint, no restore)
    fresh = pipeline(cfg)
    straight = init_train_state(0, cfg, opt_init, device=dev)
    want = []
    for step in range(resume_step + RESUMED):
        b = batch_at(fresh, step, dev)
        if step < resume_step:
            straight, _ = train_step(straight, b)
            continue
        if step == resume_step:
            straight = device_put(straight, state_shardings(cfg, mesh)[0])
        assert torch.equal(b["tokens"].cpu(), batches[step - resume_step])
        with shard_ctx(TRAIN_RULES, mesh):
            straight, m = train_step(straight, b)
        want.append(float(m["loss"]))
    print(f"  uninterrupted run's losses {[f'{x:.4f}' for x in want]}")
    if resumed != want:
        print("FAIL: the resumed losses differ from the uninterrupted run's "
              f"(max gap {max(abs(a - b) for a, b in zip(resumed, want))})")
        return 1
    print("\ntrain_elastic complete: checkpoint → preemption → re-mesh → "
          "the same batches and losses as an uninterrupted run.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
