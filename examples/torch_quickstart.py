"""Quickstart on the PyTorch port: the three layers of the framework in one
script, step for step as ``examples/quickstart.py``.

  1. data plane  — build the reduced qwen2.5-3b, run 3 train steps and a
                   prefill → decode round trip;
  2. kernels     — the hand-written prefill attention kernel (K4,
                   ``ops.flash_attention``) against its plain version, on
                   the card;
  3. control     — the control plane makes scaling decisions and one
                   deployment-strategy selection against the roofline
                   profile of h2o-danube-1.8b, read from the port's own
                   dry-run cells (``results/torch_dryrun/…__card.json``,
                   written first by ``repro_torch.launch.dryrun`` when
                   absent).

Run on the card:  PYTHONPATH=src python examples/torch_quickstart.py
On the CPU:       PYTHONPATH=src python examples/torch_quickstart.py \\
                      --device cpu --smoke
(``--smoke``: the dry-run cells of the smoke config, cut as ``dryrun
--smoke`` cuts them, in ``results/torch_dryrun_smoke/``.)
"""
import argparse
import sys
from pathlib import Path

import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.steps import init_train_state, make_train_step

CELLS_ARCH = "h2o-danube-1.8b"
CELL_SHAPES = ("decode_32k", "prefill_32k")


def model_phase(dev):
    cfg = get_smoke_config("qwen2.5-3b")
    print(f"\n[1] {cfg.name}: {cfg.n_layers}L d={cfg.d_model} "
          f"heads={cfg.n_heads}/{cfg.n_kv_heads} "
          f"({cfg.n_params() / 1e6:.1f}M params)")
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(0, cfg.vocab, (2, 32), generator=g,
                           dtype=torch.int32).to(dev)
    batch = {"tokens": tokens, "labels": tokens}
    train_step, (opt_init, _) = make_train_step(cfg, lr=1e-3)
    state = init_train_state(0, cfg, opt_init, device=dev)
    losses = []
    for i in range(3):
        state, metrics = train_step(state, batch)
        losses.append(float(metrics["loss"]))
        print(f"    train step {i}: loss={losses[-1]:.4f}")
    model = state.params
    with torch.no_grad():
        logits, cache = model.prefill({"tokens": tokens}, max_seq=40)
        tok = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
        for _ in range(4):
            logits, cache = model.decode(tok, cache)
            tok = logits[:, 0].argmax(-1).to(torch.int32)[:, None]
    index = int(cache["index"])
    print(f"    prefill+decode ok, cache index = {index}")
    return losses, index


def kernel_phase(dev):
    """K4 against its plain version at the reference's shapes; ``None`` on
    the CPU, where the wrapper would run the plain version itself."""
    if dev.type != "cuda":
        print("\n[2] hand-written flash attention: needs a card "
              "(run with --device cuda)")
        return None
    from repro_torch.kernels import ops, ref
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(shape, generator=g).to(dev) for shape in (
        (1, 128, 8, 64), (1, 128, 4, 64), (1, 128, 4, 64)))
    out = ops.flash_attention(q, k, v, causal=True)
    err = float((out - ref.flash_attention_ref(q, k, v, causal=True))
                .abs().max())
    print(f"\n[2] CUDA flash attention (K4) vs its plain version: max err "
          f"{err:.2e}")
    return err


def ensure_cells(cells: Path, dev, smoke: bool):
    """Write the danube ``card`` cells the profile reads, where absent."""
    missing = [s for s in CELL_SHAPES
               if not (cells / f"{CELLS_ARCH}__{s}__card.json").exists()]
    if not missing:
        return
    from repro_torch.launch import dryrun
    argv = ["--arch", CELLS_ARCH, "--mesh", "card", "--shape",
            ",".join(missing), "--out", str(cells), "--device", dev.type]
    if smoke:
        argv.append("--smoke")
    print(f"    writing {', '.join(missing)} cells of {CELLS_ARCH} into "
          f"{cells}")
    if dryrun.main(argv) != 0:
        raise RuntimeError(f"the dry-run of {CELLS_ARCH} failed")


def control_phase(dev, cells: Path, smoke: bool):
    from repro_torch.core.allocation.allocator import (
        AllocatorConfig, PredictiveAllocator,
    )
    from repro_torch.core.dnn.features import deploy_vector
    from repro_torch.core.orchestration.selector import (
        DecisionTreeSelector, DeploymentContext,
    )
    from repro_torch.core.scaling.scaler import ScalingConstraints
    from repro_torch.sim import (
        RooflineDB, ServiceProfile, ServingModel, WorkloadSpec,
    )
    ensure_cells(cells, dev, smoke)
    profile = ServiceProfile.from_db(RooflineDB(cells), CELLS_ARCH)
    model = ServingModel(profile, WorkloadSpec(prompt_len=256, gen_len=12),
                         slo_ms=200.0)
    print(f"\n[3] roofline profile: decode step "
          f"{profile.decode_step_s * 1e3:.1f} ms/token, bottleneck "
          f"{profile.bottleneck} (from the dry-run cells)")
    alloc = PredictiveAllocator(
        model.latency_util, ScalingConstraints(slo_ms=200.0),
        deploy_vector(model_params_b=1.8, family="dense", mesh_model=16,
                      mesh_data=16, region_idx=0, slo_ms=200,
                      cost_weight=0.5),
        cfg=AllocatorConfig(mode="planner"), device=dev)
    decisions = []
    for rps in (20.0, 40.0, 80.0, 160.0):
        alloc.observe({"rps": rps})
        d = alloc.decide({"rps": rps, "rps_window": [rps]})
        alloc.apply(d)
        decisions.append(d.target_replicas)
        print(f"    load {rps:5.0f} rps -> {d.target_replicas:2d} replicas "
              f"(pred p95 {d.predicted_latency_ms:.0f} ms, {d.reason})")
    strategy = DecisionTreeSelector().select(DeploymentContext(
        model_params_b=3, traffic_rps=500, slo_ms=200, error_budget=0.0005,
        spare_capacity_frac=0.15, cost_sensitivity=0.5, is_critical=True))
    print(f"    deployment strategy for this context: {strategy}")
    return decisions, strategy


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke config's dry-run cells (CPU-fast)")
    ap.add_argument("--cells", default=None,
                    help="the dry-run cells' directory (default "
                         "results/torch_dryrun, or results/"
                         "torch_dryrun_smoke with --smoke)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cells = Path(args.cells or ("results/torch_dryrun_smoke" if args.smoke
                                else "results/torch_dryrun"))
    print("assigned architectures:", ", ".join(ARCH_IDS))
    losses, index = model_phase(dev)
    err = kernel_phase(dev)
    decisions, strategy = control_phase(dev, cells, args.smoke)
    print("\nquickstart complete.")
    return {"losses": losses, "index": index, "kernel_err": err,
            "replicas": decisions, "strategy": strategy}


if __name__ == "__main__":
    main()
    sys.exit(0)
