"""Closed-loop autoscaling on the PyTorch port: the control plane drives a
real multi-replica data plane, as ``examples/serve_autoscale.py`` does.

The loop lives in ``repro_torch/serving/closed_loop.py``: a
``ReplicaRouter`` over the port's ``ServingEngine``s (qwen2.5-3b by
default; continuous slot batching, chunked prefill, per-slot ring
positions), Poisson arrivals on a calm → spike → calm profile, per-replica
reports into the ``MetricsCollector``, the ``AnomalyDetector`` watching
load, and the ``PredictiveAllocator``'s scaling decisions actuated through
``router.scale_to``: replicas appear and drain mid-run.

The run log shows, per tick: load, completions, p50/p95 latency, per-replica
slot utilization and the realized replica count with the decision's
reason.  Exits 1 if the scaler never changed the replica count.

Run on the card:  PYTHONPATH=src python examples/torch_serve_autoscale.py
On the CPU:       PYTHONPATH=src python examples/torch_serve_autoscale.py \\
                      --smoke --device cpu
"""
import argparse
import dataclasses
import sys

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.serving.closed_loop import LoopConfig, run_closed_loop
from repro_torch.serving.router import TOPOLOGIES


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-fast)")
    ap.add_argument("--ticks", type=int, default=14)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engines and the allocator's DQN run")
    ap.add_argument("--topology", choices=TOPOLOGIES, default="inproc",
                    help="replica backend: in-process engines, one engine "
                         "sharded over a mesh, worker subprocesses behind "
                         "the socket transport, TCP workers the router "
                         "dials, or multi-process pods (N worker ranks "
                         "behind one head)")
    ap.add_argument("--workers", default=None, metavar="HOST:PORT,...",
                    help="tcp/pod topology: comma-separated addresses of "
                         "pre-started workers (tcp: python -m "
                         "repro_torch.serving.worker --listen host:port; "
                         "pod: the pod heads) to attach to; omitted, local "
                         "workers are spawned on kernel-picked ports")
    ap.add_argument("--pod-size", type=int, default=2,
                    help="pod topology: worker ranks per replica")
    args = ap.parse_args(argv)
    if args.workers and args.topology not in ("tcp", "pod"):
        ap.error("--workers only applies to --topology tcp/pod")
    dev = resolve_device(args.device)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    print(f"engine: {cfg.name} {cfg.n_params() / 1e6:.1f}M params on "
          f"{dev}, router starts at 1 {args.topology} replica")
    addrs = tuple(args.workers.split(",")) if args.workers else ()
    lc = dataclasses.replace(LoopConfig(), topology=args.topology,
                             addrs=addrs, pod_size=args.pod_size)
    router, logs = run_closed_loop(cfg, autoscale=True, ticks=args.ticks,
                                   seed=args.seed, lc=lc, device=dev)
    for t in logs:
        util = " ".join(f"r{rid}={u:.2f}" for rid, u in t.replica_util)
        flag = " [ANOMALY]" if t.anomaly else ""
        if t.evicted:
            flag += f" [EVICTED r{','.join(map(str, t.evicted))}]"
        print(f"tick {t.tick:2d}: rps={t.rps_target:4.1f} "
              f"arrivals={t.arrivals:2d} served={t.served:2d} "
              f"p50={t.latency_p50_ms:6.0f}ms p95={t.latency_p95_ms:6.0f}ms "
              f"queue={t.queue_depth:4.1f} slot_util[{util}] "
              f"-> {t.replicas} replicas ({t.reason}){flag}")

    m = router.metrics()
    router.close()
    transport = (f", transport={m['transport_ms']:.2f}ms"
                 if m["transport_ms"] else "")
    print(f"\nfleet totals: {m['completed']} requests, "
          f"{m['completed_tokens']} tokens, p50={m['latency_p50_ms']:.0f}ms "
          f"p95={m['latency_p95_ms']:.0f}ms, "
          f"throughput={m['throughput_tok_s']:.1f} tok/s (virtual)"
          f"{transport}")
    trajectory = [1] + [t.replicas for t in logs]
    if len(set(trajectory)) == 1:
        print("FAIL: the scaler never changed the replica count")
        return 1
    print(f"replica trajectory: {trajectory} — the control plane scaled "
          f"the real data plane mid-run.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
