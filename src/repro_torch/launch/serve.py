"""Serving CLI over ``repro_torch.serving`` (the port of
``repro.launch.serve``, plus ``--device``).

Reports throughput, per-request latency (p50/p95) and slot utilization,
plus the engine's tick, admission and host-logits counts.  Runs on the card
by default:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-3b \\
        --slots 8 --max-seq 1024 --prompt-len 200

and on the CPU at smoke size with ``--smoke --device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.serving import SamplingParams, ServingEngine, synthetic_requests
from repro_torch.sim.serving import WorkloadSpec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=None,
                    help="stream prompts through the decode tick in chunks")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--arrival-rps", type=float, default=100.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    eng = ServingEngine(cfg, slots=args.slots, max_seq=args.max_seq,
                        seed=args.seed, prefill_chunk=args.prefill_chunk,
                        device=args.device)
    rng = np.random.default_rng(args.seed)
    arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_rps,
                                         args.requests))
    spec = WorkloadSpec(prompt_len=args.prompt_len, gen_len=args.gen_len)
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              seed=args.seed)
    requests = synthetic_requests(spec, args.requests, cfg.vocab, rng=rng,
                                  sampling=sampling)

    t0 = time.time()
    submitted = 0
    finished: list = []
    while len(finished) < args.requests:
        now = time.time() - t0
        while submitted < args.requests and arrivals[submitted] <= now:
            eng.submit(requests[submitted], now=arrivals[submitted])
            submitted += 1
        if eng.idle:
            time.sleep(0.001)
            continue
        finished.extend(eng.step(now=time.time() - t0))
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)

    total = time.time() - t0
    lats = np.array(sorted(r.latency_s for r in finished))
    toks = sum(len(r.tokens_out) for r in finished)
    print(f"device={eng.device.type} requests={args.requests} "
          f"gen_tokens={toks} wall={total:.2f}s "
          f"throughput={toks / total:.1f} tok/s")
    print(f"latency p50={np.percentile(lats, 50) * 1e3:.0f}ms "
          f"p95={np.percentile(lats, 95) * 1e3:.0f}ms "
          f"slot_util={eng.stats.slot_utilization:.2f}")
    print(f"ticks={eng.stats.total_ticks} "
          f"admissions={eng.stats.total_admitted} logits_pulls={eng.logits_pulls} finished={len(finished)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
