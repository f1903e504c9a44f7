"""The port's closed control loop against the JAX package's, on the CPU.

``run_closed_loop`` on both sides with the same seed, at bridged weights:
the reference's LM goes into the port's replicas through ``params=`` and
the reference agent's initial DNN through ``prime_allocator``.  Over the
``LoopConfig``s of the reference's own loop tests (the default planner,
``alloc_mode`` hybrid and rl, live DQN train steps, a batch tier, a spot
market over reserved capacity, regions, the paged pool with speculation,
and a scripted straggler evicted through ``chaos_hook``):

- every ``TickLog`` field equal exactly, but ``learn_loss``, held to 1e-4;
- every per-tick training record (``recorder``: the collector aggregate,
  the actuated decision, costs, spot price, fleet counters) equal;
- the token streams equal, request for request;
- where the loop trains the DQN, its parameters and BatchNorm state held
  as ``test_torch_dnn`` holds them for one deployment: 1e-4, but the
  elements whose gradient rounding noise decides, held to Adam's step bound.

Then what the card run relies on: the replica trajectory does not depend
on the model's width (no decision reads a token's value), only on the
vocabulary the arrivals draw their prompts from.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.dnn.traces import TraceRecorder
from repro.core.monitoring.collector import ReplicaReport as RefReport
from repro.serving.closed_loop import LoopConfig as RefLoopConfig
from repro.serving.closed_loop import TickLog as RefTickLog
from repro.serving.closed_loop import default_profile as ref_default_profile
from repro.serving.closed_loop import run_closed_loop as ref_run
from repro.serving.engine import EngineCore as RefEngineCore
from repro.sim.serving import WorkloadSpec as RefWorkloadSpec

from repro_torch.configs import get_smoke_config
from repro_torch.core.monitoring.collector import ReplicaReport
from repro_torch.models.bridge import from_reference
from repro_torch.serving.closed_loop import (
    LoopConfig, TickLog, default_profile, run_closed_loop,
)
from repro_torch.sim.serving import WorkloadSpec

from test_torch_dnn import assert_agents_close

ARCH = "qwen2.5-3b"
LOSS_TOL = 1e-4
SMALL = dict(slots=2, max_replicas=2, max_seq=32, prefill_chunk=4,
             steps_per_tick=6)
LEARN = dict(warmup=2, train_every=1, batch_size=2)

# name → (LoopConfig kwargs, ticks, (prompt_len, gen_len) or None for the
# default spec, live DQN train steps, scripted straggler)
CASES = {
    "planner": ({}, 14, None, False, False),
    "hybrid": ({"max_replicas": 2, "alloc_mode": "hybrid"}, 6, (8, 4),
               False, False),
    "rl": ({"max_replicas": 2, "alloc_mode": "rl"}, 6, (8, 4), False,
           False),
    "learn": ({"max_replicas": 2}, 6, (8, 4), True, False),
    "learn_hybrid": ({"max_replicas": 3, "alloc_mode": "hybrid"}, 8, (8, 4),
                     True, False),
    "tiers": ({**SMALL, "batch_frac": 0.5}, 5, (6, 3), False, False),
    "spot": ({**SMALL, "batch_frac": 0.5, "reserved_replicas": 1,
              "spot_market": True}, 6, (6, 3), False, False),
    "regions": ({**SMALL, "reserved_replicas": 1, "regions": ("na", "apac"),
                 "spot_market": True}, 6, None, False, False),
    "regions_reserved": ({**SMALL, "reserved_replicas": 2,
                          "regions": ("na", "apac"), "spot_market": True},
                         8, None, False, False),
    "paged_spec": ({"pool": "paged", "spec_k": 3}, 14, None, False, False),
    "eviction": ({**SMALL, "max_replicas": 3}, 8, None, False, True),
}


@functools.lru_cache(maxsize=None)
def ref_lm(max_seq):
    core = RefEngineCore(ref_smoke_config(ARCH), max_seq, seed=0)
    return jax.tree.map(np.asarray, core.params)


def straggler_hook(report_cls, ticks, k):
    """The reference benchmark's scripted straggler: for k consecutive
    windows one live replica reports 5 s latencies, the rest 100 ms."""
    q = max(ticks // 4, 1)
    straggle = set(range(q, q + k))

    def hook(tick, router, collector):
        live = sorted(r.replica_id for r in router.serving_replicas)
        if tick not in straggle or len(live) < 2:
            return
        for rid, lat in [(live[0], 5000.0)] + [(r, 100.0)
                                               for r in live[1:]]:
            collector.submit(report_cls(
                replica_id=rid, tick=tick, latency_ms_samples=[lat] * 4,
                n_requests=4, n_errors=0, flop_util=0.5, hbm_util=0.5,
                ici_util=0.0, mem_frac=0.5, queue_depth=0))
    return hook


def run_pair(name):
    """Both loops on one case → (ref logs, port logs, ref sink, port sink,
    {"ref": allocator, "port": allocator}, (ref records, port records))."""
    kw, ticks, spec, learn, chaos = CASES[name]
    ref_lc, lc = RefLoopConfig(**kw), LoopConfig(**kw)
    ref_kw, port_kw = {}, {}
    if spec is not None:
        ref_kw["spec"], port_kw["spec"] = (RefWorkloadSpec(*spec),
                                           WorkloadSpec(*spec))
    if chaos:
        ref_kw["chaos_hook"] = straggler_hook(RefReport, ticks,
                                              ref_lc.evict_after)
        port_kw["chaos_hook"] = straggler_hook(ReplicaReport, ticks,
                                               lc.evict_after)
    allocs, initial = {}, {}

    def ref_prime(alloc):
        # keep the reference agent's initial DNN for the port's agent
        allocs["ref"] = alloc
        initial["params"] = jax.tree.map(np.asarray, alloc.agent.params)
        initial["bn"] = jax.tree.map(np.asarray, alloc.agent.bn_state)
        if learn:
            alloc.agent.cfg = dataclasses.replace(alloc.agent.cfg, **LEARN)

    def port_prime(alloc):
        allocs["port"] = alloc
        alloc.agent.load_reference(initial["params"], initial["bn"])
        if learn:
            alloc.agent.cfg = dataclasses.replace(alloc.agent.cfg, **LEARN)

    want_sink, got_sink = [], []
    ref_rec, port_rec = TraceRecorder(), TraceRecorder()
    ref_router, want = ref_run(ref_smoke_config(ARCH), ticks=ticks, seed=0,
                               lc=ref_lc, sink=want_sink, recorder=ref_rec,
                               prime_allocator=ref_prime, **ref_kw)
    ref_router.close()
    cfg = get_smoke_config(ARCH)
    router, got = run_closed_loop(
        cfg, ticks=ticks, seed=0, lc=lc, sink=got_sink, recorder=port_rec,
        prime_allocator=port_prime,
        params=from_reference(ref_lm(lc.max_seq), cfg, device="cpu"),
        device="cpu", **port_kw)
    router.close()
    return (want, got, want_sink, got_sink, allocs,
            (ref_rec.records, port_rec.records))


@pytest.mark.parametrize("name", list(CASES))
def test_closed_loop_equals_reference(name):
    want, got, want_sink, got_sink, allocs, records = run_pair(name)
    assert len(got) == len(want) == CASES[name][1]
    assert records[1] == records[0]
    for a, b in zip(want, got):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        la, lb = da.pop("learn_loss"), db.pop("learn_loss")
        assert db == da, f"tick {a.tick}"
        assert (la is None) == (lb is None), f"tick {a.tick}"
        if la is not None:
            assert abs(la - lb) <= LOSS_TOL, (a.tick, la, lb)
    streams = lambda sink: {r.rid: list(r.tokens_out) for r in sink}
    assert streams(got_sink) == streams(want_sink)
    assert got_sink, "the loop served nothing"
    steps = sum(t.learn_loss is not None for t in got)
    if CASES[name][3]:
        assert steps > 0, "the live learning loop took no train step"
        ref_agent, port_agent = allocs["ref"].agent, allocs["port"].agent
        assert_agents_close(ref_agent, port_agent, steps,
                            port_agent.cfg.lr,
                            deploy=allocs["port"].deploy_vec[None])
    if name == "planner":
        # the trajectory the card run is held to: 1 → 3 → 4 → 1
        reps = [t.replicas for t in got]
        assert reps[0] == 1 and max(reps) == 4 and reps[-1] == 1
    if name == "eviction":
        assert any(t.evicted for t in got)


def test_loop_config_and_tick_log_mirror_reference():
    fields = lambda cls: [(f.name, f.default) for f in dataclasses.fields(
        cls)]
    assert fields(LoopConfig) == fields(RefLoopConfig)
    assert [f.name for f in dataclasses.fields(TickLog)] == \
        [f.name for f in dataclasses.fields(RefTickLog)]
    lc = LoopConfig()
    for ticks in (7, 14, 30):
        assert [default_profile(t, ticks, lc) for t in range(ticks)] == \
            [ref_default_profile(t, ticks, lc) for t in range(ticks)]


def trajectory(logs):
    return [{k: v for k, v in dataclasses.asdict(t).items()
             if k != "learn_loss"} for t in logs]


@pytest.mark.parametrize("vocab", [128, 151936])
def test_trajectory_does_not_depend_on_width(vocab):
    """In planner mode no decision reads a token's value: the smoke config
    and one twice as wide (and deep) give the same TickLogs when they share
    a vocabulary, which the arrivals draw their prompts from."""
    base = get_smoke_config(ARCH, vocab=vocab)
    wide = dataclasses.replace(base, d_model=64, n_layers=3, d_ff=128)
    runs = []
    for cfg in (base, wide):
        router, logs = run_closed_loop(cfg, ticks=14, seed=0,
                                       device="cpu")
        router.close()
        runs.append(trajectory(logs))
    assert runs[0] == runs[1]
    assert len({t["replicas"] for t in runs[0]}) > 1


@pytest.mark.parametrize("pool,spec_k", [("dense", 0), ("paged", 3)])
def test_engine_step_counters_match_the_steps_run(pool, spec_k, monkeypatch):
    """``fused_ticks`` and ``verify_lanes``, summed over every engine the
    router built (parked ones too), equal the fused steps and verify lanes
    the shared core ran: the card run's launch-count checks are computed
    from them."""
    from repro_torch.serving import router as router_mod
    calls = {"fused": 0, "lanes": 0}

    class CountedCore(router_mod.EngineCore):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            fused, verify = self.fused_decode, self.verify

            def fused_counted(*a):
                calls["fused"] += 1
                return fused(*a)

            def verify_counted(params, tokens, cache):
                calls["lanes"] += tokens.shape[1]
                return verify(params, tokens, cache)

            self.fused_decode, self.verify = fused_counted, verify_counted

    monkeypatch.setattr(router_mod, "EngineCore", CountedCore)
    router, logs = run_closed_loop(
        get_smoke_config(ARCH), ticks=14, seed=0,
        lc=LoopConfig(pool=pool, spec_k=spec_k), device="cpu")
    engines = [rep.engine for rep in router.all_replicas]
    router.close()
    assert len(engines) == max(t.replicas for t in logs) == 4
    assert sum(e.fused_ticks for e in engines) == calls["fused"] > 0
    assert sum(e.verify_lanes for e in engines) == calls["lanes"]
    assert (calls["lanes"] > 0) == (spec_k > 0)
