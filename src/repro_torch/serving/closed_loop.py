"""The closed control loop as one reusable function
(``repro.serving.closed_loop``, line for line over the port's router,
collector, scaler and allocator).

The reference's demo (examples/serve_autoscale.py) and benchmark
(benchmarks/serving_latency.py --engine) run exactly its
``run_closed_loop``; ``chip_smoke.py`` runs this one on the card.

Each control tick: Poisson arrivals spread uniformly over the tick enter the
router only once the virtual clock passes their arrival time (submitting
early would let a request be served before it "arrived", biasing latency
low); the router runs ``steps_per_tick`` decode rounds; per-replica reports
feed the MetricsCollector; the EvictionPolicy turns the collector's
straggler feed into actuated ``router.evict_stragglers`` calls (a replica
flagged ``evict_after`` consecutive windows is evicted and replaced — the
loop doesn't just *compute* the straggler feed, it closes it); and — when
``autoscale`` — the PredictiveAllocator's decision is actuated via
router.scale_to.

Every engine and the allocator's DQN run on ``device`` (cuda unless the
caller asks for cpu).  Only the in-process topology is ported: the others,
``observe_addrs`` (read-only attaches to remote workers), and ``addrs``,
``pod_size`` or ``batch_submits`` set away from their defaults raise
``NotImplementedError`` by name.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from repro_torch.core.allocation.allocator import (
    AllocatorConfig, PredictiveAllocator,
)
from repro_torch.core.dnn.features import deploy_vector
from repro_torch.core.monitoring.anomaly import AnomalyDetector
from repro_torch.core.monitoring.collector import MetricsCollector
from repro_torch.core.scaling.scaler import EvictionPolicy, ScalingConstraints
from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.workload import synthetic_requests
from repro_torch.sim.serving import WorkloadSpec


@dataclasses.dataclass(frozen=True)
class LoopConfig:
    slots: int = 4
    max_replicas: int = 4
    max_seq: int = 48
    prefill_chunk: int = 8
    steps_per_tick: int = 10     # decode rounds per control tick
    tick_s: float = 0.1          # virtual seconds per decode round
    slo_ms: float = 2000.0
    calm_rps: float = 1.2
    spike_rps: float = 7.0
    topology: str = "inproc"     # inproc | sharded | proc | tcp | pod
    addrs: tuple = ()            # tcp/pod: pre-started pods to attach to
    pod_size: int = 2            # pod: worker ranks per replica
    batch_submits: bool = True   # proc/tcp/pod: submits ride the step RPC
    #                              (these three: not ported yet, must keep
    #                              their defaults)
    evict_after: int = 3         # consecutive straggler windows → evict
    #                              (0 disables loop-actuated eviction)
    observe_addrs: tuple = ()    # read-only MetricsObserver attaches polled
    #                              each tick (not ported yet: must be empty)
    pool: str = "dense"          # replica KV layout: dense | paged
    block_size: int | None = None   # paged: tokens per physical block
    num_blocks: int | None = None   # paged: physical blocks per replica
    spec_k: int = 0              # speculative decode: draft tokens per tick
    #                              (0 disables; streams are bit-identical)
    spec_ngram: int = 3          # prompt-lookup n-gram order for drafting
    alloc_mode: str = "planner"  # allocator: planner | rl | hybrid — hybrid
    #                              runs the (pretrained) DQN as the scaler
    #                              inside the planner's safety envelope
    learn: bool = True           # feed each tick's realized outcome back
    #                              into alloc.learn (reward credited to the
    #                              previous tick's action) when autoscaling
    batch_frac: float = 0.0      # fraction of arrivals on the batch tier
    #                              (0 keeps the workload single-tier and the
    #                              run bit-identical to the pre-tier loop)
    slo_batch_ms: float = 8000.0    # batch lane's (lenient) latency SLO
    batch_gate_frac: float = 0.9    # gate batch at this frac of the
    #                              interactive SLO (scaler hysteresis)
    reserved_replicas: int = 0   # >0 → heterogeneous fleet: this many
    #                              on-demand replica ids, every id past
    #                              them preemptible (FleetPlan)
    cost_on_demand: float = 1.0  # cost/tick of a reserved replica
    cost_preemptible: float = 0.35  # cost/tick of a spot replica
    rps_window: int = 8          # ticks of rps history published to the
    #                              scaler's burstiness analysis
    regions: tuple = ()          # region per replica id, cycled (FleetPlan
    #                              geography); () keeps the fleet
    #                              region-less and the run bit-identical
    #                              to the pre-region loop
    home_region: str = ""        # traffic origin: every arrival is tagged
    #                              with it (and the RTT matrix is measured
    #                              from it); "" = regions[0] when regioned
    region_aware: bool = True    # False routes region-BLIND while keeping
    #                              the injected RTT — the geo ablation's
    #                              control arm
    spot_market: bool = False    # price spot capacity by a seeded
    #                              SpotMarket process (mean-reverting walk
    #                              around cost_preemptible with spikes)
    #                              instead of a constant


@dataclasses.dataclass
class TickLog:
    tick: int
    rps_target: float
    arrivals: int
    served: int
    latency_p50_ms: float
    latency_p95_ms: float
    queue_depth: float
    replica_util: list          # [(replica_id, slot_util)] this window
    replicas: int               # realized count after actuation
    reason: str
    anomaly: bool
    evicted: list = dataclasses.field(default_factory=list)  # replica ids
    #                             the eviction policy actuated this tick
    observed: list = dataclasses.field(default_factory=list)  # one status()
    #                             per observe_addrs attach (empty here: the
    #                             attaches are not ported; out-of-band
    #                             lifetime counters, pod rank/mode)
    learn_loss: float | None = None   # DQN train-step loss, when the live
    #                             learning loop took one this tick
    batch_gated: bool = False    # batch lane gated during this tick's
    #                             scaling window (SLO protection)
    cost_per_tick: float = 0.0   # realized fleet spend for the window
    preemptions: int = 0         # lifetime spot reclaims absorbed so far
    region_spills: int = 0       # lifetime interactive cross-region routes


def default_profile(tick: int, ticks: int, lc: LoopConfig) -> float:
    """calm → spike → calm (requests per virtual second)."""
    lo, hi = ticks * 2 // 7, ticks * 9 // 14
    return lc.spike_rps if lo <= tick < hi else lc.calm_rps


def run_closed_loop(cfg, *, autoscale: bool = True, ticks: int = 14,
                    seed: int = 0, lc: LoopConfig = LoopConfig(),
                    spec: WorkloadSpec = WorkloadSpec(prompt_len=16,
                                                      gen_len=8),
                    profile=default_profile, sink: list | None = None,
                    recorder=None, chaos_hook=None, prime_allocator=None,
                    params=None, device="cuda"):
    """→ (router, [TickLog]).  ``autoscale=False`` pins one replica (the
    static baseline).  ``lc.topology`` picks the replica backend — the loop
    is transport-agnostic, so inproc / sharded / proc / tcp / pod runs on
    the same seed produce the same token streams and the same scaling
    trajectory.  ``sink``, when given, accumulates every completed Request
    (the cross-topology equivalence tests compare these).  Callers running
    the proc/tcp/pod topologies should ``router.close()`` when done (worker
    teardown).

    ``recorder`` (any object with ``record(dict)``, such as
    ``core/dnn/traces.TraceRecorder``) captures one training record per
    tick: the collector aggregate plus the actuated decision,
    realized cost, anomaly/eviction counters, and the fleet's paged-pool
    prefix counters — replayable offline into StreamBuilder/ReplayBuffer
    datasets.  ``chaos_hook(tick, router, collector)`` runs after reports
    land and before eviction/scaling — fault scripts (straggler injection,
    worker kills) see exactly what the control plane sees.
    ``prime_allocator(alloc)`` runs once before the first tick — the hook
    offline-trained policies use to warm-start the live allocator.

    ``params`` (a prepared ``LM``, for example the reference's weights
    through ``models.bridge``) goes to the replicas' shared EngineCore;
    ``device`` places the engines and the allocator's DQN."""
    if lc.observe_addrs:
        raise NotImplementedError(
            "observe_addrs is not ported yet: read-only attaches to remote "
            "workers wait for D2 (the socket replicas)")
    plan = None
    if lc.reserved_replicas > 0:
        from repro_torch.serving.profiles import FleetPlan, SpotMarket
        market = (SpotMarket(seed=seed, base=lc.cost_preemptible)
                  if lc.spot_market else None)
        plan = FleetPlan(reserved=lc.reserved_replicas,
                         cost_on_demand=lc.cost_on_demand,
                         cost_preemptible=lc.cost_preemptible,
                         regions=tuple(lc.regions),
                         home_region=lc.home_region, market=market)
    router = ReplicaRouter.from_topology(
        cfg, lc.topology, slots=lc.slots, max_seq=lc.max_seq, seed=seed,
        prefill_chunk=lc.prefill_chunk, n_replicas=1,
        max_replicas=lc.max_replicas, addrs=list(lc.addrs),
        pod_size=lc.pod_size, batch_submits=lc.batch_submits,
        pool=lc.pool, block_size=lc.block_size, num_blocks=lc.num_blocks,
        spec_k=lc.spec_k, spec_ngram=lc.spec_ngram, profile_fn=plan,
        region_aware=lc.region_aware, params=params, device=device)
    # the region arrivals originate from: tagged onto every request below
    # so the router can prefer in-region capacity
    origin = plan.origin if plan is not None else lc.home_region
    rng = np.random.default_rng(seed)
    evictor = (EvictionPolicy(k_windows=lc.evict_after)
               if lc.evict_after > 0 else None)

    # virtual-clock service time: streamed prompt tail + generation.  The
    # tail clamps at 0 — a prefill chunk >= the prompt swallows the whole
    # prompt in one shot; without the clamp the capacity model's service
    # time went NEGATIVE, inverting the planner (capacity < 0, util pinned
    # at 1.0, predicted latency negative → never scale up under a spike)
    service_s = (max(spec.prompt_len - lc.prefill_chunk, 0)
                 + spec.gen_len + 1) * lc.tick_s

    def perf_model(replicas, rps):
        """(latency_ms, util) — capacity model over the engine's own slot
        arithmetic; the planner scales so predicted latency meets the SLO."""
        cap = max(replicas, 1) * lc.slots / service_s
        util = min(rps / max(cap, 1e-9), 1.0)
        lat = service_s * (1.0 + 3.0 * max(util - 0.8, 0.0) / 0.2)
        return lat * 1e3, util

    collector = MetricsCollector()
    anomaly = AnomalyDetector(z_threshold=3.0, min_history=4)
    alloc = PredictiveAllocator(
        perf_model,
        ScalingConstraints(min_replicas=1, max_replicas=lc.max_replicas,
                           slo_ms=lc.slo_ms, slo_batch_ms=lc.slo_batch_ms,
                           batch_gate_frac=lc.batch_gate_frac),
        deploy_vector(model_params_b=cfg.n_params() / 1e9, family=cfg.family,
                      mesh_model=1, mesh_data=1, region_idx=0,
                      slo_ms=lc.slo_ms, cost_weight=0.5),
        cfg=AllocatorConfig(mode=lc.alloc_mode), seed=seed, device=device)
    if plan is not None:
        # the profile-AWARE planner: scale-up past the reserved pool is
        # priced at the spot rate, so batch headroom is bought cheap —
        # exactly the aware-vs-blind delta BENCH_tiers measures
        alloc.scaler.optimizer.cost_fn = plan.cost_of
    if prime_allocator is not None:
        prime_allocator(alloc)

    now, next_rid = 0.0, 0
    logs: list[TickLog] = []
    # rolling multi-tick rps history: publishing a single-sample window
    # made analyze_current_load's std/peak degenerate (std == 0, peak ==
    # mean), so burstiness never reached the planner
    rps_hist: deque[float] = deque(maxlen=max(int(lc.rps_window), 1))
    tick_span = lc.steps_per_tick * lc.tick_s
    try:
        for tick in range(ticks):
            rps = profile(tick, ticks, lc)
            n = int(rng.poisson(rps * tick_span))
            reqs = synthetic_requests(spec, n, cfg.vocab, rng=rng,
                                      base_rid=next_rid)
            next_rid += n
            if origin:
                for r in reqs:
                    r.region = origin
            if lc.batch_frac > 0.0:
                # tier draw only when the workload is actually mixed: a
                # single-tier run must consume the same rng stream as a
                # pre-tier one (bit-identical logs on a fixed seed)
                is_batch = rng.random(n) < lc.batch_frac
                for r, b in zip(reqs, is_batch):
                    if b:
                        r.tier = "batch"
            # deque: the old list.pop(0) drain was O(n²) per tick at high
            # rps (every pop shifted the whole remaining tail)
            arrivals = deque((now + (i / max(n, 1)) * tick_span, r)
                             for i, r in enumerate(reqs))
            served = 0
            for _ in range(lc.steps_per_tick):
                now += lc.tick_s
                while arrivals and arrivals[0][0] <= now:
                    t_arr, r = arrivals.popleft()
                    router.submit(r, now=t_arr)
                done = router.step(now)
                served += len(done)
                if sink is not None:
                    sink.extend(done)

            reports = router.reports(tick)
            for rep in reports:
                collector.submit(rep)
            if chaos_hook is not None:
                # fault scripts run on the control plane's view of the tick:
                # injected straggler evidence lands before the eviction
                # policy's window, scripted kills before the scaling decision
                chaos_hook(tick, router, collector)
            # close the straggler loop: flagged K consecutive windows → the
            # replica is evicted and replaced (its work requeues through the
            # survivors), BEFORE this tick's scaling decision sees the fleet
            evicted: list[int] = []
            if evictor is not None:
                evicted = router.evict_stragglers(
                    evictor.update(collector.stragglers(),
                                   router.replica_count), now=now)
            replicas_before = router.replica_count
            # fleet-level lifetime counters land BEFORE the aggregate so
            # this tick's record carries this tick's events (spot reclaims
            # from the chaos hook / reap above, placement spills from the
            # submits) as per-tick channels the DNN streams can consume
            collector.observe_fleet({
                "preemptions": router.preemptions,
                "tier_spills": router.tier_spills,
                "region_spills": router.region_spills})
            rec = collector.aggregate(tick, n_replicas=router.replica_count,
                                      max_replicas=lc.max_replicas)
            rec["evictions"] = float(len(evicted))   # visible to the DNN/selector
            # arrivals per VIRTUAL SECOND — perf_model and the forecaster
            # consume a rate, and the raw per-tick count only coincides with
            # it when steps_per_tick * tick_s == 1.0 (the default shape)
            rec["rps"] = float(n) / tick_span
            rps_hist.append(rec["rps"])
            rec["rps_window"] = list(rps_hist)
            anomalies = anomaly.update(tick, {"rps": rec["rps"]})
            reason = "static"
            learn_loss = None
            # realized spend for the window that produced these metrics: the
            # fleet that served it — profile rates when heterogeneous, the
            # flat constraints price otherwise.  Under a spot MARKET the
            # spot legs are billed at this tick's price, and the optimizer's
            # cost model is re-pointed at the same tick so the planner buys
            # (or stops buying) spot at what it actually costs right now
            if plan is not None and plan.market is not None:
                cost_per_tick = sum(plan.price_of(r.replica_id, tick)
                                    for r in router.serving_replicas)
                alloc.scaler.optimizer.cost_fn = (
                    lambda m, _t=tick: plan.cost_of(m, _t))
            elif plan is not None:
                cost_per_tick = router.cost_per_tick
            else:
                cost_per_tick = (replicas_before
                                 * alloc.constraints.cost_per_replica)
            gated = router.batch_gated
            if lc.batch_frac > 0.0:
                # interactive SLO protection runs even without autoscaling:
                # the gate is admission policy, not capacity actuation
                gated = alloc.scaler.batch_gate_decision(
                    rec, alloc.constraints)
                router.gate_batch(gated)
            if autoscale:
                alloc.observe(rec)
                alloc.replicas = router.replica_count
                decision = alloc.decide(rec)
                router.scale_to(decision.target_replicas, now=now)
                alloc.apply(decision)
                reason = decision.reason
                if lc.learn:
                    # the live learning loop: this tick's realized outcome
                    # becomes the reward credited to the PREVIOUS action
                    learn_loss = alloc.learn(rec, cost_per_tick)
            if recorder is not None:
                fleet = router.metrics()
                recorder.record({
                    **rec,
                    "rps_target": float(rps), "arrivals": int(n),
                    "served": int(served),
                    "replicas_before": int(replicas_before),
                    "replicas_after": int(router.replica_count),
                    "action_delta": int(decision.delta) if autoscale else 0,
                    "reason": reason,
                    "cost_per_tick": float(cost_per_tick),
                    "anomaly": float(bool(anomalies)),
                    # heterogeneous-fleet economics this tick (flat-fleet
                    # runs read cost at the constraints price, zero churn).
                    # The per-tick EVENT channels (preemptions/tier_spills/
                    # region_spills) are already in ``rec`` via the
                    # collector's fleet fold; the *_total keys keep the
                    # lifetime counters visible for run-level accounting
                    "fleet_cost_per_tick": float(fleet["fleet_cost_per_tick"]),
                    "spot_price": float(plan.spot_price(tick)
                                        if plan is not None else 0.0),
                    "preemptions_total": float(fleet["preemptions"]),
                    "tier_spills_total": float(fleet["tier_spills"]),
                    "region_spills_total": float(fleet["region_spills"]),
                    "batch_gated": float(gated),
                    # paged-pool cache efficiency, fleet-wide (0 for dense)
                    "prefix_hits": float(fleet["prefix_hits"]),
                    "tokens_shared": float(fleet["tokens_shared"]),
                    "prefill_tokens": float(fleet["prefill_tokens"]),
                    "prompt_tokens": float(fleet["prompt_tokens"]),
                })
            logs.append(TickLog(
                tick=tick, rps_target=rps, arrivals=n, served=served,
                latency_p50_ms=rec["latency_p50"],
                latency_p95_ms=rec["latency_p95"],
                queue_depth=rec["queue_depth"],
                replica_util=[(rep.replica_id, rep.flop_util) for rep in reports],
                replicas=router.replica_count, reason=reason, anomaly=bool(
                    anomalies), evicted=evicted,
                learn_loss=learn_loss, batch_gated=gated,
                cost_per_tick=float(cost_per_tick),
                preemptions=router.preemptions,
                region_spills=router.region_spills))
    except BaseException:
        # the caller never receives the router handle it is documented to
        # close — release the fleet here
        router.close()
        raise
    return router, logs
