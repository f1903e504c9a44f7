"""ReplicaRouter: N replicas behind least-loaded routing, scalable mid-run.

The router is written purely against the Replica protocol
(serving/replica.py) — it never touches an engine, a scheduler, or a slot
array.  Whether a replica is an in-process object, one engine sharded over a
device mesh, a worker subprocess on the far side of a socketpair, or a TCP
pod on another host is a factory decision (``from_topology``); the routing,
scaling, drain/park, and straggler-eviction logic below is
transport-agnostic.

The router is the surface the control plane drives: ``scale_to(n)`` is the
actuator for DynamicScaler / PredictiveAllocator decisions, and
``reports()`` emits the per-replica ReplicaReport stream that
core/monitoring's MetricsCollector consumes (p50/p95 latency, throughput,
slot utilization, queue depth, transport latency).

Scaling semantics:
* up   — unpark a previously retired replica (warm: its process / compile /
         weights are live), else build a new one via the factory.
* down — victims are EVACUATED: queued requests AND in-flight ones
         (preempted, rewound) are requeued through the survivors'
         schedulers, and the victim parks immediately.  No request is ever
         stranded on a parked replica, lost, or duplicated; a preempted
         request restarts generation on a survivor (its RNG reseeds per
         (seed, rid), so the replayed stream is identical to a fresh run).

Failure semantics: a replica whose transport dies mid-step is reaped on the
next ``step`` — its lost requests are rewound and requeued, a replacement
is built to restore the actuated replica count, and its final ``n_errors``
report has already marked it a straggler in the collector.

Heterogeneous fleets (``profile_fn``): when the operator supplies a
``profile_fn(replica_id) -> ReplicaProfile`` (serving/profiles.py), replicas
stop being interchangeable —

* routing normalizes load by each replica's speed (prior from the profile,
  replaced by the MEASURED lifetime tokens/tick once a replica has served
  enough rounds) and tie-breaks toward cheaper capacity;
* interactive-tier requests are never placed on ``preemptible`` replicas
  while any stable one serves (``tier_spills`` counts forced fallbacks);
* on a region-tagged fleet (profiles carry ``region``), interactive
  requests prefer capacity in their OWN region — stability still trumps
  locality, so the in-region preference filters the stable set — and
  ``region_spills`` counts interactive placements forced cross-region.
  When the plan carries an RTT matrix (``transport_ms_for``), each new
  replica is built behind a ``chaos.DelayedReplica`` shim injecting that
  RTT on the virtual clock, so cross-region placement costs real measured
  latency on every topology without a wall-clock sleep;
* a failed preemptible replica is NOT replaced on reap (``preempt()`` is
  the chaos/provider-reclaim injection point) — batch absorbs the churn and
  the scaler re-provisions when the forecast still wants the capacity;
* ``metrics()`` reports the fleet's realized cost per tick, and downscale
  victims are highest-id first, which under a FleetPlan sheds spot
  capacity before reserved.

Without a profile_fn every profile is the default (equal speed/cost, not
preemptible) and routing is bit-identical to the legacy least-loaded key;
a profiled fleet whose profiles carry no regions routes bit-identically to
the pre-region profiled key (no delay shims, no spill counting).

The ``repro.serving.router`` logic line for line.  ``from_topology`` builds
all five of the reference's topologies.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.monitoring.collector import ReplicaReport
from repro_torch.serving.chaos import DelayedReplica
from repro_torch.serving.engine import EngineCore
from repro_torch.serving.profiles import ReplicaProfile
from repro_torch.serving.replica import (
    InProcessReplica, Replica, ServingEngine, empty_report,
)
from repro_torch.serving.scheduler import Request
from repro_torch.serving.transport import TransportError

# measured speed needs this many served rounds before it replaces the
# profile's prior — a two-tick sample must not reroute the fleet
MIN_SPEED_TICKS = 16

TOPOLOGIES = ("inproc", "sharded", "proc", "tcp", "pod")


def _attach_factory(klass, cfg, addr_list, topology, **fixed):
    """Factory for attach-style replicas (tcp workers, pod heads): ids
    inside ``addr_list`` dial the operator's pre-scheduled endpoints; ids
    past it spawn LOCAL stand-ins so scale-up keeps working in a demo
    without a pod scheduler — but past an EXPLICIT list that substitution
    is capacity drift, so it is both warned (stderr readers) and counted
    (``factory.counters["off_list_spawns"]`` → router.metrics(), where the
    closed loop can see the topology drifting)."""
    import warnings

    counters = {"off_list_spawns": 0}

    def factory(replica_id: int):
        addr = addr_list[replica_id] if replica_id < len(addr_list) else None
        if addr is None and addr_list:
            counters["off_list_spawns"] += 1
            warnings.warn(
                f"{topology} replica {replica_id} exceeds the "
                f"{len(addr_list)}-pod attach list; spawning a LOCAL "
                f"worker on the router host", RuntimeWarning, stacklevel=2)
        return klass(cfg, addr=addr, replica_id=replica_id, **fixed)

    factory.counters = counters
    return factory


def _worker_device(device) -> str:
    """A spawned worker's ``--device``: the process runs on its first
    card, so only cuda:0 (or plain cuda) and cpu name a worker's device."""
    dev = torch.device(device)
    if dev.index not in (None, 0):
        raise ValueError(f"worker processes run on their first card; "
                         f"got device {dev}")
    return dev.type


def _coerce(obj) -> Replica:
    """Legacy factories return bare ServingEngines — wrap them."""
    return InProcessReplica(obj) if isinstance(obj, ServingEngine) else obj


class ReplicaRouter:
    def __init__(self, replica_factory, *, n_replicas: int = 1,
                 max_replicas: int = 8, profile_fn=None,
                 region_aware: bool = True, delay_fn=None):
        """replica_factory(replica_id) -> Replica (or a bare ServingEngine,
        which is wrapped in-process for backward compatibility).

        ``profile_fn(replica_id) -> ReplicaProfile`` declares the fleet
        heterogeneous (see module docstring); None keeps every replica
        interchangeable and routing bit-identical to the legacy key.

        ``delay_fn(replica_id) -> rtt_ms`` injects deterministic transport
        latency (a DelayedReplica shim) in front of each new replica;
        defaults to the profile_fn's ``transport_ms_for`` when it has one
        (a FleetPlan with regions), so geography and its latency arrive
        together.  ``region_aware=False`` keeps the injected latency but
        routes region-BLIND — the control arm of the geo ablation."""
        self._factory = replica_factory
        self.max_replicas = max_replicas
        self._profile_fn = profile_fn
        self._profiled = profile_fn is not None
        self._region_aware = bool(region_aware)
        if delay_fn is None and hasattr(profile_fn, "transport_ms_for"):
            delay_fn = profile_fn.transport_ms_for
        self._delay_fn = delay_fn
        self._profiles: dict[int, ReplicaProfile] = {}
        # router-side speed measurement: completions and served rounds per
        # replica id (transport-free — no lifetime RPC on the hot path)
        self._tok_served: dict[int, int] = {}
        self._ticks_served: dict[int, int] = {}
        self.preemptions = 0          # preemptible replicas lost/reclaimed
        self.tier_spills = 0          # interactive forced onto volatile cap
        self.region_spills = 0        # interactive forced out of its region
        self._batch_gated = False
        self.replicas: list[Replica] = []
        self._parked: list[Replica] = []
        self._retired: list[Replica] = []     # failed, kept for accounting
        # retirement reports still owed, (phase, replica): phase 0 → the
        # crash report goes out next reports() round, phase 1 → the clean
        # tombstone does.  One structure, drained in one place.
        self._dying: list[tuple[int, Replica]] = []
        self._undelivered: list[Request] = []  # survived a mid-step raise
        self._next_replica_id = 0
        self._target = max(n_replicas, 1)
        self._t0: float | None = None
        self._last_now = 0.0
        for _ in range(self._target):
            self._add_replica()

    @classmethod
    def shared_core(cls, cfg, *, slots: int, max_seq: int, seed: int = 0,
                    prefill_chunk: int | None = None, n_replicas: int = 1,
                    max_replicas: int = 8, params=None,
                    device="cuda") -> "ReplicaRouter":
        """In-process router whose replicas share one EngineCore
        (weights and step functions)."""
        return cls.from_topology(cfg, "inproc", slots=slots, max_seq=max_seq,
                                 seed=seed, prefill_chunk=prefill_chunk,
                                 n_replicas=n_replicas,
                                 max_replicas=max_replicas, params=params,
                                 device=device)

    @classmethod
    def from_topology(cls, cfg, topology: str, *, slots: int, max_seq: int,
                      seed: int = 0, prefill_chunk: int | None = None,
                      n_replicas: int = 1, max_replicas: int = 8,
                      mesh=None, addrs=None, pod_size: int = 2,
                      batch_submits: bool = True, pool: str = "dense",
                      block_size: int | None = None,
                      num_blocks: int | None = None, spec_k: int = 0,
                      spec_ngram: int = 3,
                      profile_fn=None, region_aware: bool = True,
                      delay_fn=None, params=None,
                      device="cuda") -> "ReplicaRouter":
        """Build the fleet for one of the reference's five replica
        topologies.

        inproc  — replicas share one EngineCore (weights and step
                  functions); ``params`` injects a prepared ``LM`` into it
                  (for example the reference's weights through
                  ``models.bridge``), otherwise the weights are drawn from
                  ``seed``.  Every engine runs on ``device`` (cuda unless
                  the caller asks for cpu).
        proc    — each replica is a worker subprocess on ``device``;
                  workers draw the weights from the shared seed on that
                  device, so token streams match the in-process topology's
                  on the same device bit for bit.  ``params`` cannot cross
                  the process boundary and raises.
        tcp     — each replica dials a listening TCP worker: ``addrs``
                  lists pre-started pods to attach to (cross-host; each
                  runs on its own ``--device``); replica ids past the list
                  spawn local workers on ``device`` and kernel-picked
                  ports, so scale-up keeps working in a demo without a pod
                  scheduler.  ``params`` raises, as for proc.
        sharded — each replica is ONE engine spanning ``mesh``
                  (``launch.mesh.make_mesh``; default one shard per CUDA
                  device, or one on the CPU): its slots split over the
                  mesh, decoded shard by shard (ShardedReplica).  The
                  replicas share one EngineCore on ``device`` (``params``
                  as for inproc) and one sharded decode, so each distinct
                  mesh device holds one copy of the weights.
        pod     — each replica is a MULTI-PROCESS pod of ``pod_size``
                  worker ranks behind one head (DistributedPodReplica):
                  ``addrs`` lists pre-scheduled pod HEAD addresses;
                  replica ids past the list launch local pods, every rank
                  on ``device``.  ``params`` raises, as for proc.

        ``batch_submits`` (proc/tcp/pod) folds per-tick submits into the
        step RPC — one message per round per replica instead of one per
        request.  For the attach topologies, off-list local spawns are
        counted in ``metrics()["off_list_spawns"]``.  An option a topology
        has no use for raises by name when set away from its default:
        ``mesh`` outside sharded, ``pod_size`` outside pod, and ``addrs``
        and ``batch_submits`` with inproc or sharded.

        ``pool`` ∈ {"dense", "paged"} selects each replica's KV layout
        (serving/slots.py); ``block_size``/``num_blocks`` tune the paged
        pool's geometry.  The layout is observationally invisible — token
        streams match the dense pool bit-for-bit.

        ``spec_k``/``spec_ngram`` turn on speculative decoding inside each
        replica's engine (serving/engine.py) — also observationally
        invisible: accepted drafts are exact matches, so token streams are
        bit-identical with speculation on or off.  The sharded topology
        accepts the knobs but serves the plain path (its decode runs
        single-position ticks).

        ``profile_fn(replica_id) -> ReplicaProfile`` (e.g. a
        serving/profiles.py FleetPlan) declares the fleet heterogeneous —
        cost/speed-aware routing, tier placement, preemptible semantics;
        see the module docstring.  ``region_aware``/``delay_fn`` control
        the geographic axis (in-region preference and injected RTT; see
        ``__init__``).
        """
        if topology not in TOPOLOGIES:
            raise ValueError(f"unknown topology {topology!r} "
                             f"(expected one of {TOPOLOGIES})")
        unused = []
        if topology != "sharded":
            unused.append(("mesh", mesh, None))
        if topology != "pod":
            unused.append(("pod_size", pod_size, 2))
        if topology in ("inproc", "sharded"):
            unused += [("addrs", addrs or None, None),
                       ("batch_submits", batch_submits, True)]
        for name, value, default in unused:
            if value != default:
                raise NotImplementedError(
                    f"{name}={value!r} has no use in topology {topology!r}")
        pool_kw = dict(pool=pool, block_size=block_size,
                       num_blocks=num_blocks, spec_k=spec_k,
                       spec_ngram=spec_ngram)
        if topology not in ("inproc", "sharded") and params is not None:
            raise ValueError(
                f"params cannot cross the process boundary of topology "
                f"{topology!r}: its workers draw their weights from seed "
                f"on their own device")
        if topology == "proc":
            from repro_torch.serving.replica import ProcessReplica

            def factory(replica_id: int):
                return ProcessReplica(cfg, slots=slots, max_seq=max_seq,
                                      seed=seed, prefill_chunk=prefill_chunk,
                                      replica_id=replica_id,
                                      batch_submits=batch_submits,
                                      device=_worker_device(device), **pool_kw)
        elif topology == "tcp":
            from repro_torch.serving.replica import TcpReplica
            factory = _attach_factory(
                TcpReplica, cfg, list(addrs or []), topology, slots=slots,
                max_seq=max_seq, seed=seed, prefill_chunk=prefill_chunk,
                batch_submits=batch_submits, device=_worker_device(device), **pool_kw)
        elif topology == "pod":
            from repro_torch.serving.replica import DistributedPodReplica
            factory = _attach_factory(
                DistributedPodReplica, cfg, list(addrs or []), topology,
                slots=slots, max_seq=max_seq, seed=seed,
                prefill_chunk=prefill_chunk, pod_size=pod_size,
                batch_submits=batch_submits, device=_worker_device(device),
                **pool_kw)
        elif topology == "sharded":
            from repro_torch.serving.replica import (
                ShardedReplica, default_mesh, make_sharded_decode,
            )
            core = EngineCore(cfg, max_seq, seed=seed, params=params,
                              device=device)
            if mesh is None:
                mesh = default_mesh(core.device)
            decode_fn = make_sharded_decode(cfg, mesh, slots, max_seq,
                                            pool=pool, block_size=block_size,
                                            num_blocks=num_blocks)

            def factory(replica_id: int):
                return ShardedReplica(cfg, slots=slots, max_seq=max_seq,
                                      mesh=mesh, seed=seed,
                                      prefill_chunk=prefill_chunk, core=core,
                                      replica_id=replica_id,
                                      decode_fn=decode_fn, **pool_kw)
        else:
            core = EngineCore(cfg, max_seq, seed=seed, params=params,
                              device=device)

            def factory(replica_id: int):
                return InProcessReplica.build(
                    cfg, slots=slots, max_seq=max_seq,
                    prefill_chunk=prefill_chunk, core=core,
                    replica_id=replica_id, **pool_kw)

        return cls(factory, n_replicas=n_replicas, max_replicas=max_replicas,
                   profile_fn=profile_fn, region_aware=region_aware,
                   delay_fn=delay_fn)

    # ------------------------------------------------------------- topology

    def _add_replica(self):
        if self._parked:
            rep = self._parked.pop()
            rep.resume()
        else:
            rep = _coerce(self._factory(self._next_replica_id))
            self._next_replica_id += 1
            # geography: a replica whose region costs an RTT from the
            # router's vantage point comes up behind the delay shim —
            # parked replicas re-enter already wrapped
            delay = (float(self._delay_fn(rep.replica_id))
                     if self._delay_fn is not None else 0.0)
            if delay > 0.0:
                rep = DelayedReplica(rep, rtt_ms=delay)
        rid = rep.replica_id
        if rid not in self._profiles:
            self._profiles[rid] = (self._profile_fn(rid) if self._profiled
                                   else ReplicaProfile())
        # a replica joining a gated fleet must not open a batch side door
        if self._batch_gated:
            rep.gate_batch(True)
        self.replicas.append(rep)

    def profile(self, replica_id: int) -> ReplicaProfile:
        return self._profiles.get(replica_id) or ReplicaProfile()

    def effective_speed(self, replica_id: int) -> float:
        """The speed the routing key divides load by: the profile's prior
        until the replica has served MIN_SPEED_TICKS rounds, then its
        measured tokens/tick relative to the fleet's measured mean — live
        hardware truth replaces the operator's catalog number."""
        prior = self.profile(replica_id).speed
        ticks = self._ticks_served.get(replica_id, 0)
        if ticks < MIN_SPEED_TICKS:
            return prior
        rates = [self._tok_served.get(rid, 0) / t
                 for rid, t in self._ticks_served.items()
                 if t >= MIN_SPEED_TICKS]
        base = sum(rates) / len(rates) if rates else 0.0
        if base <= 0.0:
            return prior               # an idle fleet has measured nothing
        return max(self._tok_served.get(replica_id, 0) / ticks / base, 1e-3)

    @property
    def all_replicas(self) -> list[Replica]:
        """Every replica this router built: serving, parked and retired
        (failed or evicted) ones, whose history fleet totals keep."""
        return self.replicas + self._parked + self._retired

    @property
    def serving_replicas(self) -> list[Replica]:
        return [r for r in self.replicas if not r.draining and not r.failed]

    @property
    def replica_count(self) -> int:
        return len(self.serving_replicas)

    def scale_to(self, n: int, now: float = 0.0) -> int:
        """Actuate a control-plane decision; returns the realized count."""
        n = max(1, min(int(n), self.max_replicas))
        self._target = n
        while self.replica_count < n:
            self._add_replica()
        extra = self.replica_count - n
        if extra > 0:
            # highest id first: under a FleetPlan the ids past the reserved
            # pool are the preemptible ones, so downscale sheds spot
            # capacity before touching stable replicas
            victims = sorted(self.serving_replicas,
                             key=lambda r: -r.replica_id)[:extra]
            displaced: list[Request] = []
            for rep in victims:
                # queued AND in-flight leave with the replica, which parks
                # immediately — nothing is stranded behind a parked replica
                displaced.extend(rep.evacuate())
                self.replicas.remove(rep)
                self._parked.append(rep)
            for req in displaced:          # requeue through the survivors
                self.submit(req, now=now)
        return self.replica_count

    def evict(self, replica_id: int, now: float = 0.0, *,
              replace: bool = True) -> bool:
        """Remove one replica (straggler eviction / failure reaping): its
        requests are requeued through the survivors and — when ``replace``
        — a fresh replica restores the actuated count.

        The victim RETIRES, it does not park: parking would hand the same
        slow worker straight back to the next scale-up or eviction
        replacement (``_add_replica`` pops parked replicas LIFO), churning
        evict→revive forever.  Parking is for scale_to downscale (healthy
        warm-revive candidates); an evicted replica was condemned for
        cause."""
        rep = next((r for r in self.replicas if r.replica_id == replica_id),
                   None)
        if rep is None:
            return False
        displaced = rep.evacuate()
        displaced.extend(rep.lost_requests())
        self.replicas.remove(rep)
        # replacement first, THEN retire the victim (the order matters for
        # replica_count and keeps this path symmetric with scale_to's)
        if replace and self.replica_count < self._target:
            self._add_replica()
        rep.close()
        self._retired.append(rep)
        if rep.failed:
            if self.profile(replica_id).preemptible:
                self.preemptions += 1      # provider reclaimed spot capacity
            self._dying.append((0, rep))   # crash report, then tombstone
        else:
            # healthy straggler: one clean tombstone prunes its collector
            # latency EWMA, so the retired id drops off the straggler feed
            # instead of being re-flagged (and re-proposed) forever
            self._dying.append((1, rep))
        for req in displaced:
            self.submit(req, now=now)
        return True

    def evict_stragglers(self, straggler_ids, now: float = 0.0) -> list[int]:
        """Control-plane hook: evict every flagged replica (the collector's
        ``stragglers()`` feed), replacing each to hold the actuated count."""
        evicted = []
        for rid in list(straggler_ids):
            if self.evict(rid, now=now):
                evicted.append(rid)
        return evicted

    # ------------------------------------------------------------- requests

    def submit(self, request: Request, now: float = 0.0):
        """Least-loaded routing.  A replica whose transport died between
        steps only reveals itself when an RPC touches it — the submit that
        discovers the corpse reroutes to the next survivor instead of
        crashing the caller (the dead replica is excluded the moment its
        stub flips ``failed``, and the next step() reaps it properly)."""
        if request.t_submit is None:
            request.t_submit = now
        if self._t0 is None or request.t_submit < self._t0:
            self._t0 = request.t_submit
        while True:
            candidates = self.serving_replicas
            if not candidates:
                # every live replica is a corpse (single-replica fleet whose
                # worker died between steps): reap them NOW — eviction
                # builds the replacements step() would have built
                failed = [r for r in self.replicas if r.failed]
                if not failed:
                    raise RuntimeError("no live replicas to route to")
                for rep in failed:
                    self.evict(rep.replica_id, now=now)
                continue
            if self._profiled:
                # interactive work never rides volatile capacity while any
                # stable replica serves; when the whole fleet is spot, the
                # forced fallback is counted rather than refused
                if getattr(request, "tier", "interactive") == "interactive":
                    stable = [r for r in candidates
                              if not self.profile(r.replica_id).preemptible]
                    if stable:
                        candidates = stable
                    else:
                        self.tier_spills += 1
                    # geography: prefer in-region capacity — AFTER the
                    # stable filter, because SLO protection trumps
                    # locality (an in-region spot replica must not steal
                    # interactive work from a remote stable one) — and
                    # only while the in-region replicas have headroom
                    # (load < 1): pinning into a saturated region would
                    # trade one RTT for unbounded queueing.  Only a
                    # region-TAGGED candidate set engages the preference:
                    # region-less fleets and untagged requests skip it,
                    # keeping their placement bit-identical to the
                    # pre-region key
                    req_region = getattr(request, "region", "")
                    if req_region and self._region_aware:
                        local = [r for r in candidates
                                 if self.profile(r.replica_id).region
                                 == req_region and r.load < 1.0]
                        if local:
                            candidates = local
                        elif any(self.profile(r.replica_id).region
                                 for r in candidates):
                            self.region_spills += 1
                # least NORMALIZED load: a 2× replica at load 0.8 is as
                # admittable as a baseline one at 0.4; ties go to cheaper
                # capacity, so batch headroom lands on spot replicas
                rep = min(candidates, key=lambda r: (
                    r.load / self.effective_speed(r.replica_id),
                    self.profile(r.replica_id).cost_per_tick,
                    r.replica_id))
            else:
                rep = min(candidates, key=lambda r: (r.load, r.replica_id))
            try:
                rep.submit(request, now=now)
                return
            except TransportError:
                continue               # rep is now failed → excluded above

    def step(self, now: float = 0.0) -> list[Request]:
        """One tick across every live replica, split-phase: the round BEGINS
        on every replica before any result is collected, so remote workers
        decode concurrently (the round costs the slowest worker, not the
        sum).  Replicas whose transport died are reaped afterwards: lost
        requests rewound and requeued, replacements built to restore the
        actuated count."""
        live = list(self.replicas)
        for rep in live:
            rep.begin_step(now)
        # completions already collected must survive a later replica's
        # finish_step raising (their stubs have handed them over — they are
        # not recoverable anywhere else): stash and redeliver next step
        completed, self._undelivered = self._undelivered, []
        try:
            for rep in live:
                completed.extend(rep.finish_step())
        except Exception:
            self._undelivered = completed
            raise
        for rep in [r for r in self.replicas if r.failed]:
            # a lost PREEMPTIBLE replica is not replaced: the spot capacity
            # is gone, batch absorbs the churn, and the scaler re-provisions
            # if the forecast still wants it — auto-rebuilding here would
            # bill on-demand work as if spot never vanished
            self.evict(rep.replica_id, now=now,
                       replace=not self.profile(rep.replica_id).preemptible)
        for rep in self.serving_replicas:
            self._ticks_served[rep.replica_id] = \
                self._ticks_served.get(rep.replica_id, 0) + 1
        for req in completed:
            if req.replica_id is not None:
                self._tok_served[req.replica_id] = \
                    self._tok_served.get(req.replica_id, 0) \
                    + len(req.tokens_out)
        self._last_now = max(self._last_now, now)
        return completed

    @property
    def pending(self) -> int:
        """Requests somewhere in the system (queued or in a slot)."""
        return sum(r.pending for r in self.replicas)

    # ------------------------------------------------------ tiers & capacity

    def gate_batch(self, on: bool) -> bool:
        """Fleet-wide batch-lane gate (the scaler's SLO-protection
        actuator): while on, no replica admits batch-tier work — queued
        batch requests wait, interactive drains at full capacity.
        Replicas added while gated come up gated.  Returns the new state."""
        self._batch_gated = bool(on)
        for rep in self.replicas:
            rep.gate_batch(self._batch_gated)
        return self._batch_gated

    @property
    def batch_gated(self) -> bool:
        return self._batch_gated

    def preempt(self, replica_id: int, now: float = 0.0) -> bool:
        """Provider-reclaim injection: the replica vanishes WITHOUT notice
        (no graceful drain — in-flight work is rewound and requeued through
        the survivors, exactly once).  Not replaced: the capacity is gone
        until the scaler buys more.  Refuses to take the last serving
        replica — a fleet of zero cannot absorb anything."""
        rep = next((r for r in self.replicas if r.replica_id == replica_id),
                   None)
        if rep is None or len(self.serving_replicas) <= 1:
            return False
        rep.failed = True              # the reclaim is not a clean drain
        return self.evict(replica_id, now=now, replace=False)

    @property
    def cost_per_tick(self) -> float:
        """Realized fleet cost this tick: sum of serving replicas' profile
        rates (parked/dead capacity is not billed)."""
        return sum(self.profile(r.replica_id).cost_per_tick
                   for r in self.serving_replicas)

    # ------------------------------------------------------------- metrics

    def reports(self, tick: int) -> list[ReplicaReport]:
        """Per-replica reports for MetricsCollector.submit (drains each
        replica's metric window).  Parked replicas keep reporting (empty
        windows): the collector re-counts each replica's LAST report every
        aggregate, so going silent would replay a parked replica's final
        spike window forever — an explicit empty report zeroes it out.

        A retired (failed, closed) replica sends exactly TWO more reports:
        first its crash report (n_errors > 0 — this is what puts the crash
        on the collector's straggler list and in the fleet error rate; the
        reap happened inside step(), so without this the control plane
        would never see the failure at all), then one clean tombstone — a
        final n_errors report left in place would replay forever, keeping a
        long-dead replica flagged.

        A PARKED replica whose worker died (discovered by this very report
        poll) joins the same retirement flow here — nothing else ever
        touches parked replicas, so this is the only place the corpse can
        be noticed."""
        out = [rep.report(tick) for rep in self.replicas]
        dying_now, self._dying = self._dying, []
        for rep in list(self._parked):
            out.append(rep.report(tick))    # the poll that detects death
            if rep.failed:                  # that report WAS its crash one:
                self._parked.remove(rep)    # tombstone next round, never
                rep.close()                 # the same one
                self._retired.append(rep)
                self._dying.append((1, rep))
        for phase, rep in dying_now:        # one owed report per round
            if phase == 0:                  # crash report (parent-side stub)
                rpt = rep.report(tick)
                # phase 0 IS the crash report by definition: an in-process
                # replica preempted by fiat dies with a clean window, but
                # the collector must still see the loss as an error
                rpt.n_errors = max(rpt.n_errors, 1)
                out.append(rpt)
                self._dying.append((1, rep))
            else:                           # clean-up for the crash report
                out.append(empty_report(rep.replica_id, tick))
        return out

    def metrics(self) -> dict:
        """Fleet-level aggregates over replica lifetimes (parked and failed
        replicas keep their history — work they served must not vanish)."""
        ever = [r.lifetime() for r in self.all_replicas]
        lats = [l for lt in ever for l in lt["latencies_ms"]]
        lat = np.asarray(lats) if lats else np.zeros(1)
        tokens = sum(lt["total_tokens"] for lt in ever)
        completed = sum(lt["total_completed"] for lt in ever)
        wall = max(self._last_now - (self._t0 or 0.0), 1e-9)
        # tick-weighted mean: every lifetime is an AVERAGE over that
        # replica's served rounds, so a two-tick replacement must weigh
        # two ticks, not as much as a run-long survivor.  Lifetimes without
        # a tick count (older remote mirrors) fall back to weight 1.
        tick_w = [max(int(lt.get("total_ticks", 0)), 0) or 1 for lt in ever]
        util_num = sum(lt["slot_utilization"] * w
                       for lt, w in zip(ever, tick_w))
        return {
            "latency_p50_ms": float(np.percentile(lat, 50)),
            "latency_p95_ms": float(np.percentile(lat, 95)),
            "throughput_tok_s": tokens / wall,
            "completed": completed,
            "completed_tokens": tokens,
            "completed_interactive": sum(
                lt.get("completed_interactive", 0) for lt in ever),
            "completed_batch": sum(
                lt.get("completed_batch", 0) for lt in ever),
            "slot_utilization": (util_num / sum(tick_w)) if ever else 0.0,
            "queue_depth": sum(r.queue_depth for r in self.replicas),
            "transport_ms": float(np.mean(
                [r.transport_ms for r in self.replicas])) if self.replicas
            else 0.0,
            # frames this fleet put on the wire over its lifetime (0 for
            # in-process fleets) — the submit-batching benchmark metric
            "rpc_count": sum(getattr(r, "rpc_count", 0)
                             for r in self.all_replicas),
            # attach topologies: replacements/scale-ups that fell off the
            # operator's explicit attach list onto router-host workers —
            # topology drift the closed loop should see, not just stderr
            "off_list_spawns": getattr(self._factory, "counters",
                                       {}).get("off_list_spawns", 0),
            "replicas": self.replica_count,
            # heterogeneous-fleet economics: realized cost of the serving
            # set, spot losses absorbed, and interactive requests forced
            # onto volatile capacity (0 / default-priced when unprofiled)
            "fleet_cost_per_tick": self.cost_per_tick,
            "preemptions": self.preemptions,
            "tier_spills": self.tier_spills,
            # interactive placements forced out of their origin region (0
            # on region-less fleets and under region-blind routing)
            "region_spills": self.region_spills,
            "batch_gated": self._batch_gated,
            # paged-pool cache efficiency, fleet-wide — engines only report
            # these when running a paged KV pool, so dense fleets read 0
            "prefix_hits": sum(lt.get("prefix_hits", 0) for lt in ever),
            "tokens_shared": sum(lt.get("tokens_shared", 0) for lt in ever),
            "prefill_tokens": sum(lt.get("prefill_tokens", 0) for lt in ever),
            "prompt_tokens": sum(lt.get("prompt_tokens", 0) for lt in ever),
            # speculative decoding, fleet-wide: draft tokens proposed and
            # accepted over every engine's lifetime (0 with speculation off)
            "spec_proposed": sum(lt.get("spec_proposed", 0) for lt in ever),
            "spec_accepted": sum(lt.get("spec_accepted", 0) for lt in ever),
        }

    def close(self):
        """Release every replica (terminates proc-topology workers)."""
        for rep in self.replicas + self._parked:
            rep.close()
        self.replicas.clear()
        self._parked.clear()
