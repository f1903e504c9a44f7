"""Multi-replica continuous-batching serving (``repro.serving``):

  sampling.py    — per-request sampling params + host-side token sampler
  scheduler.py   — Request lifecycle + FCFS admission with priority lanes
  slots.py       — dense and paged slot pools over any family's cache
                   tree, whole on one device or sharded over a mesh
  draft.py       — prompt-lookup drafts for speculative decoding
  engine.py      — single-replica engine: chunked prefill streamed through
                   the batched decode tick, per-slot ring positions
  replica.py     — the Replica protocol and its backends: InProcessReplica,
                   ShardedReplica (one engine over a device mesh),
                   ProcessReplica (engine in a forked worker over a
                   socketpair), TcpReplica (engine in a listening worker
                   the router dials), DistributedPodReplica (the head of
                   a multi-process pod)
  transport.py   — length-prefixed JSON framing, TCP Listener/dial
                   endpoints and the wire codecs (the wire contract)
  worker.py      — the far side of the remote backends (inherited fd or
                   --listen host:port, on its own --device); one mutating
                   session + concurrent read-only observers; pod ranks
                   (--pod-rank/--pod-size) in digest-checked lockstep
  observe.py     — MetricsObserver: read-only attach to a live worker
  fleet.py       — launch_fleet / spawn_worker / launch_pod: local
                   listening workers and pods
  chaos.py       — fault injection (FaultPlan, ChaosProxy,
                   FaultyConnection) and DelayedReplica: virtual-clock
                   transport RTT in front of a replica
  profiles.py    — ReplicaProfile / FleetPlan / SpotMarket: heterogeneous
                   capacity and the profile-aware planner's cost model
  router.py      — N replicas behind least-loaded routing, scale up/down
                   mid-run, straggler eviction, the ReplicaReport stream
  workload.py    — synthetic request generation
  closed_loop.py — the paper's closed control loop: router + collector +
                   eviction policy + predictive allocator
"""
from repro_torch.serving.chaos import DelayedReplica
from repro_torch.serving.closed_loop import (
    LoopConfig, TickLog, default_profile, run_closed_loop,
)
from repro_torch.serving.engine import EngineCore, ServingEngine
from repro_torch.serving.fleet import (
    Fleet, PodHandle, launch_fleet, launch_pod, spawn_worker,
)
from repro_torch.serving.observe import MetricsObserver
from repro_torch.serving.profiles import FleetPlan, ReplicaProfile, SpotMarket
from repro_torch.serving.replica import (
    DistributedPodReplica, InProcessReplica, ProcessReplica, Replica,
    ShardedReplica, SocketReplica, TcpReplica,
)
from repro_torch.serving.router import ReplicaRouter, TOPOLOGIES
from repro_torch.serving.sampling import SamplingParams, sample_token
from repro_torch.serving.scheduler import FCFSScheduler, Request, TIERS
from repro_torch.serving.slots import (
    PagedSlotPool, ShardedCache, ShardedPagedSlotPool, ShardedSlotPool,
    SlotPool, make_pool, paged_cache_spec, write_slot,
)
from repro_torch.serving.transport import (
    Connection, Listener, TransportError, WorkerBusyError, dial, parse_addr,
)
from repro_torch.serving.workload import (
    poisson_arrival_times, shared_prefix_requests, synthetic_requests,
    tiered_requests,
)

__all__ = [
    "EngineCore", "ServingEngine", "ReplicaRouter", "TOPOLOGIES",
    "Replica", "InProcessReplica", "ShardedReplica", "ProcessReplica",
    "SocketReplica", "TcpReplica", "DistributedPodReplica", "Fleet",
    "PodHandle", "launch_fleet", "launch_pod", "spawn_worker",
    "MetricsObserver",
    "Connection", "Listener", "TransportError", "WorkerBusyError", "dial",
    "parse_addr", "DelayedReplica",
    "FleetPlan", "ReplicaProfile", "SpotMarket",
    "LoopConfig", "TickLog", "default_profile", "run_closed_loop",
    "SamplingParams", "sample_token", "FCFSScheduler", "Request", "TIERS",
    "PagedSlotPool", "SlotPool", "ShardedCache", "ShardedSlotPool",
    "ShardedPagedSlotPool", "make_pool", "paged_cache_spec",
    "write_slot", "poisson_arrival_times", "synthetic_requests",
    "shared_prefix_requests", "tiered_requests",
]
