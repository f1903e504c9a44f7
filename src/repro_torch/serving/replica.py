"""The Replica protocol: the router's only view of a serving engine
(``repro.serving.replica``, its in-process half).

The router is written purely against this surface (submit / step / report
/ scale hooks), so the replica boundary is a message protocol, never an
engine reference.  This module ports the protocol, the report shaping and
``InProcessReplica`` (the port's ``ServingEngine`` wrapped 1:1, zero
transport).  The reference's other backends (``ShardedReplica`` over a
device mesh, ``ProcessReplica``/``TcpReplica`` over the JSON transport and
``DistributedPodReplica``) are not ported yet; ``ReplicaRouter`` refuses
their topologies by name.

Protocol semantics the router relies on:

* ``step(now)`` returns the *caller's* completed Request objects and never
  hangs.
* ``evacuate()`` empties the replica NOW: queued requests plus in-flight
  ones preempted and rewound (Request.reset_generation) — the router
  requeues them through surviving replicas' schedulers, so a downscale
  never strands a mid-generation request.
* ``report(tick)`` must keep flowing after park/evacuate (an explicit empty
  window zeroes the collector's last-report replay) and after failure (an
  ``n_errors > 0`` report is how a crash surfaces as a collector straggler).
* ``lost_requests()`` recovers the submitter-side copies of everything that
  was inside a failed replica.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

from repro_torch.core.monitoring.collector import ReplicaReport
from repro_torch.serving.engine import EngineCore, ServingEngine
from repro_torch.serving.scheduler import Request


@runtime_checkable
class Replica(Protocol):
    """What the router is allowed to know about a replica."""

    replica_id: int

    def submit(self, request: Request, now: float = 0.0) -> None: ...
    def step(self, now: float | None = None) -> list[Request]: ...
    # split-phase step: the router begins the round on EVERY replica before
    # collecting ANY result, so remote replicas decode concurrently (one
    # outstanding request per connection) instead of serializing the fleet's
    # decode round.  step(now) ≡ begin_step(now); finish_step().
    def begin_step(self, now: float | None = None) -> None: ...
    def finish_step(self) -> list[Request]: ...
    def report(self, tick: int) -> ReplicaReport: ...
    def lifetime(self) -> dict: ...
    def evacuate(self) -> list[Request]: ...
    def resume(self) -> None: ...
    # control-plane lane gate: while on, the engine admits no batch-tier
    # work (queued batch requests stay queued) — interactive SLO protection
    def gate_batch(self, on: bool) -> None: ...
    def lost_requests(self) -> list[Request]: ...
    def close(self) -> None: ...

    @property
    def load(self) -> float: ...
    @property
    def idle(self) -> bool: ...
    @property
    def queue_depth(self) -> int: ...
    @property
    def pending(self) -> int: ...
    @property
    def draining(self) -> bool: ...
    @property
    def failed(self) -> bool: ...
    @property
    def transport_ms(self) -> float: ...


def _report_from_window(replica_id: int, tick: int, w: dict, *,
                        n_errors: int = 0,
                        transport_ms: float = 0.0) -> ReplicaReport:
    return ReplicaReport(
        replica_id=replica_id, tick=tick,
        latency_ms_samples=w["latency_ms_samples"],
        n_requests=w["n_requests"], n_errors=n_errors,
        flop_util=w["slot_util"],
        hbm_util=w["slot_util"],          # slot occupancy stands in
        ici_util=0.0,                     # for the device's own signals
        mem_frac=w["slot_util"],
        queue_depth=w["queue_depth"],
        # .get: pre-speculation windows (the empty-window tombstone, a
        # worker running older code) simply report zero speculation
        spec_proposed=int(w.get("spec_proposed", 0)),
        spec_accepted=int(w.get("spec_accepted", 0)),
        # .get → None: pre-tier windows feed the untiered channels only
        lat_tiers=w.get("lat_tiers") or None,
        transport_ms=transport_ms)


_EMPTY_WINDOW = {"latency_ms_samples": [], "n_requests": 0, "n_tokens": 0,
                 "slot_util": 0.0, "queue_depth": 0}


def empty_report(replica_id: int, tick: int) -> ReplicaReport:
    """A clean idle-window report — the router's tombstone for retired
    replicas reuses the one report-shape definition instead of a by-hand
    field list."""
    return _report_from_window(replica_id, tick, dict(_EMPTY_WINDOW))


# ---------------------------------------------------------------------------
# in-process backend
# ---------------------------------------------------------------------------


class InProcessReplica:
    """The protocol over a same-process ServingEngine (zero transport)."""

    kind = "inproc"

    def __init__(self, engine: ServingEngine):
        self.engine = engine
        self.failed = False
        self._step_done: list[Request] = []

    @classmethod
    def build(cls, cfg, *, slots: int, max_seq: int, seed: int = 0,
              prefill_chunk: int | None = None,
              core: EngineCore | None = None,
              replica_id: int = 0, pool: str = "dense",
              block_size: int | None = None,
              num_blocks: int | None = None, spec_k: int = 0,
              spec_ngram: int = 3, device="cuda") -> "InProcessReplica":
        return cls(ServingEngine(cfg, slots=slots, max_seq=max_seq,
                                 seed=seed, prefill_chunk=prefill_chunk,
                                 core=core, replica_id=replica_id,
                                 pool=pool, block_size=block_size,
                                 num_blocks=num_blocks, spec_k=spec_k,
                                 spec_ngram=spec_ngram, device=device))

    # ------------------------------------------------------------- protocol

    @property
    def replica_id(self) -> int:
        return self.engine.replica_id

    def submit(self, request: Request, now: float = 0.0):
        self.engine.submit(request, now=now)

    def step(self, now: float | None = None) -> list[Request]:
        return self.engine.step(now=now)

    def begin_step(self, now: float | None = None):
        # in-process: nothing to overlap with — run the round eagerly.
        # EXTEND, don't replace: if the previous round's results were never
        # collected (the caller's collection loop raised mid-way), they are
        # still owed to the caller
        self._step_done.extend(self.engine.step(now=now))

    def finish_step(self) -> list[Request]:
        out, self._step_done = self._step_done, []
        return out

    def report(self, tick: int) -> ReplicaReport:
        return _report_from_window(self.replica_id, tick,
                                   self.engine.stats.drain_window())

    def lifetime(self) -> dict:
        return self.engine.lifetime()

    def evacuate(self) -> list[Request]:
        self.engine.draining = True
        return self.engine.evacuate()

    def resume(self):
        self.engine.draining = False

    def gate_batch(self, on: bool):
        self.engine.scheduler.batch_gated = bool(on)

    def lost_requests(self) -> list[Request]:
        return []                      # an in-process replica cannot crash

    def close(self):
        pass

    @property
    def load(self) -> float:
        return self.engine.load

    @property
    def idle(self) -> bool:
        return self.engine.idle

    @property
    def queue_depth(self) -> int:
        return self.engine.scheduler.depth

    @property
    def pending(self) -> int:
        """Queued + in-flight — everything inside this replica."""
        return self.engine.scheduler.depth + int(self.engine.active.sum())

    @property
    def draining(self) -> bool:
        return self.engine.draining

    @draining.setter
    def draining(self, value: bool):
        self.engine.draining = bool(value)

    @property
    def transport_ms(self) -> float:
        return 0.0
