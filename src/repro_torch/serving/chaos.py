"""Deterministic transport latency on the virtual clock (the
``DelayedReplica`` of ``repro.serving.chaos``).

``DelayedReplica`` is a Replica-protocol shim that holds each submitted
request for ``rtt_ms`` of virtual time before delivering it.  This is how a
FleetPlan's inter-region RTT matrix reaches the fabric: the router wraps
every regioned replica in it (no wall-clock sleeps, so in-process fleets
stay fast and runs stay reproducible), and the delay surfaces through
``transport_ms`` like a real remote link.  The socket-side fault injection
of the reference module (``FaultPlan``, ``ChaosProxy``,
``FaultyConnection``) waits for the socket replicas.
"""
from __future__ import annotations

from repro_torch.serving.transport import TransportError


class DelayedReplica:
    """A Replica wrapper that injects a fixed transport RTT on the virtual
    clock: ``submit`` parks the request in an ingress queue stamped
    ``now + rtt_ms``, and each ``begin_step(now)`` delivers every request
    whose stamp has passed before stepping the inner replica.  The full
    round trip is charged on the ingress leg (arrival + return collapsed
    into one delay), so a completion's ``t_done - t_submit`` latency —
    measured engine-side, where the per-tier SLO channels sample — includes
    the RTT without any change to the engine or the wire.

    The delay also rides the metrics surface: ``transport_ms`` (the
    property and every report) reads inner + rtt, exactly as if the link
    were physically that far away — the scaler's transport budgeting sees
    injected geography and real socket latency through one channel.

    Everything else delegates: the wrapper is load/evacuation/failure
    transparent (ingress requests count toward load and queue depth, leave
    with ``evacuate()``/``lost_requests()`` exactly once, and are never
    delivered to a failed inner replica)."""

    def __init__(self, inner, *, rtt_ms: float):
        self.inner = inner
        self.rtt_ms = float(rtt_ms)
        self._ingress: list[tuple[float, object]] = []  # (deliver_at, req)
        self._slots = (getattr(inner, "slots", None)
                       or getattr(getattr(inner, "engine", None),
                                  "slots", None) or 1)

    # ------------------------------------------------------------- protocol

    def submit(self, request, now: float = 0.0):
        if self.inner.failed:
            # mirror the remote stub: touching a corpse raises so the
            # router's failover reroutes instead of stranding the request
            raise TransportError(
                f"replica {self.inner.replica_id} is lost")
        self._ingress.append((float(now) + self.rtt_ms / 1e3, request))

    def _deliver_due(self, now: float):
        due = [(d, r) for d, r in self._ingress if d <= now]
        if not due:
            return
        self._ingress = [(d, r) for d, r in self._ingress if d > now]
        for i, (d, r) in enumerate(due):
            try:
                self.inner.submit(r, now=now)
            except TransportError:
                # inner died mid-delivery: everything undelivered goes back
                # to ingress so lost_requests() can rewind it exactly once
                self._ingress.extend(due[i:])
                return

    def begin_step(self, now: float | None = None):
        t = float(now or 0.0)
        if not self.inner.failed:
            self._deliver_due(t)
        self.inner.begin_step(now)

    def finish_step(self):
        return self.inner.finish_step()

    def step(self, now: float | None = None):
        self.begin_step(now)
        return self.finish_step()

    def report(self, tick: int):
        rpt = self.inner.report(tick)
        rpt.transport_ms = float(rpt.transport_ms) + self.rtt_ms
        rpt.queue_depth = int(rpt.queue_depth) + len(self._ingress)
        return rpt

    def lifetime(self) -> dict:
        return self.inner.lifetime()

    def evacuate(self):
        mine = [r for _, r in self._ingress]
        self._ingress = []
        return mine + list(self.inner.evacuate())

    def resume(self):
        self.inner.resume()

    def gate_batch(self, on: bool):
        self.inner.gate_batch(on)

    def lost_requests(self):
        mine = [r for _, r in self._ingress]
        self._ingress = []
        return mine + list(self.inner.lost_requests())

    def close(self):
        self.inner.close()

    # ---------------------------------------------------------- properties

    @property
    def load(self) -> float:
        # in-flight-to-deliver work is still this replica's work: routing
        # must see it or it would pile submissions onto the longest queue
        return self.inner.load + len(self._ingress) / max(self._slots, 1)

    @property
    def idle(self) -> bool:
        return self.inner.idle and not self._ingress

    @property
    def queue_depth(self) -> int:
        return self.inner.queue_depth + len(self._ingress)

    @property
    def pending(self) -> int:
        return self.inner.pending + len(self._ingress)

    @property
    def draining(self) -> bool:
        return self.inner.draining

    @draining.setter
    def draining(self, value: bool):
        self.inner.draining = bool(value)

    @property
    def failed(self) -> bool:
        return self.inner.failed

    @failed.setter
    def failed(self, value: bool):
        # router.preempt flips this by fiat — it must reach the inner
        # replica or the reap path would see a healthy engine
        self.inner.failed = bool(value)

    @property
    def transport_ms(self) -> float:
        return self.inner.transport_ms + self.rtt_ms

    def __getattr__(self, name):
        # replica_id, rpc_count, slots, engine, … — everything the wrapper
        # doesn't shape passes straight through
        return getattr(self.inner, name)
