"""Dynamic scaling (paper §3.3.2) — the DynamicScaler, faithfully.

The paper's pseudocode:

    scaling_decision = self.optimizer.optimize(
        current_load=current_load, predicted_load=predicted_load,
        efficiency=resource_efficiency, constraints=constraints)

analyze_current_load → windowed load statistics; predict_future_load → the
workload forecaster (§3.3.2 time-series component); calculate_efficiency →
multi-resource utilization score; optimize → constrained cost minimization:
the smallest replica count whose *predicted* latency meets the SLO at the
*forecast peak* load, within min/max/step/cooldown constraints.

The performance model is injected (PerfModel protocol): the closed loop
(serving/closed_loop.py) wires in its capacity model over the engine's slot
arithmetic.

A numpy copy of ``repro.core.scaling.scaler``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Protocol

import numpy as np


class PerfModel(Protocol):
    def __call__(self, replicas: int, load_rps: float) -> tuple[float, float]:
        """→ (latency_ms, utilization ∈ [0,1]) at this operating point."""


@dataclasses.dataclass(frozen=True)
class ScalingConstraints:
    min_replicas: int = 1
    max_replicas: int = 64
    max_step: int = 8               # largest replica delta per decision
    slo_ms: float = 200.0
    target_util: tuple[float, float] = (0.55, 0.85)
    cooldown_ticks: int = 3         # min ticks between scale-downs
    cost_per_replica: float = 1.0
    # per-tier SLOs: the batch lane tolerates queueing the interactive one
    # must not; the gate trips when interactive p95 crosses this fraction
    # of its SLO (and releases with hysteresis — see batch_gate_decision)
    slo_batch_ms: float = 2000.0
    batch_gate_frac: float = 0.9
    # replica-fabric transport latency below this fraction of the SLO is
    # ignored (deadband): loopback-socket noise must not flip a knife-edge
    # feasibility test, but a genuinely remote fleet's round-trip cost
    # tightens the latency budget the optimizer plans against.
    transport_deadband_frac: float = 0.02


@dataclasses.dataclass
class ScalingDecision:
    target_replicas: int
    delta: int
    reason: str
    predicted_load: float
    predicted_latency_ms: float
    efficiency: float


class ScalingOptimizer:
    """Constrained optimizer: min cost s.t. predicted latency ≤ SLO.

    ``cost_fn(replicas) -> cost`` replaces the flat per-replica price when
    the fleet is heterogeneous (serving/profiles.py FleetPlan.cost_of:
    reserved capacity at the on-demand rate, headroom past it at the spot
    rate) — the profile-aware planner buys batch headroom cheap."""

    def __init__(self, perf_model: PerfModel,
                 cost_fn: Callable[[int], float] | None = None):
        self.perf_model = perf_model
        self.cost_fn = cost_fn

    def optimize(self, *, current_load: dict, predicted_load: float,
                 efficiency: float, constraints: ScalingConstraints,
                 current_replicas: int,
                 transport_ms: float = 0.0) -> ScalingDecision:
        """``transport_ms`` is the replica fabric's round-trip cost (from
        the streamed ReplicaReports): it is pure overhead the compute model
        can't see, so it comes off the SLO budget before the feasibility
        test."""
        c = constraints
        lo = max(c.min_replicas, current_replicas - c.max_step)
        hi = min(c.max_replicas, current_replicas + c.max_step)
        budget_ms = c.slo_ms - max(transport_ms, 0.0)
        best = None
        for r in range(lo, hi + 1):
            lat, util = self.perf_model(r, predicted_load)
            feasible = lat <= budget_ms and util <= c.target_util[1]
            cost = (self.cost_fn(r) if self.cost_fn is not None
                    else r * c.cost_per_replica)
            # the LOW water mark ranks ahead of cost: of the feasible
            # points, those keeping the fleet inside the utilization band
            # beat under-utilized ones — without this term the adaptation
            # engine's util_lo knob never influences a decision and a flat
            # cost curve lets the latency tie-break overprovision forever
            key = (not feasible, util < c.target_util[0], cost, lat)
            if best is None or key < best[0]:
                best = (key, r, lat, util, feasible)
        _, r, lat, util, feasible = best
        reason = "optimal" if feasible else "infeasible:max_headroom"
        if not feasible:
            # no point meets SLO within step bounds → go as big as allowed
            r = hi
            lat, util = self.perf_model(r, predicted_load)
        return ScalingDecision(target_replicas=r, delta=r - current_replicas,
                               reason=reason, predicted_load=predicted_load,
                               predicted_latency_ms=lat, efficiency=efficiency)


class EvictionPolicy:
    """Closed-loop straggler eviction: flag → sustain → actuate.

    The collector's ``stragglers()`` feed is noisy by design (one bad
    window flags a replica), so the policy only proposes an eviction after
    ``k_windows`` CONSECUTIVE flagged control windows — a replica that
    recovers (or whose stale EWMA the collector prunes) resets its streak.
    Per update at most ``fleet_size - min_fleet`` evictions are proposed:
    the router replaces every evicted replica, but a one-replica fleet must
    never be evicted at all (there is nowhere to drain to while the
    replacement warms, and the "straggler" IS the fleet median)."""

    def __init__(self, k_windows: int = 3, min_fleet: int = 1):
        self.k_windows = max(int(k_windows), 1)
        self.min_fleet = max(int(min_fleet), 1)
        self._streak: dict[int, int] = {}

    def update(self, flagged_ids, fleet_size: int) -> list[int]:
        """One control window: advance streaks; → replica ids to evict."""
        flagged = set(flagged_ids)
        for rid in list(self._streak):
            if rid not in flagged:
                del self._streak[rid]      # recovered → streak resets
        evict: list[int] = []
        budget = max(int(fleet_size) - self.min_fleet, 0)
        for rid in sorted(flagged):
            self._streak[rid] = self._streak.get(rid, 0) + 1
            if self._streak[rid] >= self.k_windows and len(evict) < budget:
                evict.append(rid)
                del self._streak[rid]      # actuated: the replacement
        return evict                       # starts from a clean slate

    def streak(self, replica_id: int) -> int:
        return self._streak.get(replica_id, 0)


class DynamicScaler:
    def __init__(self, forecaster, perf_model: PerfModel, *,
                 horizon_ticks: int = 3, down_sustain: int = 3,
                 cost_fn: Callable[[int], float] | None = None):
        self.forecaster = forecaster
        self.optimizer = ScalingOptimizer(perf_model, cost_fn=cost_fn)
        self.horizon = horizon_ticks
        self.down_sustain = down_sustain
        self._last_downscale = -10**9
        self._below_count = 0
        self._tick = 0
        self._batch_gated = False

    # --- the paper's three analysis phases -------------------------------

    def analyze_current_load(self, metrics: dict) -> dict:
        rps = metrics.get("rps_window", [metrics.get("rps", 0.0)])
        return {
            "mean": float(np.mean(rps)),
            "peak": float(np.max(rps)),
            "std": float(np.std(rps)),
            "current": float(rps[-1]),
        }

    def predict_future_load(self, metrics: dict) -> float:
        del metrics  # forecaster already observed the window via update()
        return self.forecaster.predict_peak(self.horizon)

    def calculate_efficiency(self, current_load: dict,
                             metrics: dict | None = None) -> float:
        """Multi-resource efficiency: mean of the utilization channels."""
        if not metrics:
            return 0.0
        chans = [metrics.get(k, 0.0)
                 for k in ("flop_util", "hbm_util", "ici_util", "mem_frac")]
        return float(np.mean([c for c in chans if c is not None]))

    def batch_gate_decision(self, metrics: dict,
                            constraints: ScalingConstraints) -> bool:
        """Should the fleet's batch lane be gated this tick?  Trips when
        the interactive lane's p95 (the collector's per-tier channel)
        crosses ``batch_gate_frac`` of its SLO; releases with 2:1
        hysteresis so a knife-edge tick doesn't flap the gate — batch
        requests stay queued while gated, they are never dropped."""
        p95_i = float(metrics.get("latency_p95_interactive", 0.0))
        trip = constraints.batch_gate_frac * constraints.slo_ms
        self._batch_gated = (p95_i > 0.5 * trip if self._batch_gated
                             else p95_i > trip)
        return self._batch_gated

    # --- the decision step (paper pseudocode shape) ----------------------

    def compute_scaling_decision(self, metrics: dict,
                                 constraints: ScalingConstraints,
                                 *, current_replicas: int) -> ScalingDecision:
        current_load = self.analyze_current_load(metrics)
        predicted_load = self.predict_future_load(metrics)
        resource_efficiency = self.calculate_efficiency(current_load, metrics)
        # per-replica transport latency, streamed in via the collector's
        # fleet record; sub-deadband values (loopback noise) are dropped so
        # in-process and local-socket fleets plan identically
        transport_ms = float(metrics.get("transport_ms", 0.0))
        if transport_ms < constraints.transport_deadband_frac \
                * constraints.slo_ms:
            transport_ms = 0.0

        decision = self.optimizer.optimize(
            current_load=current_load,
            predicted_load=predicted_load,
            efficiency=resource_efficiency,
            constraints=constraints,
            current_replicas=current_replicas,
            transport_ms=transport_ms,
        )
        # scale-down damping: up fast, down slow.  A down decision must be
        # (a) SUSTAINED — the optimizer proposed a lower target for
        # `down_sustain` consecutive ticks (one-tick dips from forecast noise
        # or adaptation knob moves must not drain warm replicas), and
        # (b) rate-limited by the cooldown (never faster than provisioning).
        self._tick += 1
        if decision.delta < 0:
            self._below_count += 1
            sustained = self._below_count >= self.down_sustain
            cooled = (self._tick - self._last_downscale
                      >= constraints.cooldown_ticks)
            if not (sustained and cooled):
                return ScalingDecision(
                    target_replicas=current_replicas, delta=0,
                    reason="cooldown" if sustained else "down_hysteresis",
                    predicted_load=predicted_load,
                    predicted_latency_ms=decision.predicted_latency_ms,
                    efficiency=resource_efficiency)
            self._last_downscale = self._tick
            self._below_count = 0
        else:
            self._below_count = 0
        return decision
