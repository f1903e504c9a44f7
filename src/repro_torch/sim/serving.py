"""Roofline-grounded serving performance model (the data-plane stand-in the
control plane optimizes against): a copy of ``repro.sim.serving``.

A *replica* is one card (the reference's: one 16-chip model-parallel
group); the port's dry-run cells are one card's share of the reference's
decode_32k and prefill_32k cells (``repro_torch.launch.dryrun``), so
per-replica numbers fall straight out of the measured cell with the
reference's arithmetic:

  slots/replica      = global_batch / data_axis
  decode step time   = max(compute, memory, collective roofline terms)
  tokens/s/replica   = slots / step_time

Request latency = TTFT (prefill, scaled by prompt/32k) + gen_len·step +
M/M/c queueing wait at the current arrival rate; overload ⇒ queue growth ⇒
timeouts counted as errors.  All knobs the paper's experiments vary (RPS,
replicas, batch slots) are explicit arguments.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.sim.roofline_db import RooflineDB


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    """Request shape shared by the queueing model AND the real data plane:
    serving/workload.py builds engine Requests from the same spec the
    planner's perf model is parameterized by, so closed-loop runs optimize
    against the workload they serve."""
    prompt_len: int = 1024
    gen_len: int = 128
    timeout_factor: float = 4.0      # × SLO before a request is dropped


@dataclasses.dataclass(frozen=True)
class ServiceProfile:
    """Per-replica capability derived from the roofline DB."""
    arch: str
    chips_per_replica: int
    slots: int                       # concurrent decode slots per replica
    decode_step_s: float             # one token for all slots
    prefill_32k_s: float             # whole-replica prefill of 32k tokens
    bottleneck: str

    @classmethod
    def from_db(cls, db: RooflineDB, arch: str, *, data_axis: int = 16,
                model_axis: int = 1) -> "ServiceProfile":
        dec = db.terms(arch, "decode_32k")
        pre = db.terms(arch, "prefill_32k")
        from repro_torch.models import SHAPES
        slots = SHAPES["decode_32k"].global_batch // data_axis
        # the prefill_32k cell runs global_batch prompts across data_axis
        # replicas in step_time ⇒ one replica prefills (global_batch/data_axis)
        # 32k-prompts per step ⇒ a single 32k prompt ≈ step_time / that.
        per_replica_batch = SHAPES["prefill_32k"].global_batch / data_axis
        return cls(arch=arch, chips_per_replica=model_axis, slots=slots,
                   decode_step_s=dec.step_time,
                   prefill_32k_s=pre.step_time / per_replica_batch,
                   bottleneck=dec.bottleneck)

    def tokens_per_s(self) -> float:
        return self.slots / self.decode_step_s

    def relative_speed(self, baseline: "ServiceProfile") -> float:
        """Decode throughput relative to another service — the seed for a
        heterogeneous fleet's ReplicaProfile.speed (serving/profiles.py)."""
        return self.tokens_per_s() / max(baseline.tokens_per_s(), 1e-12)

    def requests_per_s(self, w: WorkloadSpec) -> float:
        """Steady-state request service rate per replica."""
        t_req = self.request_service_s(w)
        return self.slots / t_req

    def prefill_s(self, prompt_len: int) -> float:
        return self.prefill_32k_s * prompt_len / 32768.0

    def request_service_s(self, w: WorkloadSpec) -> float:
        return self.prefill_s(w.prompt_len) + w.gen_len * self.decode_step_s


def mmc_wait_s(lam: float, mu: float, c: int) -> float:
    """Erlang-C mean wait.  lam: arrivals/s, mu: per-server rate, c servers."""
    if c <= 0 or mu <= 0:
        return float("inf")
    if lam <= 0.0:
        # an empty system has no queue — and the large-c normal
        # approximation below divides by sqrt(a)=0 (a diurnal trough in a
        # big region used to crash the multi-region benchmark here)
        return 0.0
    rho = lam / (c * mu)
    if rho >= 1.0:
        return float("inf")
    a = lam / mu
    # Erlang C probability of waiting
    s = sum(a ** k / math.factorial(k) for k in range(c)) if c < 120 else None
    if s is None:
        # large-c normal approximation of Erlang C
        from math import erfc, sqrt
        z = (c - a) / sqrt(a)
        pw = min(1.0, max(0.0, erfc(z / sqrt(2)) / 2 / max(rho, 1e-9)))
    else:
        last = a ** c / math.factorial(c) / (1 - rho)
        pw = last / (s + last)
    return pw / (c * mu - lam)


# Per-request latency dispersion around (service + wait): multiplicative
# 1 + Gamma(k=4, θ=GAMMA_SCALE).  P95_DISPERSION is the 95th percentile of
# that multiplier (1 + θ·gammaincinv(4, .95) ≈ 1 + 7.754·θ) — latency_util()
# and tick() must stay consistent, else the planner systematically misjudges
# realized p95.
GAMMA_SHAPE = 4.0
GAMMA_SCALE = 0.035
P95_DISPERSION = 1.0 + 7.754 * GAMMA_SCALE


@dataclasses.dataclass
class TickResult:
    latency_ms_samples: np.ndarray
    served: int
    errors: int
    utilization: float
    queue_depth: float
    tokens: int


class ServingModel:
    """Fleet-level tick simulation over the queueing model."""

    def __init__(self, profile: ServiceProfile, workload: WorkloadSpec,
                 *, slo_ms: float = 200.0, tick_s: float = 10.0,
                 seed: int = 0):
        self.p = profile
        self.w = workload
        self.slo_ms = slo_ms
        self.tick_s = tick_s
        self.rng = np.random.default_rng(seed)
        self.carry_queue = 0.0

    def latency_util(self, replicas: int, rps: float) -> tuple[float, float]:
        """PerfModel protocol for the DynamicScaler: (p95-ish ms, util)."""
        c = max(replicas, 1) * self.p.slots
        mu = 1.0 / self.p.request_service_s(self.w)
        lam = rps
        rho = min(lam / (c * mu), 0.999)
        wait = mmc_wait_s(lam, mu, c)
        # requests time out past timeout_factor×SLO, so the experienced wait
        # is bounded (also guards the near-saturation Erlang blow-up)
        max_wait = self.slo_ms / 1e3 * self.w.timeout_factor
        wait = min(wait, max_wait) if math.isfinite(wait) else max_wait
        base = self.p.request_service_s(self.w)
        p95 = (base + wait) * P95_DISPERSION
        return p95 * 1e3, rho

    def tick(self, replicas: int, rps: float) -> TickResult:
        c = max(replicas, 1) * self.p.slots
        mu = 1.0 / self.p.request_service_s(self.w)
        arrivals = self.rng.poisson(rps * self.tick_s) + self.carry_queue
        capacity = c * mu * self.tick_s
        served = min(arrivals, capacity)
        backlog = arrivals - served
        # requests beyond timeout_factor×SLO of queueing are dropped
        max_wait = self.slo_ms / 1e3 * self.w.timeout_factor
        droppable = backlog - c * mu * max_wait
        errors = max(0.0, droppable)
        self.carry_queue = backlog - errors
        rho = min(rps / (c * mu), 0.999)
        wait = mmc_wait_s(rps, mu, c)
        wait = min(wait, max_wait) if math.isfinite(wait) else max_wait
        base = self.p.request_service_s(self.w)
        n = max(int(min(served, 256)), 1)
        lat = (base + wait) * (1 + self.rng.gamma(GAMMA_SHAPE, GAMMA_SCALE,
                                                  size=n))
        util = rho
        return TickResult(latency_ms_samples=lat * 1e3,
                          served=int(served), errors=int(errors),
                          utilization=float(util),
                          queue_depth=float(self.carry_queue),
                          tokens=int(served * self.w.gen_len))
