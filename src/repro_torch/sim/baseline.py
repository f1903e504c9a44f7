"""The "traditional MLOps" baseline the paper compares against (§4.1.1).

Two variants, both faithful to the paper's description of current practice
("static rules and thresholds", "manual intervention", "reactive rather than
proactive"):

  * StaticAllocator — capacity fixed at sizing time (mean + k·σ of an
    observation window), never changes;
  * ThresholdAutoscaler — reactive rule: scale up max_step when utilization
    has exceeded hi for `patience` ticks, scale down 1 when below lo; no
    forecasting, so every response arrives one provisioning delay late.

Traditional deployment is modelled per the paper's 45-minute figure:
sequential per-stage bring-up, no compile cache, conservative soak times,
and manual approval gates between stages (modeled as fixed operator delay).

A numpy copy of ``repro.sim.baseline``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.orchestration.strategies import DeployEnv, Strategy


class StaticAllocator:
    def __init__(self, *, sized_for: float, perf_model, slo_ms: float,
                 max_replicas: int = 64):
        # size capacity so `sized_for` RPS meets the SLO — then freeze
        self.replicas = 1
        for r in range(1, max_replicas + 1):
            lat, _ = perf_model(r, sized_for)
            self.replicas = r
            if lat <= slo_ms:
                break

    def decide(self, metrics: dict) -> int:
        del metrics
        return self.replicas


@dataclasses.dataclass
class ThresholdAutoscaler:
    hi: float = 0.80
    lo: float = 0.30
    patience: int = 3
    max_step: int = 2
    min_replicas: int = 1
    max_replicas: int = 64
    _above: int = 0
    _below: int = 0

    def decide(self, metrics: dict, current: int) -> int:
        util = metrics.get("flop_util", 0.0)
        if util > self.hi:
            self._above += 1
            self._below = 0
        elif util < self.lo:
            self._below += 1
            self._above = 0
        else:
            self._above = self._below = 0
        if self._above >= self.patience:
            self._above = 0
            return min(current + self.max_step, self.max_replicas)
        if self._below >= self.patience:
            self._below = 0
            return max(current - 1, self.min_replicas)
        return current


TRADITIONAL_STRATEGY = Strategy("traditional_rolling",
                                (0.25, 0.5, 0.75, 1.0),
                                resource_overhead=0.10,
                                soak_ticks=6,       # conservative fixed soaks
                                risk=0.25)


def traditional_deploy_seconds(env: DeployEnv, *,
                               operator_gate_s: float = 300.0) -> float:
    """Sequential stages + no compile cache + manual approval gates."""
    import dataclasses as dc
    env = dc.replace(env, compile_cache_hit=False)
    from repro_torch.core.orchestration.strategies import stage_deploy_seconds
    total, prev = 0.0, 0.0
    for frac in TRADITIONAL_STRATEGY.stages:
        total += stage_deploy_seconds(env, frac - prev)
        total += TRADITIONAL_STRATEGY.soak_ticks * env.tick_s
        total += operator_gate_s                 # human approval
        prev = frac
    return total
