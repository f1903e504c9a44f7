"""Rollout management with canary analysis and automatic rollback (§3.4.2).

The paper's RolloutManager:

    canary_metrics = await self.deploy_canary(deployment_config)
    if self.analyze_canary_health(canary_metrics):
        return await self.complete_rollout(deployment_config)
    else:
        return await self.initiate_rollback(deployment_config)

Implemented as a tick-driven state machine (the simulator advances time, so
"await" becomes state transitions — semantically identical, and testable).
Canary health is a proper statistical gate (paper: "sophisticated statistical
methods"):

  * latency: one-sided Welch t-test, canary vs control samples, α=0.01,
    plus a practical-significance guard (≥5% regression required to fail —
    pure statistical significance on huge samples must not block);
  * errors: one-sided binomial z-test on error counts;
  * resources: utilization regression beyond tolerance fails the gate.

Rollback restores the previous version on the already-provisioned replicas
(fast path: weights still resident → stream only the delta).

A numpy copy of ``repro.core.orchestration.rollout``.
"""
from __future__ import annotations

import dataclasses
import math
from enum import Enum

import numpy as np

from repro_torch.core.orchestration.strategies import (
    CATALOG, DeployEnv, Strategy, stage_deploy_seconds,
)


class Phase(Enum):
    IDLE = "idle"
    DEPLOYING = "deploying"
    SOAKING = "soaking"
    COMPLETED = "completed"
    ROLLED_BACK = "rolled_back"


@dataclasses.dataclass
class CanarySample:
    latencies_ms: np.ndarray
    n_requests: int
    n_errors: int
    utilization: float


def welch_t_pvalue_one_sided(a: np.ndarray, b: np.ndarray) -> float:
    """P(mean(a) > mean(b) by chance) — small p ⇒ canary (a) worse."""
    na, nb = len(a), len(b)
    if na < 3 or nb < 3:
        return 1.0
    va, vb = a.var(ddof=1) + 1e-12, b.var(ddof=1) + 1e-12
    t = (a.mean() - b.mean()) / math.sqrt(va / na + vb / nb)
    df = (va / na + vb / nb) ** 2 / (
        (va / na) ** 2 / (na - 1) + (vb / nb) ** 2 / (nb - 1))
    # normal approximation of the t CDF is fine at the sample sizes involved
    return 0.5 * math.erfc(t / math.sqrt(2.0)) if df > 30 else \
        0.5 * math.erfc(t / math.sqrt(2.0) * (1 - 1 / (4 * df)))


def binomial_z_pvalue(err_c: int, n_c: int, err_b: int, n_b: int) -> float:
    """One-sided: canary error rate > baseline error rate?"""
    if n_c == 0 or n_b == 0:
        return 1.0
    p_pool = (err_c + err_b) / (n_c + n_b)
    se = math.sqrt(p_pool * (1 - p_pool) * (1 / n_c + 1 / n_b)) + 1e-12
    z = (err_c / n_c - err_b / n_b) / se
    return 0.5 * math.erfc(z / math.sqrt(2.0))


@dataclasses.dataclass
class HealthPolicy:
    alpha: float = 0.01
    min_latency_regression: float = 0.05     # practical significance
    max_error_rate_delta: float = 0.002
    max_util_regression: float = 0.15


class CanaryAnalyzer:
    def __init__(self, policy: HealthPolicy = HealthPolicy()):
        self.policy = policy

    def analyze(self, canary: CanarySample, control: CanarySample) -> dict:
        p = self.policy
        verdicts = {}
        lat_p = welch_t_pvalue_one_sided(canary.latencies_ms,
                                         control.latencies_ms)
        regression = (canary.latencies_ms.mean()
                      / max(control.latencies_ms.mean(), 1e-9) - 1.0)
        verdicts["latency_ok"] = not (lat_p < p.alpha
                                      and regression > p.min_latency_regression)
        err_p = binomial_z_pvalue(canary.n_errors, canary.n_requests,
                                  control.n_errors, control.n_requests)
        delta = (canary.n_errors / max(canary.n_requests, 1)
                 - control.n_errors / max(control.n_requests, 1))
        verdicts["errors_ok"] = not (err_p < p.alpha
                                     and delta > p.max_error_rate_delta)
        verdicts["resources_ok"] = (
            canary.utilization <= control.utilization * (1 + p.max_util_regression)
            + 0.05)
        verdicts["healthy"] = all(
            verdicts[k] for k in ("latency_ok", "errors_ok", "resources_ok"))
        verdicts["latency_p"] = lat_p
        verdicts["error_p"] = err_p
        return verdicts


@dataclasses.dataclass
class RolloutState:
    phase: Phase = Phase.IDLE
    stage_idx: int = 0
    soak_left: int = 0
    traffic_frac: float = 0.0
    elapsed_s: float = 0.0
    rolled_back: bool = False
    health_log: list = dataclasses.field(default_factory=list)


class RolloutManager:
    """Tick-driven rollout with per-stage canary gates and auto-rollback."""

    def __init__(self, strategy: Strategy | str, env: DeployEnv,
                 analyzer: CanaryAnalyzer | None = None):
        self.strategy = (CATALOG[strategy] if isinstance(strategy, str)
                         else strategy)
        self.env = env
        self.analyzer = analyzer or CanaryAnalyzer()
        self.state = RolloutState()

    def start(self):
        s = self.state
        s.phase = Phase.DEPLOYING
        s.stage_idx = 0
        s.elapsed_s = stage_deploy_seconds(self.env,
                                           self.strategy.stages[0])
        s.traffic_frac = self.strategy.stages[0]
        s.soak_left = self.strategy.soak_ticks
        if s.soak_left:
            s.phase = Phase.SOAKING
        else:
            self._advance_or_finish()
        return s

    def tick(self, canary: CanarySample | None = None,
             control: CanarySample | None = None):
        """Advance one tick; during soak, gate on canary health."""
        s = self.state
        if s.phase != Phase.SOAKING:
            return s
        s.elapsed_s += self.env.tick_s
        if canary is not None and control is not None:
            verdict = self.analyzer.analyze(canary, control)
            s.health_log.append(verdict)
            if not verdict["healthy"]:
                return self._rollback()
        s.soak_left -= 1
        if s.soak_left <= 0:
            self._advance_or_finish()
        return s

    def _advance_or_finish(self):
        s = self.state
        if s.stage_idx + 1 >= len(self.strategy.stages):
            s.phase = Phase.COMPLETED
            s.traffic_frac = 1.0
            return s
        prev = self.strategy.stages[s.stage_idx]
        s.stage_idx += 1
        frac = self.strategy.stages[s.stage_idx]
        s.elapsed_s += stage_deploy_seconds(self.env, frac - prev)
        s.traffic_frac = frac
        s.soak_left = self.strategy.soak_ticks
        s.phase = Phase.SOAKING if s.soak_left else Phase.COMPLETED
        if s.phase == Phase.COMPLETED:
            s.traffic_frac = 1.0
        return s

    def _rollback(self):
        s = self.state
        # previous weights still resident on the untouched fleet: only the
        # canary replicas restore — a fraction of one stage's deploy time
        s.elapsed_s += 0.5 * stage_deploy_seconds(
            self.env, self.strategy.stages[s.stage_idx])
        s.phase = Phase.ROLLED_BACK
        s.rolled_back = True
        s.traffic_frac = 0.0
        return s
