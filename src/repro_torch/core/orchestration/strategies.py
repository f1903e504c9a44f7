"""Deployment-strategy catalog (paper §3.4.1), a numpy copy of
``repro.core.orchestration.strategies``.

Each strategy describes how a new model version reaches full traffic on a
fleet of accelerator replicas: staged traffic fractions, resource overhead
while both versions coexist, and the per-stage deployment work.  Deployment
*time* is a first-principles model: replica provisioning + checkpoint
streaming (bytes / per-device restore bandwidth) + compile-cache warmup +
per-stage health soak.  ``DeployEnv``'s defaults (``hbm_fill_gbps``,
``provision_s``, ``compile_warmup_s``) are model inputs, kept equal to the
reference's for parity; a caller that has measured its own fleet passes its
own values.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Strategy:
    name: str
    # traffic fraction served by the new version at each stage (ends at 1.0)
    stages: tuple[float, ...]
    # extra capacity (fraction of fleet) held during the rollout
    resource_overhead: float
    # soak time per stage (ticks) for canary health evaluation
    soak_ticks: int
    # blast radius: fraction of traffic exposed if the version is bad
    risk: float


CATALOG: dict[str, Strategy] = {
    "all_at_once":        Strategy("all_at_once", (1.0,), 0.0, 0, 1.00),
    "rolling":            Strategy("rolling", (0.25, 0.5, 0.75, 1.0), 0.10, 1, 0.25),
    "blue_green":         Strategy("blue_green", (1.0,), 1.00, 1, 0.10),
    "canary_10":          Strategy("canary_10", (0.10, 1.0), 0.10, 2, 0.10),
    "canary_progressive": Strategy("canary_progressive",
                                   (0.01, 0.05, 0.25, 1.0), 0.05, 2, 0.01),
    "shadow":             Strategy("shadow", (0.0, 1.0), 0.50, 3, 0.00),
}

STRATEGY_NAMES = tuple(CATALOG)


@dataclasses.dataclass(frozen=True)
class DeployEnv:
    """Environment facts the time model needs (inputs, not measurements:
    ``chips_per_replica`` counts the devices a replica spans)."""
    params_bytes: float             # checkpoint size
    chips_per_replica: int
    n_replicas: int
    hbm_fill_gbps: float = 100.0    # per-device restore bandwidth
    provision_s: float = 180.0      # replica acquisition / reschedule
    compile_warmup_s: float = 120.0 # persistent-cache miss penalty
    compile_cache_hit: bool = True
    tick_s: float = 10.0


def stage_deploy_seconds(env: DeployEnv, frac_replicas: float) -> float:
    """Time to bring up `frac_replicas` of the fleet on the new version."""
    n = max(1, round(env.n_replicas * frac_replicas))
    # replicas restore in parallel; each streams its shard-set onto
    # device memory
    stream_s = (env.params_bytes / env.chips_per_replica
                / (env.hbm_fill_gbps * 1e9))
    warmup = 0.0 if env.compile_cache_hit else env.compile_warmup_s
    del n  # parallel across replicas — wall time is per-replica
    return env.provision_s + stream_s + warmup


def total_deploy_seconds(strategy: Strategy, env: DeployEnv) -> float:
    """Wall-clock for a healthy rollout (no rollback)."""
    total = 0.0
    prev = 0.0
    for frac in strategy.stages:
        total += stage_deploy_seconds(env, frac - prev)
        total += strategy.soak_ticks * env.tick_s
        prev = frac
    return total
