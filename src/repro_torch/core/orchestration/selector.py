"""Automated strategy selection (paper §3.4.1, Fig. 7 decision tree).

Two selectors:
  * DecisionTreeSelector — the paper's Fig. 7 tree over model size, traffic
    criticality, risk tolerance, and spare capacity (the explainable
    baseline, and the teacher for DNN pretraining);
  * DNNSelector — the multi-stream DNN's strategy head, refined online from
    realized deployment outcomes (time, SLO impact, rollback events).

``repro.core.orchestration.selector`` line for line, but the strategy
head's forward: the agent's ``MultiStreamDNN`` in evaluation mode on the
agent's own device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.orchestration.strategies import CATALOG, STRATEGY_NAMES


@dataclasses.dataclass(frozen=True)
class DeploymentContext:
    model_params_b: float            # billions
    traffic_rps: float
    slo_ms: float
    error_budget: float              # fraction of requests allowed to fail
    spare_capacity_frac: float       # free fleet fraction right now
    cost_sensitivity: float          # 0 = perf-first, 1 = cost-first
    is_critical: bool                # user-facing production traffic?
    # per-replica transport latency (ms) from the replica fabric's streamed
    # reports — how remote the fleet is.  0 for an in-process fleet.
    transport_ms: float = 0.0


class DecisionTreeSelector:
    """Fig. 7: size gate → criticality gate → capacity gate → cost gate,
    extended with a transport gate: when reaching a replica already costs a
    material slice of the SLO, strategies that double cross-fleet traffic
    (shadow mirroring, blue/green full-fleet flips) are off the table —
    in-place rolling/canary deploys touch each remote replica once."""

    def select(self, ctx: DeploymentContext) -> str:
        if not ctx.is_critical and ctx.traffic_rps < 10:
            # internal / low-traffic: speed over safety
            return "all_at_once"
        if ctx.transport_ms > 0.1 * ctx.slo_ms:
            return "canary_10" if ctx.is_critical else "rolling"
        if ctx.model_params_b >= 40:
            # huge models: capacity for blue/green rarely exists
            if ctx.spare_capacity_frac >= 0.10:
                return "canary_progressive"
            return "rolling"
        if ctx.error_budget < 0.001 and ctx.spare_capacity_frac >= 0.5:
            # strict budget + lots of headroom: shadow first
            return "shadow" if ctx.cost_sensitivity < 0.5 else "canary_progressive"
        if ctx.spare_capacity_frac >= 1.0 and ctx.cost_sensitivity < 0.3:
            return "blue_green"
        if ctx.is_critical:
            return "canary_10" if ctx.error_budget >= 0.001 else "canary_progressive"
        return "rolling"


class OutcomeStats:
    """Per-strategy EWMA of realized outcomes; lets the DNN selector and the
    adaptive optimizer rank strategies by evidence, not priors."""

    def __init__(self):
        self.deploy_s = {s: None for s in STRATEGY_NAMES}
        self.rollbacks = {s: 0 for s in STRATEGY_NAMES}
        self.runs = {s: 0 for s in STRATEGY_NAMES}

    def record(self, strategy: str, *, deploy_s: float, rolled_back: bool):
        prev = self.deploy_s[strategy]
        self.deploy_s[strategy] = (deploy_s if prev is None
                                   else 0.7 * prev + 0.3 * deploy_s)
        self.runs[strategy] += 1
        if rolled_back:
            self.rollbacks[strategy] += 1

    def rollback_rate(self, strategy: str) -> float:
        return self.rollbacks[strategy] / max(self.runs[strategy], 1)


class DNNSelector:
    """Strategy head of the multi-stream DNN + decision-tree fallback.

    Until the head has been trained on enough outcomes (min_trained), the
    tree decides and its choices are the training labels — the supervised
    pretraining path noted in DESIGN.md §10."""

    def __init__(self, agent, deploy_vec_fn, *, min_trained: int = 64):
        self.agent = agent            # shares the allocator's DQNAgent trunk
        self.deploy_vec_fn = deploy_vec_fn
        self.tree = DecisionTreeSelector()
        self.stats = OutcomeStats()
        self.n_labels = 0
        self.min_trained = min_trained
        self.labels: list[tuple[dict, int]] = []

    def select(self, ctx: DeploymentContext, streams) -> str:
        tree_choice = self.tree.select(ctx)
        self.labels.append((streams, STRATEGY_NAMES.index(tree_choice)))
        self.n_labels += 1
        if self.n_labels < self.min_trained:
            return tree_choice
        scores = self.strategy_logits(streams)
        # evidence penalty: strategies that rolled back get demoted
        for i, s in enumerate(STRATEGY_NAMES):
            scores[i] -= 4.0 * self.stats.rollback_rate(s)
        return STRATEGY_NAMES[int(np.argmax(scores))]

    @torch.no_grad()
    def strategy_logits(self, streams) -> np.ndarray:
        """The strategy head's logits for one snapshot, as numpy."""
        out, _ = self.agent.net(self.agent.bn_state,
                                self.agent._tensors(streams), training=False)
        return out["strategy_logits"][0].cpu().numpy().copy()
