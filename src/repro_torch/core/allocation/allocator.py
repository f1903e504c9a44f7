"""Predictive resource allocation (paper §3.3.1).

The PredictiveAllocator fuses three signals into one scaling action per tick:

  1. the workload forecaster's peak prediction (proactive component),
  2. the DynamicScaler's constrained optimum (model-based planner),
  3. the DQN's learned Q-values over the same state (learning component,
     trained online from realized reward — "continuously improve allocation
     decisions based on deployment outcomes").

Mode "planner" uses (2) alone — this is the ablation baseline; mode "rl"
acts with the DQN but is *shielded* by the constraints (never violates
min/max/step); mode "hybrid" (default) lets the DQN choose among actions
whose planner-predicted latency meets the SLO — learned cost/utilization
trade-off inside a safety envelope.  The DQN is additionally pretrained by
imitating planner decisions (supervised Q-margin), which is what lets it act
sensibly before enough operational data accumulates (paper §5.3 notes the
cold-start limitation).

The ``repro.core.allocation.allocator`` logic line for line; the DQN agent
runs on the ``device`` it is given (cuda unless the caller asks for cpu).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.allocation.forecaster import WorkloadForecaster
from repro_torch.core.allocation.rl import (
    ACTIONS, DQNAgent, DQNConfig, reward_fn,
)
from repro_torch.core.dnn.features import StreamBuilder
from repro_torch.core.dnn.model import DNNConfig
from repro_torch.core.scaling.scaler import (
    DynamicScaler, ScalingConstraints, ScalingDecision,
)


@dataclasses.dataclass
class AllocatorConfig:
    mode: str = "hybrid"            # planner | rl | hybrid
    horizon_ticks: int = 3
    w_util: float = 1.0
    w_lat: float = 1.0
    w_cost: float = 1.0


class PredictiveAllocator:
    def __init__(self, perf_model, constraints: ScalingConstraints,
                 deploy_vec: np.ndarray, *, cfg: AllocatorConfig = None,
                 dnn_cfg: DNNConfig = None, seed: int = 0, device="cuda"):
        self.cfg = cfg or AllocatorConfig()
        self.constraints = constraints
        self.perf_model = perf_model
        self.deploy_vec = deploy_vec
        self.forecaster = WorkloadForecaster()
        self.scaler = DynamicScaler(self.forecaster, perf_model,
                                    horizon_ticks=self.cfg.horizon_ticks)
        self.dnn_cfg = dnn_cfg or DNNConfig()
        self.agent = DQNAgent(self.dnn_cfg, DQNConfig(), seed=seed,
                              device=device)
        self.streams = StreamBuilder(window=self.dnn_cfg.window)
        self._prev = None               # (state, action_idx)
        # the action credit-assignment chain starts defined: before the first
        # decide() the "last action" is hold (delta 0), and every decide()
        # path — DQN-chosen OR planner fallback — overwrites both fields
        self._pending_action = int(ACTIONS.index(0))
        self._pending_state = None
        self.replicas = constraints.min_replicas

    # ------------------------------------------------------------- tick

    def observe(self, metrics: dict):
        """Feed one monitoring tick (before deciding)."""
        self.forecaster.update(metrics.get("rps", 0.0))
        self.streams.push(metrics)

    def decide(self, metrics: dict) -> ScalingDecision:
        planner = self.scaler.compute_scaling_decision(
            metrics, self.constraints, current_replicas=self.replicas)
        state = self.streams.streams(self.deploy_vec)
        chosen = None
        if self.cfg.mode != "planner":
            q = self.agent.q_values(state)
            explore = (self.cfg.mode == "rl"
                       and self.agent.rng.random() < self.agent.epsilon())
            order = (self.agent.rng.permutation(len(ACTIONS)) if explore
                     else np.argsort(-q))
            c = self.constraints
            for ai in order:
                r = self.replicas + ACTIONS[ai]
                if not (c.min_replicas <= r <= c.max_replicas):
                    continue
                lat, util = self.perf_model(r, planner.predicted_load)
                # hybrid's envelope is the SLO itself: when NO action meets
                # it (infeasible spike), the DQN must not get to pick a
                # smaller scale-up than the planner's max-headroom response
                # — fall through to the planner instead.  "rl" is shielded
                # by the min/max range only (the pure learned policy).
                if self.cfg.mode == "rl" or lat <= c.slo_ms:
                    chosen = (int(ai), r, lat, util)
                    break
        self._pending_state = state
        if chosen is None:
            # planner mode, or the DQN path fell through its safety envelope:
            # the planner's decision is what gets actuated, so the action the
            # next reward credits is the planner's delta — NOT whatever the
            # DQN picked on some earlier tick
            decision = planner
            self._pending_action = int(np.argmin(
                [abs(a - decision.delta) for a in ACTIONS]))
        else:
            ai, r, lat, util = chosen
            decision = ScalingDecision(
                target_replicas=r, delta=r - self.replicas,
                reason=f"dqn:{ACTIONS[ai]}",
                predicted_load=planner.predicted_load,
                predicted_latency_ms=lat, efficiency=planner.efficiency)
            self._pending_action = ai
        return decision

    def apply(self, decision: ScalingDecision):
        self.replicas = decision.target_replicas

    def learn(self, metrics: dict, cost_per_tick: float):
        """Reward from the realized outcome of the last action."""
        if self._pending_state is None:
            return None                 # no decide() yet — nothing to credit
        if self._prev is None:
            self._prev = (self._pending_state, self._pending_action)
            return None
        r = reward_fn(
            utilization=metrics.get("flop_util", 0.0),
            latency_ms=metrics.get("latency_p95", 0.0),
            slo_ms=self.constraints.slo_ms,
            cost_per_tick=cost_per_tick,
            cost_scale=(self.constraints.max_replicas
                        * self.constraints.cost_per_replica),
            w_util=self.cfg.w_util, w_lat=self.cfg.w_lat,
            w_cost=self.cfg.w_cost)
        s, a = self._prev
        s2 = self.streams.streams(self.deploy_vec)
        loss = self.agent.observe(s, a, r, s2)
        self._prev = (self._pending_state, self._pending_action)
        return loss
