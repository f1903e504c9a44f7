"""Fleet-trace recording and replay — the paper's learning loop, closed.

The serving fleet emits everything §3.2's feature streams ask for (collector
aggregates, transport_ms, evictions, anomaly flags, paged-pool prefix
counters); the DNN/DQN trained only on simulated features.  This module is
the bridge:

  * ``TraceRecorder`` — one dict per control tick, appended by
    ``run_closed_loop`` (serving/closed_loop.py) when recording is on;
    JSONL-serializable, round-trips through ``save``/``load``.
  * ``replay_streams`` — re-runs a recorded trace through a fresh
    ``StreamBuilder`` (the SAME windowing + running-norm path the live
    allocator feeds ``agent.observe``), yielding one stream snapshot per
    tick — shapes identical to live ``alloc.decide`` inputs.
  * ``supervised_dataset`` — (streams, alloc_target, strategy_target)
    stacks shaped for ``core/dnn/train.fit``: the alloc head regresses the
    realized NEXT-tick utilization + replica fraction; the strategy head is
    labeled by the decision-tree selector evaluated retrospectively.
  * ``transitions`` / ``fill_replay`` — (s, a, r, s2, done) tuples shaped
    exactly like the live ``PredictiveAllocator.learn`` path (reward from
    the next tick's realized metrics, credited to the recorded action),
    pushed into a ``DQNAgent``'s ReplayBuffer.
  * ``pretrain_on_trace`` — the offline training recipe: supervised
    ``train.fit`` on the trace (shared trunk), Q-head imitation of the
    recorded planner actions (cold start, paper §5.3), then DQN replay —
    after which the allocator can act as the scaler in ``mode="hybrid"``.

``repro.core.dnn.traces`` line for line around the port's ``train.fit`` and
``DQNAgent``: every training step runs on the allocator's agent's device.
"""
from __future__ import annotations

import json

import numpy as np

from repro_torch.core.dnn.features import StreamBuilder
from repro_torch.core.dnn.train import fit
from repro_torch.core.orchestration.selector import (
    DecisionTreeSelector, DeploymentContext,
)
from repro_torch.core.orchestration.strategies import STRATEGY_NAMES


class TraceRecorder:
    """Accumulates per-tick fleet records (plain dicts of scalars/lists).

    ``record`` copies the dict so later mutation by the loop can't reach
    back into the trace; ``save``/``load`` round-trip through JSONL — one
    record per line, human-greppable, append-friendly."""

    def __init__(self):
        self.records: list[dict] = []

    def record(self, rec: dict):
        self.records.append(dict(rec))

    def __len__(self):
        return len(self.records)

    def save(self, path):
        with open(path, "w") as f:
            for rec in self.records:
                f.write(json.dumps(rec, sort_keys=True) + "\n")

    @classmethod
    def load(cls, path) -> "TraceRecorder":
        out = cls()
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    out.records.append(json.loads(line))
        return out


def replay_streams(records, deploy_vec, *, window: int = 32) -> list[dict]:
    """→ one ``{"resource","perf","deploy"}`` snapshot per tick, each shaped
    (1,T,F)/(1,F) — exactly what the live allocator's StreamBuilder hands
    ``agent.q_values``/``agent.observe`` after observing that tick."""
    sb = StreamBuilder(window=window)
    out = []
    for rec in records:
        sb.push(rec)
        out.append(sb.streams(np.asarray(deploy_vec, np.float32)))
    return out


def _stack(snapshots, idx) -> dict:
    return {k: np.concatenate([snapshots[i][k] for i in idx], axis=0)
            for k in ("resource", "perf", "deploy")}


def _strategy_label(rec: dict, *, model_params_b: float, slo_ms: float) -> int:
    """Retrospective strategy class: the decision-tree selector evaluated on
    the tick's realized operating point (the repo's strategy oracle)."""
    ctx = DeploymentContext(
        model_params_b=model_params_b,
        traffic_rps=float(rec.get("rps", 0.0)),
        slo_ms=slo_ms,
        error_budget=0.01,
        spare_capacity_frac=max(1.0 - float(rec.get("flop_util", 0.0)), 0.0),
        cost_sensitivity=0.5,
        is_critical=True,
        transport_ms=float(rec.get("transport_ms", 0.0)),
    )
    return STRATEGY_NAMES.index(DecisionTreeSelector().select(ctx))


def supervised_dataset(records, deploy_vec, *, window: int = 32,
                       slo_ms: float = 200.0,
                       model_params_b: float = 1.0) -> dict:
    """Trace → ``train.fit`` dataset.  Row t pairs the streams AFTER
    observing tick t with tick t+1's realized outcome: the alloc head
    learns to forecast next-window (flop, hbm, ici, replicas_frac); the
    strategy head the retrospectively-selected deployment strategy."""
    if len(records) < 2:
        raise ValueError("supervised_dataset needs >= 2 recorded ticks")
    snaps = replay_streams(records, deploy_vec, window=window)
    idx = range(len(records) - 1)
    alloc_t = np.asarray(
        [[float(records[t + 1].get(k, 0.0))
          for k in ("flop_util", "hbm_util", "ici_util", "replicas_frac")]
         for t in idx], np.float32)
    strat_t = np.asarray(
        [_strategy_label(records[t + 1], model_params_b=model_params_b,
                         slo_ms=slo_ms) for t in idx], np.int32)
    return {"streams": _stack(snaps, idx), "alloc_target": alloc_t,
            "strategy_target": strat_t}


def action_index(delta: float) -> int:
    """Nearest discrete ACTIONS index to a recorded replica delta."""
    # allocation.rl imports dnn.model, so dnn/__init__ can't import rl at
    # module scope without a cycle — resolve it at call time instead
    from repro_torch.core.allocation.rl import ACTIONS
    return int(np.argmin([abs(a - delta) for a in ACTIONS]))


def transitions(records, deploy_vec, *, window: int = 32,
                slo_ms: float = 200.0, cost_scale: float = 1.0,
                w_util: float = 1.0, w_lat: float = 1.0,
                w_cost: float = 1.0) -> list[tuple]:
    """Trace → DQN transitions, mirroring the live ``learn()`` chain: the
    action recorded at tick t is credited with the reward realized at tick
    t+1, between the stream snapshots after observing each tick."""
    # cycle: see action_index
    from repro_torch.core.allocation.rl import reward_fn
    snaps = replay_streams(records, deploy_vec, window=window)
    out = []
    for t in range(len(records) - 1):
        nxt = records[t + 1]
        r = reward_fn(
            utilization=float(nxt.get("flop_util", 0.0)),
            latency_ms=float(nxt.get("latency_p95", 0.0)),
            slo_ms=slo_ms,
            cost_per_tick=float(nxt.get("cost_per_tick", 0.0)),
            cost_scale=cost_scale,
            w_util=w_util, w_lat=w_lat, w_cost=w_cost)
        a = action_index(float(records[t].get("action_delta", 0.0)))
        done = t == len(records) - 2
        out.append((snaps[t], a, r, snaps[t + 1], done))
    return out


def fill_replay(agent, trans) -> int:
    """Push recorded transitions into the agent's ReplayBuffer (no training
    step — use ``agent.train_offline`` afterwards).  → transitions pushed."""
    for s, a, r, s2, done in trans:
        agent.buffer.push(s, a, r, s2, done)
    return len(trans)


def pretrain_on_trace(alloc, records, *, epochs: int = 20,
                      imitation_epochs: int = 30, dqn_steps: int = 60,
                      lr: float = 1e-3, seed: int = 0,
                      warm_streams: bool = True) -> dict:
    """Offline-train a ``PredictiveAllocator`` on a recorded fleet trace.

    Order matters: supervised ``fit`` shapes the shared trunk (alloc +
    strategy heads), DQN replay fits the Q head to the recorded rewards,
    and Q-head imitation of the recorded (planner) actions runs LAST so the
    cold-start policy the hybrid mode acts with is anchored to the planner
    — learned deviations then come from the value estimates, inside the
    safety envelope.  ``warm_streams`` additionally replays the trace into
    the allocator's live StreamBuilder so its running normalization matches
    what the nets were trained under.  → loss curves per phase."""
    agent = alloc.agent
    c = alloc.constraints
    kw = dict(window=alloc.dnn_cfg.window, slo_ms=c.slo_ms)
    ds = supervised_dataset(
        records, alloc.deploy_vec,
        model_params_b=float(10.0 ** (2.0 * alloc.deploy_vec[0])), **kw)
    agent.net, agent.bn_state, sup_losses = fit(
        agent.net, agent.bn_state, ds, epochs=epochs, lr=lr, seed=seed)
    trans = transitions(
        records, alloc.deploy_vec,
        cost_scale=c.max_replicas * c.cost_per_replica,
        w_util=alloc.cfg.w_util, w_lat=alloc.cfg.w_lat,
        w_cost=alloc.cfg.w_cost, **kw)
    fill_replay(agent, trans)
    dqn_losses = agent.train_offline(dqn_steps)
    snaps = replay_streams(records, alloc.deploy_vec,
                           window=alloc.dnn_cfg.window)
    acts = [action_index(float(r.get("action_delta", 0.0))) for r in records]
    imit_losses = agent.imitate(_stack(snaps, range(len(records))),
                                acts, epochs=imitation_epochs, lr=lr)
    # a pretrained agent is already warm: keep fine-tuning from the first
    # live tick instead of sitting out the online `warmup` fill all over
    # again (the buffer keeps the recorded transitions it trained on)
    agent.cfg.warmup = min(agent.cfg.warmup, max(agent.buffer.n, 1))
    if warm_streams:
        for rec in records:
            alloc.streams.push(rec)
    return {"supervised": sup_losses, "dqn": dqn_losses,
            "imitation": imit_losses, "transitions": len(trans)}
