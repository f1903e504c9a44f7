"""The port's orchestration, adaptation and simulator pieces against the JAX
package's, on the CPU.

- The strategy catalog, ``DeployEnv`` and the deploy-time model equal
  exactly; ``DecisionTreeSelector`` equal on hypothesis-drawn contexts and
  on one context per branch of its tree; ``OutcomeStats`` equal.
- Welch's and the binomial p-values within 1e-12; ``RolloutManager``'s
  state after every tick equal for healthy, latency-regressed,
  tiny-regression and error-spike canaries (the reference's own cases).
- ``AdaptiveOptimizer``'s knobs equal after every window.
- ``generate_trace``, ``Cluster`` (scaling, cancelling cold replicas first,
  failures, region costs) and the baselines equal exactly.
- ``DNNSelector`` at bridged weights: the strategy head's logits within
  1e-5 and the same choices, before and after its ``min_trained`` gate and
  under the rollback penalty.
- At weights the reference pretrained on a one-deployment trace (the
  deployment stream's running variance decayed, so evaluation-mode
  BatchNorm amplifies rounding up to 316×), bridged into the port: the
  strategy logits within 1e-4 of their size and the same choices; the
  first live DQN loss within 1e-4 of its size, and with
  ``exact_deploy_stream`` twelve live losses within 1e-3 of theirs.
"""
import copy
import dataclasses

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core.allocation.rl import DQNAgent as RefAgent
from repro.core.dnn import traces as ref_traces
from repro.core.dnn.model import DNNConfig as RefDNNConfig
from repro.core.dnn.model import MultiStreamDNN as RefDNN
from repro.core.monitoring.adapt import AdaptiveOptimizer as RefAdapt
from repro.core.orchestration import rollout as ref_rollout
from repro.core.orchestration import selector as ref_selector
from repro.core.orchestration import strategies as ref_strategies
from repro.core.scaling.scaler import ScalingConstraints as RefConstraints
from repro.sim import baseline as ref_baseline
from repro.sim import cluster as ref_cluster
from repro.sim import workload as ref_workload

import repro.sim
import repro_torch.sim
from repro_torch.core.allocation.rl import DQNAgent
from repro_torch.core.dnn.model import DNNConfig, dnn_from_reference
from repro_torch.core.monitoring import AdaptiveOptimizer
from repro_torch.core.orchestration import rollout, selector, strategies
from repro_torch.core.scaling.scaler import ScalingConstraints
from repro_torch.sim import baseline, cluster, workload

from test_torch_dnn import DQN_TOL
# exact_deploy_stream: the fixture, reached through request
from test_torch_traces import allocators, exact_deploy_stream, trace  # noqa: F401

P_TOL = 1e-12
LOGIT_TOL = 1e-5
ENVS = [dict(params_bytes=1e9, chips_per_replica=16, n_replicas=8),
        dict(params_bytes=6.2e9, chips_per_replica=1, n_replicas=4,
             hbm_fill_gbps=24.5, compile_cache_hit=False, tick_s=1.0)]


def env_pair(kw):
    return ref_strategies.DeployEnv(**kw), strategies.DeployEnv(**kw)


# ----------------------------------------------------------- strategies


def test_catalog_equals_reference():
    assert strategies.STRATEGY_NAMES == ref_strategies.STRATEGY_NAMES
    assert {k: dataclasses.asdict(v) for k, v in strategies.CATALOG.items()} \
        == {k: dataclasses.asdict(v)
            for k, v in ref_strategies.CATALOG.items()}
    fields = lambda cls: [(f.name, f.default)
                          for f in dataclasses.fields(cls)]
    assert fields(strategies.DeployEnv) == fields(ref_strategies.DeployEnv)


@pytest.mark.parametrize("env", range(len(ENVS)))
@pytest.mark.parametrize("name", list(strategies.CATALOG))
def test_deploy_seconds_equal_reference(name, env):
    ref_env, port_env = env_pair(ENVS[env])
    assert strategies.total_deploy_seconds(
        strategies.CATALOG[name], port_env) == \
        ref_strategies.total_deploy_seconds(
            ref_strategies.CATALOG[name], ref_env)
    for frac in strategies.CATALOG[name].stages:
        assert strategies.stage_deploy_seconds(port_env, frac) == \
            ref_strategies.stage_deploy_seconds(ref_env, frac)


# ------------------------------------------------------------- selector


def ctx_pair(**kw):
    return (ref_selector.DeploymentContext(**kw),
            selector.DeploymentContext(**kw))


BASE_CTX = dict(model_params_b=3.0, traffic_rps=50.0, slo_ms=200.0,
                error_budget=0.01, spare_capacity_frac=0.2,
                cost_sensitivity=0.5, is_critical=True)
# one context per leaf of the tree, in the tree's order
BRANCHES = {
    "all_at_once": dict(is_critical=False, traffic_rps=5.0),
    "transport_critical": dict(transport_ms=30.0),
    "transport_rolling": dict(transport_ms=30.0, is_critical=False),
    "huge_canary": dict(model_params_b=70.0),
    "huge_rolling": dict(model_params_b=70.0, spare_capacity_frac=0.05),
    "shadow": dict(error_budget=1e-4, spare_capacity_frac=0.6,
                   cost_sensitivity=0.2),
    "strict_canary": dict(error_budget=1e-4, spare_capacity_frac=0.6),
    "blue_green": dict(spare_capacity_frac=1.0, cost_sensitivity=0.1),
    "critical": dict(),
    "critical_strict": dict(error_budget=1e-4),
    "rolling": dict(is_critical=False),
}
WANT = {"all_at_once": "all_at_once", "transport_critical": "canary_10",
        "transport_rolling": "rolling", "huge_canary": "canary_progressive",
        "huge_rolling": "rolling", "shadow": "shadow",
        "strict_canary": "canary_progressive", "blue_green": "blue_green",
        "critical": "canary_10", "critical_strict": "canary_progressive",
        "rolling": "rolling"}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_decision_tree_branches_equal_reference(branch):
    ref_ctx, ctx = ctx_pair(**{**BASE_CTX, **BRANCHES[branch]})
    got = selector.DecisionTreeSelector().select(ctx)
    assert got == ref_selector.DecisionTreeSelector().select(ref_ctx)
    assert got == WANT[branch]


@settings(max_examples=200, deadline=None)
@given(params=st.floats(0.1, 200.0), rps=st.floats(0.0, 500.0),
       slo=st.floats(10.0, 5000.0), budget=st.floats(0.0, 0.05),
       spare=st.floats(0.0, 2.0), cost=st.floats(0.0, 1.0),
       critical=st.booleans(), transport=st.floats(0.0, 1000.0))
def test_decision_tree_equals_reference(params, rps, slo, budget, spare, cost,
                                        critical, transport):
    ref_ctx, ctx = ctx_pair(
        model_params_b=params, traffic_rps=rps, slo_ms=slo,
        error_budget=budget, spare_capacity_frac=spare,
        cost_sensitivity=cost, is_critical=critical, transport_ms=transport)
    assert selector.DecisionTreeSelector().select(ctx) == \
        ref_selector.DecisionTreeSelector().select(ref_ctx)


def test_outcome_stats_equal_reference():
    ref, port = ref_selector.OutcomeStats(), selector.OutcomeStats()
    rng = np.random.default_rng(0)
    for _ in range(40):
        s = strategies.STRATEGY_NAMES[int(rng.integers(6))]
        kw = dict(deploy_s=float(rng.uniform(100, 900)),
                  rolled_back=bool(rng.random() < 0.3))
        ref.record(s, **kw)
        port.record(s, **kw)
        assert port.deploy_s == ref.deploy_s
        assert port.runs == ref.runs and port.rollbacks == ref.rollbacks
    for s in strategies.STRATEGY_NAMES:
        assert port.rollback_rate(s) == ref.rollback_rate(s)


# ----------------------------------------------------- canary analysis


@pytest.mark.parametrize("na,nb,shift", [(2, 50, 0.0), (5, 8, 3.0),
                                         (40, 40, 0.5), (400, 400, 30.0),
                                         (5000, 5000, 2.0)])
def test_welch_pvalue_equals_reference(na, nb, shift):
    rng = np.random.default_rng(na + nb)
    a = rng.normal(100 + shift, 10, na)
    b = rng.normal(100, 10, nb)
    got = rollout.welch_t_pvalue_one_sided(a, b)
    assert abs(got - ref_rollout.welch_t_pvalue_one_sided(a, b)) <= P_TOL


@pytest.mark.parametrize("counts", [(40, 1000, 5, 1000), (6, 1000, 5, 1000),
                                    (0, 0, 3, 100), (0, 100, 0, 100),
                                    (12, 300, 1, 5000)])
def test_binomial_pvalue_equals_reference(counts):
    got = rollout.binomial_z_pvalue(*counts)
    assert abs(got - ref_rollout.binomial_z_pvalue(*counts)) <= P_TOL


def samples(rng, lat_mean, err_rate=0.001, util=0.6, n=400):
    """One canary sample as (reference's, port's), from one draw."""
    lat = rng.normal(lat_mean, 8, n)
    kw = dict(n_requests=n, n_errors=int(err_rate * n), utilization=util)
    return (ref_rollout.CanarySample(latencies_ms=lat, **kw),
            rollout.CanarySample(latencies_ms=lat, **kw))


# name → (strategy, seed, canary kwargs, control kwargs, ticks, final phase)
ROLLOUTS = {
    "healthy": ("canary_10", 1, dict(lat_mean=100), dict(lat_mean=100), 20,
                "completed"),
    "latency_regressed": ("canary_10", 2, dict(lat_mean=150),
                          dict(lat_mean=100), 20, "rolled_back"),
    "tiny_regression": ("canary_10", 3, dict(lat_mean=102, n=5000),
                        dict(lat_mean=100, n=5000), 20, "completed"),
    "error_spike": ("canary_progressive", 4,
                    dict(lat_mean=100, err_rate=0.05),
                    dict(lat_mean=100, err_rate=0.001), 30, "rolled_back"),
    "util_regressed": ("rolling", 5, dict(lat_mean=100, util=0.95),
                       dict(lat_mean=100, util=0.6), 20, "rolled_back"),
    "all_at_once": ("all_at_once", 6, dict(lat_mean=100),
                    dict(lat_mean=100), 5, "completed"),
    "shadow": ("shadow", 7, dict(lat_mean=100), dict(lat_mean=100), 20,
               "completed"),
}


def state_of(s) -> dict:
    d = dataclasses.asdict(s)
    d["phase"] = s.phase.value
    return d


@pytest.mark.parametrize("env", range(len(ENVS)))
@pytest.mark.parametrize("case", list(ROLLOUTS))
def test_rollout_sequence_equals_reference(case, env):
    name, seed, canary, control, ticks, final = ROLLOUTS[case]
    ref_env, port_env = env_pair(ENVS[env])
    ref = ref_rollout.RolloutManager(name, ref_env)
    port = rollout.RolloutManager(name, port_env)
    assert state_of(port.start()) == state_of(ref.start())
    rng = np.random.default_rng(seed)
    for _ in range(ticks):
        if port.state.phase in (rollout.Phase.COMPLETED,
                                rollout.Phase.ROLLED_BACK):
            break
        (rc, pc), (rb, pb) = samples(rng, **canary), samples(rng, **control)
        assert state_of(port.tick(pc, pb)) == state_of(ref.tick(rc, rb))
    assert port.state.phase.value == final
    # a tick past the end, or without samples, leaves the state alone
    assert state_of(port.tick()) == state_of(ref.tick())


# ---------------------------------------------------------- adaptation


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_adaptive_optimizer_equals_reference(seed):
    ref, port = RefAdapt(eval_window=4), AdaptiveOptimizer(eval_window=4)
    rng = np.random.default_rng(seed)
    for _ in range(120):
        rec = {"flop_util": float(rng.random())}
        kw = dict(flapped=bool(rng.random() < 0.2),
                  violations=int(rng.integers(3)), cost=float(rng.random()))
        ref.push(rec, **kw)
        port.push(rec, **kw)
        got, want = port.maybe_adapt(), ref.maybe_adapt()
        assert (got is None) == (want is None)
        assert dataclasses.asdict(port.state) == dataclasses.asdict(ref.state)
    c, rc = port.constraints(ScalingConstraints()), \
        ref.constraints(RefConstraints())
    assert (c.cooldown_ticks, c.target_util) == \
        (rc.cooldown_ticks, rc.target_util)


# ------------------------------------------------------------ simulator


@pytest.mark.parametrize("region", ref_workload.REGIONS)
@pytest.mark.parametrize("spiky", [False, True])
def test_generate_trace_equals_reference(region, spiky):
    kw = dict(region=region, ticks_per_day=96, seed=3)
    if spiky:
        kw["spike_prob"] = 0.05
    got = workload.generate_trace(workload.TraceConfig(**kw), 96 * 7)
    want = ref_workload.generate_trace(ref_workload.TraceConfig(**kw),
                                       96 * 7)
    assert np.array_equal(got, want)
    assert workload.REGIONS == ref_workload.REGIONS


def replicas(c):
    return [dataclasses.astuple(r) for r in c.replicas]


def cluster_script(mod, provider, region, seed):
    """Scale up, advance, scale down with cold replicas in flight (cancelled
    first), fail and replace → (replica lists, spend, ready) after each."""
    c = mod.Cluster(provider=provider, region=region, seed=seed, tick_s=60.0)
    out = []
    for target in (4, 6, 3, 8, 2):
        c.scale_to(target)
        out.append((replicas(c), c.ready_replicas(), c.total_replicas()))
        for _ in range(3):
            c.advance(fail_prob=0.05)
        out.append((replicas(c), c.spend_usd, c.cost_per_tick()))
    c.replace(0)
    c.replace(99)                 # out of range: no-op
    out.append((replicas(c), c._next_id))
    return out


@pytest.mark.parametrize("provider,region", [("gcp", "na"), ("aws", "eu"),
                                             ("azure", "au"), ("gcp", "sa")])
def test_cluster_equals_reference(provider, region):
    assert cluster.PROVIDERS == ref_cluster.PROVIDERS
    assert cluster.REGION_COST_MULT == ref_cluster.REGION_COST_MULT
    assert cluster_script(cluster, provider, region, 1) == \
        cluster_script(ref_cluster, provider, region, 1)


def test_cluster_cancels_cold_replicas_first():
    c = cluster.Cluster(seed=0, tick_s=60.0)
    c.scale_to(2)
    c.tick = 10 ** 6              # both warm
    warm = {r.id for r in c.replicas}
    c.scale_to(4)                 # two cold
    c.scale_to(2)
    assert {r.id for r in c.replicas} == warm


def test_baselines_equal_reference():
    ref_t, port_t = ref_baseline.ThresholdAutoscaler(patience=2), \
        baseline.ThresholdAutoscaler(patience=2)
    rng = np.random.default_rng(0)
    cur_r = cur_p = 4
    for _ in range(200):
        m = {"flop_util": float(rng.random())}
        cur_r, cur_p = ref_t.decide(m, cur_r), port_t.decide(m, cur_p)
        assert cur_p == cur_r
    assert dataclasses.asdict(baseline.TRADITIONAL_STRATEGY) == \
        dataclasses.asdict(ref_baseline.TRADITIONAL_STRATEGY)
    for kw in ENVS:
        ref_env, port_env = env_pair(kw)
        for gate in (0.0, 300.0):
            assert baseline.traditional_deploy_seconds(
                port_env, operator_gate_s=gate) == \
                ref_baseline.traditional_deploy_seconds(
                    ref_env, operator_gate_s=gate)
    perf = lambda r, rps: (100.0 + 50.0 * rps / r, min(rps / (10 * r), 1.0))
    for load in (1.0, 40.0, 400.0):
        assert baseline.StaticAllocator(
            sized_for=load, perf_model=perf, slo_ms=200.0).decide({}) == \
            ref_baseline.StaticAllocator(
                sized_for=load, perf_model=perf, slo_ms=200.0).decide({})


def test_sim_package_exports():
    assert set(repro_torch.sim.__all__) <= set(repro.sim.__all__)
    for name in repro_torch.sim.__all__:
        assert hasattr(repro_torch.sim, name)


# ------------------------------------------------------------ DNN head

SMALL_DNN = dict(window=8)


def selectors(min_trained):
    ref_agent = RefAgent(RefDNNConfig(**SMALL_DNN), seed=0)
    agent = DQNAgent(DNNConfig(**SMALL_DNN), seed=0, device="cpu")
    agent.load_reference(jax.tree.map(np.asarray, ref_agent.params),
                         jax.tree.map(np.asarray, ref_agent.bn_state))
    return (ref_selector.DNNSelector(ref_agent, None,
                                     min_trained=min_trained),
            selector.DNNSelector(agent, None, min_trained=min_trained))


def snapshot(seed):
    cfg = DNNConfig(**SMALL_DNN)
    rng = np.random.default_rng(seed)
    return {"resource": rng.normal(size=(1, cfg.window,
                                         cfg.n_resource_features)
                                   ).astype(np.float32),
            "perf": rng.normal(size=(1, cfg.window, cfg.n_perf_features)
                               ).astype(np.float32),
            "deploy": rng.normal(size=(1, cfg.n_deploy_features)
                                 ).astype(np.float32)}


@pytest.mark.parametrize("min_trained", [1, 4, 64])
def test_dnn_selector_equals_reference(min_trained):
    ref, port = selectors(min_trained)
    assert port.min_trained == min_trained
    for i, branch in enumerate(BRANCHES):
        ref_ctx, ctx = ctx_pair(**{**BASE_CTX, **BRANCHES[branch]})
        s = snapshot(i)
        assert port.select(ctx, s) == ref.select(ref_ctx, s)
        assert port.n_labels == ref.n_labels
        assert port.labels[-1][1] == ref.labels[-1][1]
        out, _ = RefDNN.apply(ref.agent.params, ref.agent.bn_state, s,
                              training=False)
        want = np.asarray(out["strategy_logits"][0])
        np.testing.assert_allclose(port.strategy_logits(s), want,
                                   atol=LOGIT_TOL, rtol=0)


def test_dnn_selector_rollback_penalty_equals_reference():
    ref, port = selectors(1)
    s = snapshot(0)
    ref_ctx, ctx = ctx_pair(**BASE_CTX)
    first = port.select(ctx, s)
    assert first == ref.select(ref_ctx, s)
    # the head's choice rolls back every time: the penalty demotes it
    for sel in (ref, port):
        sel.stats.record(first, deploy_s=600.0, rolled_back=True)
    second = port.select(ctx, s)
    assert second == ref.select(ref_ctx, s)
    assert second != first


# ------------------------------------- at weights pretrained on a trace


def pretrained_pair():
    """The reference's allocator pretrained on a 14-tick trace at
    ``pretrain_on_trace``'s defaults (one deployment vector in every row,
    as a recorded trace gives it), and the port's carrying the same
    weights, target, BatchNorm state, replay buffer and generator state;
    both optimizers fresh."""
    ref, port = allocators()
    ref_traces.pretrain_on_trace(ref, trace(14))
    agent = port.agent
    agent.load_reference(jax.tree.map(np.asarray, ref.agent.params),
                         jax.tree.map(np.asarray, ref.agent.bn_state))
    target, _ = dnn_from_reference(
        jax.tree.map(np.asarray, ref.agent.target_params),
        jax.tree.map(np.asarray, ref.agent.bn_state), agent.dnn_cfg,
        device="cpu")
    agent.target.load_state_dict(target.state_dict())
    agent.buffer = copy.deepcopy(ref.agent.buffer)
    agent.rng.bit_generator.state = ref.agent.rng.bit_generator.state
    ref.agent.opt_state = ref.agent.opt_init(ref.agent.params)
    return ref, port


def relative_gap(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float((np.abs(got - want) / np.maximum(1.0, np.abs(want))).max())


@pytest.mark.parametrize("exact", [False, True],
                         ids=["as_it_runs", "exact_deploy_stream"])
def test_pretrained_weights_amplify_rounding_as_the_reference_does(exact,
                                                                   request):
    """One-deployment pretraining drives the deployment stream's running
    variance toward 0, so evaluation-mode BatchNorm multiplies each side's
    rounding of x − running mean by up to 1/sqrt(eps) ≈ 316.  At one set of
    such weights the reference and the port must agree to 1e-4 of each
    value's size (at least 1): the strategy logits and choices on the
    trace's snapshots, and the first live DQN step's loss from one buffer,
    target and draw.  With identical rows computed exactly the following
    live steps train in evaluation-mode targets too; their losses are held
    to 1e-3 of their size (as it runs, training mode's own noise parts them
    after the first step)."""
    if exact:
        request.getfixturevalue("exact_deploy_stream")
    ref, port = pretrained_pair()
    var = np.asarray(ref.agent.bn_state["bn2"]["var"])
    assert 1 / np.sqrt(var.min() + 1e-5) > 100       # the amplification
    recs = trace(14)
    snaps = ref_traces.replay_streams(recs, ref.deploy_vec, window=8)
    ref_sel = ref_selector.DNNSelector(ref.agent, None, min_trained=1)
    sel = selector.DNNSelector(port.agent, None, min_trained=1)
    _, ctx = ctx_pair(**BASE_CTX)
    want, got = [], []
    for s in snaps:
        out, _ = RefDNN.apply(ref.agent.params, ref.agent.bn_state, s,
                              training=False)
        want.append(np.asarray(out["strategy_logits"][0]))
        got.append(sel.strategy_logits(s))
        assert sel.select(ctx, s) == ref_sel.select(ctx_pair(**BASE_CTX)[0],
                                                    s)
    print(f"logits up to {np.abs(want).max():.4g}: |port - reference| "
          f"{np.abs(np.subtract(got, want)).max():.3g}, relative "
          f"{relative_gap(got, want):.3g}")
    assert relative_gap(got, want) <= DQN_TOL
    bs = min(ref.agent.cfg.batch_size, ref.agent.buffer.n)
    steps = 12 if exact else 1
    want = [ref.agent._train_on_batch(ref.agent.buffer.sample(ref.agent.rng,
                                                               bs))
            for _ in range(steps)]
    got = [port.agent._train_on_batch(port.agent.buffer.sample(
        port.agent.rng, bs)) for _ in range(steps)]
    print(f"{steps} live losses {want[0]:.4g}..{want[-1]:.4g}: |port - "
          f"reference| {np.abs(np.subtract(got, want)).max():.3g}, relative "
          f"{relative_gap(got, want):.3g} (first step "
          f"{relative_gap(got[:1], want[:1]):.3g})")
    assert relative_gap(got[:1], want[:1]) <= DQN_TOL
    assert relative_gap(got, want) <= 1e-3, (got, want)
