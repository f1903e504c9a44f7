"""The port's fleet-trace recording, replay and offline pretraining against
the JAX package's, on the CPU.

- ``TraceRecorder`` writes the reference's JSONL byte for byte and reads
  it back; ``replay_streams``, ``supervised_dataset``, ``transitions`` and
  ``action_index`` equal exactly (numpy on both sides).
- ``fill_replay`` fills the replay buffer as the reference's does.
- ``pretrain_on_trace`` at bridged weights on ``_trace(8)`` (the
  reference's learning-loop trace).  A trace carries one deployment vector
  in every row, so each training-mode BatchNorm of the deployment stream
  normalises identical rows: in exact arithmetic its output is its bias and
  every leaf before it, and ``bn2.bias`` behind its ReLU at 0, gets zero
  gradient; in float32 each side gets its own rounding noise there, which
  AdamW turns into steps of up to 1.2·lr, and which ``bn2.bias``'s ReLU
  carries into the trunk, so the two sides' losses part by more than 1e-4
  within a few steps.  So the run is held twice.  With both BatchNorms
  computing identical rows exactly (``exact_deploy_stream``: mean = the
  first row, variance 0, no gradient through the centring; the same
  instrumentation on both sides): every phase's losses, every parameter,
  the target net and the BatchNorm state within 1e-4.  As it runs: the
  schedule exactly (phase lengths, transitions, replay and shuffle draws,
  the warm-started allocator), the first loss within 1e-4 and the
  noise-driven leaves within Adam's step bound summed over the phases.
- The reference's ``test_recorded_trace_pretrains_and_redeploys_hybrid``,
  port against reference on one seed, as it runs and with
  ``exact_deploy_stream``: the planner traces equal, then the hybrid
  loops' TickLogs equal up to the first tick whose decision margin (the gap
  between the two best Q-values among the actions the SLO envelope admits)
  is under 10× the largest port/reference Q gap on the recorded states at
  the pretrained weights, and ``learn_loss`` within 1e-4 there.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.allocation.allocator import AllocatorConfig as RefAllocCfg
from repro.core.allocation.allocator import PredictiveAllocator as RefAlloc
from repro.core.dnn import traces as ref_traces
from repro.core.dnn.features import deploy_vector as ref_deploy_vector
from repro.core.dnn.model import DNNConfig as RefDNNConfig
from repro.core.scaling.scaler import ScalingConstraints as RefConstraints
from repro.serving.closed_loop import LoopConfig as RefLoopConfig
from repro.serving.closed_loop import run_closed_loop as ref_run
from repro.sim.serving import WorkloadSpec as RefWorkloadSpec
from repro.nn import BatchNorm as RefBatchNorm

from repro_torch.configs import get_smoke_config
from repro_torch.core.allocation.allocator import (
    AllocatorConfig, PredictiveAllocator,
)
from repro_torch.core.allocation.rl import ACTIONS, DQNConfig
from repro_torch.core.dnn import traces
from repro_torch.core.dnn.features import deploy_vector
from repro_torch.core.dnn.model import DNNConfig
from repro_torch.core.scaling.scaler import ScalingConstraints
from repro_torch.models.bridge import from_reference
from repro_torch.nn import BatchNorm
from repro_torch.serving.closed_loop import LoopConfig, run_closed_loop
from repro_torch.sim.serving import WorkloadSpec

from test_torch_checks import (
    MARGIN_FACTOR, SAME_ATOL, SAME_RTOL, decision_log, decision_margin,
    exact_bn_forward,
)
from test_torch_closed_loop import ref_lm, trajectory
from test_torch_dnn import (
    ADAM_STEP, DQN_TOL, UNDETERMINED_ONE_DEPLOYMENT, flat,
)

ARCH = "qwen2.5-3b"
WINDOW = 8                    # the reference's SMALL_DNN
DEPLOY_KW = dict(model_params_b=1.0, family="dense", mesh_model=1,
                 mesh_data=1, region_idx=0, slo_ms=200.0, cost_weight=0.5)
DEPLOY = deploy_vector(**DEPLOY_KW)
_REF_BN_APPLY = RefBatchNorm.apply


def tick_rec(tick, *, rps=1.0, lat=100.0, util=0.5, delta=0, cost=1.0):
    """The reference learning-loop tests' ``_tick_rec``."""
    return {"tick": tick, "rps": rps, "flop_util": util, "hbm_util": util,
            "ici_util": 0.0, "mem_frac": util, "queue_depth": 0.0,
            "replicas_frac": 0.25, "latency_p50": lat, "latency_p95": lat,
            "throughput": rps, "error_rate": 0.0, "transport_ms": 0.0,
            "action_delta": delta, "cost_per_tick": cost}


def trace(n=8):
    """The reference learning-loop tests' ``_trace``."""
    return [tick_rec(t, rps=1.0 + t, lat=80.0 + 10 * t, util=0.3 + 0.05 * t,
                     delta=(1 if t == 2 else 0), cost=1.0 + (t >= 3))
            for t in range(n)]


def equal_trees(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            equal_trees(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            equal_trees(x, y)
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------ recording


def test_recorder_round_trips_reference_jsonl(tmp_path):
    recs = trace(5) + [{"reason": "dqn:1", "rps_window": [1.0, 2.5],
                        "anomaly": 0.0, "evictions": 2.0}]
    ref, port = ref_traces.TraceRecorder(), traces.TraceRecorder()
    for r in recs:
        ref.record(r)
        port.record(r)
    ref.save(tmp_path / "ref.jsonl")
    port.save(tmp_path / "port.jsonl")
    assert (tmp_path / "port.jsonl").read_bytes() == \
        (tmp_path / "ref.jsonl").read_bytes()
    back = traces.TraceRecorder.load(tmp_path / "ref.jsonl")
    assert len(back) == len(recs)
    assert back.records == ref_traces.TraceRecorder.load(
        tmp_path / "port.jsonl").records == ref.records


def test_recorder_copies_records():
    rec, r = traces.TraceRecorder(), tick_rec(0)
    rec.record(r)
    r["rps"] = 99.0
    assert rec.records[0]["rps"] == 1.0


@pytest.mark.parametrize("n", [2, 6, 40])
def test_replay_and_datasets_equal_reference(n):
    recs = trace(n)
    deploy = DEPLOY + 0.5
    equal_trees(traces.replay_streams(recs, deploy, window=WINDOW),
                ref_traces.replay_streams(recs, deploy, window=WINDOW))
    for kw in ({}, {"slo_ms": 90.0, "model_params_b": 70.0}):
        equal_trees(
            traces.supervised_dataset(recs, deploy, window=WINDOW, **kw),
            ref_traces.supervised_dataset(recs, deploy, window=WINDOW, **kw))
    kw = dict(window=WINDOW, slo_ms=150.0, cost_scale=4.0, w_util=0.5,
              w_lat=2.0, w_cost=0.3)
    equal_trees(traces.transitions(recs, deploy, **kw),
                ref_traces.transitions(recs, deploy, **kw))
    with pytest.raises(ValueError):
        traces.supervised_dataset(recs[:1], deploy)


def test_strategy_labels_reach_several_classes():
    """Labels from operating points that reach different leaves."""
    recs = [dict(r, rps=rps, transport_ms=tm, flop_util=u)
            for r, (rps, tm, u) in zip(trace(4), [(1.0, 0.0, 0.5),
                                                  (50.0, 100.0, 0.2),
                                                  (50.0, 0.0, 0.1),
                                                  (5.0, 0.0, 0.0)])]
    got = [traces._strategy_label(r, model_params_b=m, slo_ms=200.0)
           for r in recs for m in (1.0, 70.0)]
    want = [ref_traces._strategy_label(r, model_params_b=m, slo_ms=200.0)
            for r in recs for m in (1.0, 70.0)]
    assert got == want and len(set(got)) > 1


@pytest.mark.parametrize("delta", [-9, -4, -3, -1.5, 0, 0.4, 1, 3, 4, 12])
def test_action_index_equals_reference(delta):
    assert traces.action_index(delta) == ref_traces.action_index(delta)
    assert ACTIONS[traces.action_index(delta)] in ACTIONS


# ------------------------------------------------------------ pretraining


def allocators(**kw):
    """A reference allocator and the port's (SMALL_DNN, hybrid), the port's
    agent loaded with the reference's initial weights."""
    perf = lambda r, rps: (50.0, 0.5)
    cons = dict(min_replicas=1, max_replicas=4, slo_ms=200.0)
    ref = RefAlloc(perf, RefConstraints(**cons),
                   ref_deploy_vector(**DEPLOY_KW),
                   cfg=RefAllocCfg(mode="hybrid"),
                   dnn_cfg=RefDNNConfig(window=WINDOW), seed=0)
    port = PredictiveAllocator(perf, ScalingConstraints(**cons), DEPLOY,
                               cfg=AllocatorConfig(mode="hybrid"),
                               dnn_cfg=DNNConfig(window=WINDOW), seed=0,
                               device="cpu")
    port.agent.load_reference(jax.tree.map(np.asarray, ref.agent.params),
                              jax.tree.map(np.asarray, ref.agent.bn_state))
    return ref, port


def test_fill_replay_equals_reference():
    ref, port = allocators()
    recs = trace(8)
    tr = traces.transitions(recs, DEPLOY, window=WINDOW)
    assert traces.fill_replay(port.agent, tr) == \
        ref_traces.fill_replay(ref.agent, ref_traces.transitions(
            recs, ref_deploy_vector(**DEPLOY_KW), window=WINDOW)) == 7
    rb, pb = ref.agent.buffer, port.agent.buffer
    assert (pb.n, pb.i) == (rb.n, rb.i)
    for k in pb.data:
        assert np.array_equal(pb.data[k], rb.data[k])
        assert np.array_equal(pb.data2[k], rb.data2[k])
    for k in ("action", "reward", "done"):
        assert np.array_equal(getattr(pb, k), getattr(rb, k))


def pretrain_steps(out) -> float:
    """lr × steps summed over the phases, in units of the supervised and
    imitation lr (1e-3; the DQN steps at its own): what Adam's step bound
    is multiplied by."""
    return (len(out["supervised"]) + len(out["imitation"])
            + len(out["dqn"]) * DQNConfig().lr / 1e-3)


def _exact_bn_ref(params, state, x, *, training, momentum=0.9, eps=1e-5):
    if not training:
        return _REF_BN_APPLY(params, state, x, training=False,
                             momentum=momentum, eps=eps)
    jnp = jax.numpy
    axes = tuple(range(x.ndim - 1))
    rows = x.reshape(-1, x.shape[-1])
    same = jnp.all(jnp.isclose(rows, rows[:1], rtol=SAME_RTOL,
                               atol=SAME_ATOL), axis=0)
    mean = jnp.where(same, rows[0], jnp.mean(x, axis=axes))
    var = jnp.where(same, 0.0, jnp.var(x, axis=axes))
    new_state = {"mean": momentum * state["mean"] + (1 - momentum) * mean,
                 "var": momentum * state["var"] + (1 - momentum) * var,
                 "count": state["count"] + 1.0}
    y = jnp.where(same, 0.0, x - mean) * jax.lax.rsqrt(var + eps)
    return y * params["scale"] + params["bias"], new_state


@pytest.fixture
def exact_deploy_stream(monkeypatch):
    """Both sides' BatchNorm computes a feature whose rows are equal (to
    float32 rounding) as exact arithmetic would (``_exact_bn_ref`` is
    ``test_torch_checks.exact_bn_forward`` in JAX)."""
    monkeypatch.setattr(RefBatchNorm, "apply", staticmethod(_exact_bn_ref))
    monkeypatch.setattr(BatchNorm, "forward", exact_bn_forward)


def assert_pretrained_equal(ref, port, tol=DQN_TOL):
    """Every parameter, the target net and the BatchNorm state within tol;
    the generators' states equal."""
    for tree, mine in ((ref.params, port.params),
                       (ref.target_params, port.target_params)):
        want = flat(jax.tree.map(np.asarray, tree))
        for name, p in mine.items():
            np.testing.assert_allclose(p.detach().numpy(), want[name],
                                       atol=tol, rtol=0, err_msg=name)
    for bn in ("bn1", "bn2"):
        for k in ("mean", "var", "count"):
            np.testing.assert_allclose(port.bn_state[bn][k].numpy(),
                                       np.asarray(ref.bn_state[bn][k]),
                                       atol=tol, rtol=0, err_msg=bn + k)
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state


SCHEDULES = {"defaults": {},
             "short_cold_streams": dict(epochs=3, imitation_epochs=2,
                                        dqn_steps=5, warm_streams=False)}


def assert_schedule_equal(ref, port, want, got):
    assert got["transitions"] == want["transitions"] == 7
    for phase in ("supervised", "dqn", "imitation"):
        assert len(got[phase]) == len(want[phase]) > 0, phase
    assert port.agent.cfg.warmup == ref.agent.cfg.warmup \
        <= port.agent.buffer.n
    assert port.agent.rng.bit_generator.state == \
        ref.agent.rng.bit_generator.state
    for k in port.agent.buffer.data:
        assert np.array_equal(port.agent.buffer.data[k],
                              ref.agent.buffer.data[k])
    assert len(port.streams.res_hist) == len(ref.streams.res_hist)
    for k, v in port.streams.streams(port.deploy_vec).items():
        assert np.array_equal(v, ref.streams.streams(ref.deploy_vec)[k]), k


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_pretrain_on_trace_equals_reference(schedule, exact_deploy_stream):
    ref, port = allocators()
    recs = trace(8)
    want = ref_traces.pretrain_on_trace(ref, recs, **SCHEDULES[schedule])
    got = traces.pretrain_on_trace(port, recs, **SCHEDULES[schedule])
    assert_schedule_equal(ref, port, want, got)
    for phase in ("supervised", "dqn", "imitation"):
        np.testing.assert_allclose(got[phase], want[phase], atol=DQN_TOL,
                                   rtol=0, err_msg=phase)
    assert_pretrained_equal(ref.agent, port.agent)
    # the deployment stream's leaves took no step but weight decay
    for name in ("dep1.b", "bn1.scale", "bn1.bias", "bn2.scale", "bn2.bias"):
        assert np.array_equal(port.agent.params[name].detach().numpy(),
                              flat(jax.tree.map(np.asarray, ref.agent.params
                                                ))[name]), name


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_pretrain_on_trace_as_it_runs(schedule):
    ref, port = allocators()
    recs = trace(8)
    want = ref_traces.pretrain_on_trace(ref, recs, **SCHEDULES[schedule])
    got = traces.pretrain_on_trace(port, recs, **SCHEDULES[schedule])
    assert_schedule_equal(ref, port, want, got)
    assert abs(got["supervised"][0] - want["supervised"][0]) <= DQN_TOL
    bound = 2 * ADAM_STEP * 1e-3 * pretrain_steps(got)
    want_p = flat(jax.tree.map(np.asarray, ref.agent.params))
    for name, rows in UNDETERMINED_ONE_DEPLOYMENT.items():
        got_p = port.agent.params[name].detach().numpy()
        err = np.abs(got_p[rows] - want_p[name][rows]).max()
        assert err <= DQN_TOL + bound, (name, err)


def test_entry_points_default_to_cuda():
    """The allocator, and so pretrain_on_trace, fit and DNNSelector over
    its agent, run on cuda unless asked for the CPU: without a card the
    default raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        PredictiveAllocator(lambda r, rps: (50.0, 0.5),
                            ScalingConstraints(), DEPLOY,
                            dnn_cfg=DNNConfig(window=WINDOW))


def test_pretrain_imitation_loss_decreases():
    _, port = allocators()
    out = traces.pretrain_on_trace(port, trace(8), epochs=2,
                                   imitation_epochs=2, dqn_steps=3)
    assert len(out["supervised"]) == 2 and len(out["dqn"]) == 3
    assert out["imitation"][-1] < out["imitation"][0]


# ------------------------------------------- record → pretrain → hybrid


@functools.lru_cache(maxsize=None)
def recorded_planner_traces():
    """The planner loop on both sides, 6 ticks, recorded; the reference
    agent's initial weights kept for the port's."""
    kw = dict(max_replicas=2)
    ref_lc, lc = RefLoopConfig(**kw), LoopConfig(**kw)
    ref_spec, spec = RefWorkloadSpec(8, 4), WorkloadSpec(8, 4)
    cfg = get_smoke_config(ARCH)
    params = from_reference(ref_lm(lc.max_seq), cfg, device="cpu")
    ref_rec, port_rec = ref_traces.TraceRecorder(), traces.TraceRecorder()
    initial = {}

    def keep_initial(alloc):
        initial["params"] = jax.tree.map(np.asarray, alloc.agent.params)
        initial["bn"] = jax.tree.map(np.asarray, alloc.agent.bn_state)

    router, _ = ref_run(ref_smoke_config(ARCH), ticks=6, seed=0, lc=ref_lc,
                        spec=ref_spec, recorder=ref_rec,
                        prime_allocator=keep_initial)
    router.close()
    router, _ = run_closed_loop(cfg, ticks=6, seed=0, lc=lc, spec=spec,
                                recorder=port_rec, params=params,
                                device="cpu")
    router.close()
    return (ref_lc, lc, ref_spec, spec, cfg, params, initial, ref_rec,
            port_rec)


@pytest.mark.parametrize("exact", [False, True],
                         ids=["as_it_runs", "exact_deploy_stream"])
def test_recorded_trace_pretrains_and_redeploys_hybrid(exact, request):
    """Record a planner trace on both sides, pretrain on it at bridged
    weights, then run the learned policy as the hybrid scaler on the same
    seed (the reference's own end-to-end test, ported).  The TickLogs are
    held up to the first tick whose decision margin, on either side, is
    under MARGIN_FACTOR × the largest Q gap on the recorded states at the
    pretrained weights; as it runs that gap is the deployment stream's
    noise, with ``exact_deploy_stream`` rounding only."""
    if exact:
        request.getfixturevalue("exact_deploy_stream")
    (ref_lc, lc, ref_spec, spec, cfg, params, initial, ref_rec,
     port_rec) = recorded_planner_traces()
    assert len(port_rec) == 6 and port_rec.records == ref_rec.records

    q, logs_q = {}, {"ref": [], "port": []}

    def pretrained(side, alloc, pretrain, records):
        pretrain(alloc, records, epochs=1, imitation_epochs=1, dqn_steps=2)
        snaps = traces.replay_streams(records, alloc.deploy_vec,
                                      window=alloc.dnn_cfg.window)
        q[side] = np.stack([np.asarray(alloc.agent.q_values(s))
                            for s in snaps])
        decision_log(alloc, logs_q[side])

    def port_prime(alloc):
        alloc.agent.load_reference(initial["params"], initial["bn"])
        pretrained("port", alloc, traces.pretrain_on_trace, port_rec.records)

    router, want = ref_run(
        ref_smoke_config(ARCH), ticks=4, seed=0,
        lc=dataclasses.replace(ref_lc, alloc_mode="hybrid"), spec=ref_spec,
        prime_allocator=lambda a: pretrained(
            "ref", a, ref_traces.pretrain_on_trace, ref_rec.records))
    router.close()
    router, got = run_closed_loop(
        cfg, ticks=4, seed=0, lc=dataclasses.replace(lc, alloc_mode="hybrid"),
        spec=spec, prime_allocator=port_prime, params=params, device="cpu")
    router.close()
    assert len(got) == len(want) == 4
    assert all(1 <= t.replicas <= 2 for t in got)
    assert any(t.reason.startswith("dqn:") for t in got)
    gap = float(np.abs(q["port"] - q["ref"]).max())
    if exact:
        assert gap <= DQN_TOL
    margins = [min(decision_margin(*a), decision_margin(*b))
               for a, b in zip(logs_q["ref"], logs_q["port"])]
    held = next((i for i, m in enumerate(margins)
                 if m < MARGIN_FACTOR * gap), len(got))
    assert held > 0, (gap, margins)
    assert trajectory(got)[:held] == trajectory(want)[:held], (held, margins)
    for a, b in zip(want[:held], got[:held]):
        assert (a.learn_loss is None) == (b.learn_loss is None)
        if a.learn_loss is not None:
            assert abs(a.learn_loss - b.learn_loss) <= DQN_TOL
