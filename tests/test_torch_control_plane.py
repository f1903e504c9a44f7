"""The port's numpy copies of the control plane against the JAX package's
modules, and its in-process router, on the CPU.

- The collector (stragglers, stale decay, fleet event channels), the anomaly
  detector, the scaler and ``EvictionPolicy``, the forecaster,
  ``StreamBuilder`` and ``deploy_vector``, ``FleetPlan`` and ``SpotMarket``,
  and the transport codecs are fed the same inputs, drawn from a numpy seed,
  on both sides: every output must be equal exactly (``==`` on floats,
  ``np.array_equal`` on arrays).
- ``ReplicaRouter`` (inproc) against the reference's on one request stream
  with mid-run scaling, at bridged weights: completion order, owning
  replica, token streams and reports equal.  Then the reference's router
  properties on the port alone, with hypothesis: no request lost or
  duplicated under random arrivals and mid-run scaling, throughput equal to
  completed tokens over wall time, and a downscale requeues in-flight work.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as ref_get_config
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.allocation.forecaster import (
    WorkloadForecaster as RefForecaster,
)
from repro.core.dnn.features import StreamBuilder as RefStreamBuilder
from repro.core.dnn.features import deploy_vector as ref_deploy_vector
from repro.core.monitoring.anomaly import AnomalyDetector as RefAnomaly
from repro.core.monitoring.anomaly import trend as ref_trend
from repro.core.monitoring.collector import MetricsCollector as RefCollector
from repro.core.monitoring.collector import ReplicaReport as RefReport
from repro.core.scaling.scaler import DynamicScaler as RefDynamicScaler
from repro.core.scaling.scaler import EvictionPolicy as RefEvictionPolicy
from repro.core.scaling.scaler import ScalingConstraints as RefConstraints
from repro.serving import ReplicaRouter as RefRouter
from repro.serving import Request as RefRequest
from repro.serving import SamplingParams as RefSamplingParams
from repro.serving import transport as ref_transport
from repro.serving.engine import EngineCore as RefEngineCore
from repro.serving.profiles import FleetPlan as RefFleetPlan
from repro.serving.profiles import SpotMarket as RefSpotMarket
from repro.serving.profiles import rtt_between as ref_rtt_between

from repro_torch.configs import ARCH_IDS, get_config, get_smoke_config
from repro_torch.core.allocation.forecaster import WorkloadForecaster
from repro_torch.core.dnn.features import StreamBuilder, deploy_vector
from repro_torch.core.monitoring.anomaly import AnomalyDetector, trend
from repro_torch.core.monitoring.collector import (
    MetricsCollector, ReplicaReport,
)
from repro_torch.core.scaling.scaler import (
    DynamicScaler, EvictionPolicy, ScalingConstraints,
)
from repro_torch.models.bridge import from_reference
from repro_torch.serving import (
    ReplicaRouter, Request, SamplingParams, transport,
)
from repro_torch.serving.engine import EngineCore
from repro_torch.serving.profiles import FleetPlan, SpotMarket, rtt_between

SEEDS = [0, 1, 2]


# ------------------------------------------------------------ the collector


def report_stream(seed, ticks=24, replicas=5):
    """Per tick, a report dict for each replica that reports: some stay
    silent for a while (stale decay, pruning past max_staleness), one
    straggles, some carry errors, tier samples and speculation counts."""
    rng = np.random.default_rng(seed)
    out = []
    for tick in range(ticks):
        reps = []
        for rid in range(replicas):
            if rng.random() < 0.25 or (rid == 4 and 5 <= tick < 16):
                continue                                  # silent this tick
            n = int(rng.integers(0, 6))
            base = 900.0 if rid == 2 and tick > 6 else 100.0
            lat = (base * (1 + rng.random(n))).tolist()
            tiers = ({"interactive": lat[: n // 2], "batch": lat[n // 2:]}
                     if rng.random() < 0.5 else None)
            reps.append(dict(
                replica_id=rid, tick=tick, latency_ms_samples=lat,
                n_requests=n, n_errors=int(rng.random() < 0.1),
                flop_util=float(rng.random()), hbm_util=float(rng.random()),
                ici_util=float(rng.random()), mem_frac=float(rng.random()),
                queue_depth=int(rng.integers(0, 9)),
                transport_ms=float(rng.random() * 3),
                spec_proposed=int(rng.integers(0, 5)),
                spec_accepted=int(rng.integers(0, 3)), lat_tiers=tiers))
        fleet = {k: float(tick // 3 + rng.integers(0, 2)) for k in
                 ("preemptions", "tier_spills", "region_spills")}
        out.append((tick, reps, fleet))
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_collector_equals_reference(seed):
    ref, port = RefCollector(max_staleness=4), MetricsCollector(
        max_staleness=4)
    for tick, reps, fleet in report_stream(seed):
        for d in reps:
            ref.submit(RefReport(**d))
            port.submit(ReplicaReport(**d))
        ref.observe_fleet(fleet)
        port.observe_fleet(fleet)
        kw = dict(n_replicas=len(reps), max_replicas=8)
        assert port.aggregate(tick, **kw) == ref.aggregate(tick, **kw)
        assert port.stragglers() == ref.stragglers()
        assert sorted(port.reports) == sorted(ref.reports)
    for key in ("latency_p95", "queue_depth", "throughput"):
        assert np.array_equal(port.window_values(key), ref.window_values(key))


# ------------------------------------------------------------- the anomaly


@pytest.mark.parametrize("seed", SEEDS)
def test_anomaly_detector_and_trend_equal_reference(seed):
    rng = np.random.default_rng(seed)
    ref, port = RefAnomaly(z_threshold=3.0, min_history=4), AnomalyDetector(
        z_threshold=3.0, min_history=4)
    series = rng.normal(10.0, 1.0, 120)
    series[rng.integers(0, 120, 8)] += rng.choice([-25.0, 25.0], 8)
    for tick, v in enumerate(series):
        m = {"rps": float(v), "lat": float(v * 3 + tick), "skip": "text"}
        got = [dataclasses.astuple(a) for a in port.update(tick, m)]
        want = [dataclasses.astuple(a) for a in ref.update(tick, m)]
        assert got == want
    assert port.level == ref.level and port.resid == ref.resid
    for n in (3, 10, 64, 120):
        assert trend(series[:n]) == ref_trend(series[:n])


# ------------------------------------------------------------- the scaler


def perf_model(replicas, rps):
    cap = max(replicas, 1) * 4 / 1.7
    util = min(rps / max(cap, 1e-9), 1.0)
    return 1700.0 * (1.0 + 3.0 * max(util - 0.8, 0.0) / 0.2), util


@pytest.mark.parametrize("seed", SEEDS)
def test_dynamic_scaler_equals_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(min_replicas=1, max_replicas=6, slo_ms=2000.0,
              slo_batch_ms=8000.0, batch_gate_frac=0.9)
    rc, pc = RefConstraints(**kw), ScalingConstraints(**kw)
    ref = RefDynamicScaler(RefForecaster(), perf_model)
    port = DynamicScaler(WorkloadForecaster(), perf_model)
    cost = lambda n: 0.4 * n + 0.6 * min(n, 2)
    ref.optimizer.cost_fn = port.optimizer.cost_fn = cost
    r_ref = r_port = 1
    for tick in range(40):
        rps = float(rng.choice([1.2, 7.0, 3.0]) * (0.5 + rng.random()))
        m = {"rps": rps, "rps_window": [rps, rps * 0.8, rps * 1.3],
             "flop_util": float(rng.random()), "hbm_util": 0.3,
             "ici_util": 0.0, "mem_frac": 0.5,
             "transport_ms": float(rng.choice([0.0, 10.0, 150.0])),
             "latency_p95_interactive": float(rng.random() * 3000)}
        ref.forecaster.update(rps)
        port.forecaster.update(rps)
        want = ref.compute_scaling_decision(m, rc, current_replicas=r_ref)
        got = port.compute_scaling_decision(m, pc, current_replicas=r_port)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert port.batch_gate_decision(m, pc) == \
            ref.batch_gate_decision(m, rc)
        assert port.analyze_current_load(m) == ref.analyze_current_load(m)
        r_ref, r_port = want.target_replicas, got.target_replicas


@pytest.mark.parametrize("seed", SEEDS)
def test_eviction_policy_equals_reference(seed):
    rng = np.random.default_rng(seed)
    ref, port = RefEvictionPolicy(k_windows=3), EvictionPolicy(k_windows=3)
    for _ in range(60):
        flagged = [int(r) for r in np.nonzero(rng.random(6) < 0.6)[0]]
        fleet = int(rng.integers(1, 7))
        assert port.update(flagged, fleet) == ref.update(flagged, fleet)
        assert [port.streak(r) for r in range(6)] == \
            [ref.streak(r) for r in range(6)]


@pytest.mark.parametrize("seed", SEEDS)
def test_forecaster_equals_reference(seed):
    rng = np.random.default_rng(seed)
    ref = RefForecaster(ticks_per_day=24, n_lags=4)
    port = WorkloadForecaster(ticks_per_day=24, n_lags=4)
    for t in range(200):
        v = float(5 + 3 * np.sin(2 * np.pi * t / 24) + rng.normal()
                  + (0.0 if t % 37 else 20.0))
        ref.update(v)
        port.update(v)
        assert port.predict() == ref.predict()
        assert port.predict_peak(3) == ref.predict_peak(3)


# ------------------------------------------------------ the feature streams


@pytest.mark.parametrize("seed", SEEDS)
def test_stream_builder_and_deploy_vector_equal_reference(seed):
    rng = np.random.default_rng(seed)
    dv = dict(model_params_b=float(rng.random() * 70), family=str(
        rng.choice(["dense", "moe", "ssm", "hybrid", "vlm", "audio", "x"])),
        mesh_model=int(rng.integers(1, 9)), mesh_data=int(rng.integers(1, 9)),
        region_idx=int(rng.integers(0, 5)), slo_ms=2000.0, cost_weight=0.5)
    d_ref, d_port = ref_deploy_vector(**dv), deploy_vector(**dv)
    assert d_port.dtype == d_ref.dtype and np.array_equal(d_port, d_ref)
    ref, port = RefStreamBuilder(window=8), StreamBuilder(window=8)
    keys = ("flop_util", "queue_depth", "latency_p95", "rps", "accept_rate",
            "preemptions", "tier_spills", "unknown")
    for _ in range(40):
        rec = {k: float(rng.random() * 10) for k in keys
               if rng.random() < 0.8}
        ref.push(rec)
        port.push(rec)
        want, got = ref.streams(d_ref), port.streams(d_port)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert np.array_equal(got[k], want[k]), k


# ------------------------------------------------------- fleets and markets


@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_plan_and_spot_market_equal_reference(seed):
    kw = dict(reserved=2, cost_on_demand=1.0, cost_preemptible=0.35,
              regions=("na", "eu", "apac"), home_region="eu")
    ref = RefFleetPlan(**kw, market=RefSpotMarket(seed=seed, base=0.35,
                                                  spike_prob=0.2))
    port = FleetPlan(**kw, market=SpotMarket(seed=seed, base=0.35,
                                             spike_prob=0.2))
    # query order must not change a price path
    for t in (30, 3, 17, 0, 29):
        assert port.market.price(t) == ref.market.price(t)
    assert port.market.prices(40) == ref.market.prices(40)
    for rid in range(8):
        assert dataclasses.asdict(port(rid)) == dataclasses.asdict(ref(rid))
        assert port.transport_ms_for(rid) == ref.transport_ms_for(rid)
        for t in (None, 0, 5, 39):
            assert port.price_of(rid, t) == ref.price_of(rid, t)
            assert port.cost_of(rid, t) == ref.cost_of(rid, t)
    assert port.origin == ref.origin
    for a in ("", "na", "eu", "apac", "sa", "au", "mars"):
        for b in ("na", "au", ""):
            assert rtt_between(a, b) == ref_rtt_between(a, b)


# ---------------------------------------------------------------- transport


@pytest.mark.parametrize("seed", SEEDS)
def test_transport_codecs_round_trip_as_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(rid=int(rng.integers(0, 1000)),
              prompt=rng.integers(3, 500, 12).astype(np.int32), gen_len=7,
              tier="batch", frames=rng.normal(size=(3, 4)).astype(np.float32))
    ref_req = RefRequest(**kw, sampling=RefSamplingParams(0.7, 5, seed))
    req = Request(**kw, sampling=SamplingParams(0.7, 5, seed))
    tokens = [int(t) for t in rng.integers(0, 99, 4)]
    for r in (ref_req, req):
        r.t_submit, r.t_admit, r.replica_id = 0.5, 1.0, 3
        r.tokens_out = list(tokens)
    enc = transport.encode_request(req)
    assert enc == ref_transport.encode_request(ref_req)
    back = transport.decode_request(transport.unpack_payload(
        transport.pack_frame(enc)[4:]))
    assert transport.encode_request(back) == enc
    done = transport.encode_completion(req)
    assert done == ref_transport.encode_completion(ref_req)
    fresh = Request(rid=req.rid, prompt=req.prompt, gen_len=7)
    assert transport.apply_request(fresh, done).tokens_out == req.tokens_out
    rep = dict(replica_id=2, tick=5, latency_ms_samples=[1.5, float("nan")],
               n_requests=2, n_errors=0, flop_util=0.5, hbm_util=0.5,
               ici_util=0.0, mem_frac=0.5, queue_depth=1, transport_ms=0.25,
               lat_tiers={"interactive": [1.5]})
    frame = transport.pack_frame(transport.encode_report(ReplicaReport(**rep)))
    assert frame == ref_transport.pack_frame(
        ref_transport.encode_report(RefReport(**rep)))
    got = transport.decode_report(transport.unpack_payload(frame[4:]))
    assert got.latency_ms_samples[0] == 1.5 and got.lat_tiers == \
        rep["lat_tiers"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_config_codec_round_trip_as_reference(arch):
    enc = transport.encode_config(get_config(arch))
    assert enc == ref_transport.encode_config(ref_get_config(arch))
    back = transport.decode_config(transport.unpack_payload(
        transport.pack_frame(enc)[4:]))
    assert back == get_config(arch)


def test_transport_errors_are_typed():
    with pytest.raises(transport.TransportError):
        transport.unpack_payload(b"\xff\xfe not json")
    assert issubclass(transport.TransportError, ConnectionError)
    big = transport.MAX_FRAME
    transport.MAX_FRAME = 8
    try:
        with pytest.raises(transport.TransportError, match="oversized"):
            transport.pack_frame({"too": "long for eight bytes"})
    finally:
        transport.MAX_FRAME = big


# --------------------------------------------------------------- the router

MAX_SEQ, SLOTS, TICK_S = 24, 2, 0.5
ARCH = "qwen2.5-3b"


@functools.lru_cache(maxsize=None)
def cores():
    ref = RefEngineCore(ref_smoke_config(ARCH), MAX_SEQ, seed=0)
    cfg = get_smoke_config(ARCH)
    lm = from_reference(jax.tree.map(np.asarray, ref.params), cfg,
                        device="cpu")
    return ref, lm


def drive(router, request_cls, arrivals, scale_events, max_steps=400):
    """arrivals: [(step, prompt_len, gen_len)]; scale_events: {step: n}.
    → (completed, now, requests by rid); every request completes once."""
    rng = np.random.default_rng(0)
    reqs = {i: request_cls(rid=i, prompt=rng.integers(3, 128, size=p)
                           .astype(np.int32), gen_len=g)
            for i, (_, p, g) in enumerate(arrivals)}
    by_step = {}
    for i, (s, _, _) in enumerate(arrivals):
        by_step.setdefault(s, []).append(i)
    completed, now, step = [], 0.0, 0
    while step < max_steps:
        now = step * TICK_S
        for i in by_step.get(step, []):
            router.submit(reqs[i], now=now)
        if step in scale_events:
            router.scale_to(scale_events[step], now=now)
        completed.extend(router.step(now))
        step += 1
        if step > max(by_step, default=0) and router.pending == 0 \
                and len(completed) == len(reqs):
            break
    rids = [r.rid for r in completed]
    assert sorted(rids) == sorted(reqs), "a request was lost or duplicated"
    for r in completed:
        assert r.t_submit is not None and r.t_done >= r.t_submit
        assert len(r.tokens_out) == reqs[r.rid].gen_len
    return completed, now, reqs


def port_router(n_replicas=1, max_replicas=4):
    _, lm = cores()
    return ReplicaRouter.shared_core(
        get_smoke_config(ARCH), slots=SLOTS, max_seq=MAX_SEQ,
        prefill_chunk=4, n_replicas=n_replicas, max_replicas=max_replicas,
        params=lm, device="cpu")


def test_router_decisions_equal_reference():
    """One stream with mid-run scaling (up, down mid-generation, up): the
    same completions in the same order, on the same replicas, with the same
    tokens, the same reports and fleet metrics."""
    ref_core, _ = cores()
    ref = RefRouter.shared_core(ref_core.cfg, slots=SLOTS, max_seq=MAX_SEQ,
                                prefill_chunk=4)
    port = port_router()
    arrivals = [(i // 2, 5 + (i % 4), 2 + (i % 3)) for i in range(24)]
    scale = {2: 3, 8: 1, 9: 2}
    want, _, _ = drive(ref, RefRequest, arrivals, scale)
    got, _, _ = drive(port, Request, arrivals, scale)
    key = lambda rs: [(r.rid, r.replica_id, list(r.tokens_out), r.t_done)
                      for r in rs]
    assert key(got) == key(want)
    assert {r.replica_id for r in got} != {0}
    assert [dataclasses.asdict(r) for r in port.reports(0)] == \
        [dataclasses.asdict(r) for r in ref.reports(0)]
    assert port.metrics() == ref.metrics()


def test_downscale_requeues_in_flight_requests():
    router = port_router(n_replicas=2)
    reqs = [Request(rid=i, prompt=np.full(6, 4, np.int32), gen_len=6)
            for i in range(4)]
    for r in reqs:
        router.submit(r, now=0.0)
    for _ in range(3):                     # admitted, 2 tokens generated
        router.step(0.0)
    assert {r.rid for r in reqs if r.replica_id == 1}
    router.scale_to(1, now=0.0)
    assert len(router.replicas) == 1       # the victim parked at once
    assert router.pending == 4             # its work is back in the system
    completed, now = [], 0.0
    while len(completed) < 4 and now < 100:
        now += TICK_S
        completed.extend(router.step(now))
    assert sorted(r.rid for r in completed) == [0, 1, 2, 3]
    assert all(len(r.tokens_out) == 6 and r.replica_id == 0
               for r in completed)


def test_scale_to_respects_bounds():
    router = port_router(n_replicas=1, max_replicas=3)
    assert router.scale_to(100) == 3
    assert router.scale_to(0) == 1
    assert router.scale_to(-5) == 1


arrival_strategy = st.lists(
    st.tuples(st.integers(0, 12), st.integers(1, 10), st.integers(1, 6)),
    min_size=1, max_size=16)
scaling_strategy = st.dictionaries(st.integers(0, 12), st.integers(1, 4),
                                   max_size=4)


@settings(max_examples=12, deadline=None)
@given(arrivals=arrival_strategy, scale_events=scaling_strategy)
def test_property_no_request_lost_or_duplicated(arrivals, scale_events):
    drive(port_router(), Request, arrivals, scale_events)


@settings(max_examples=8, deadline=None)
@given(arrivals=arrival_strategy, scale_events=scaling_strategy)
def test_property_throughput_accounting(arrivals, scale_events):
    router = port_router()
    completed, now, _ = drive(router, Request, arrivals, scale_events)
    m = router.metrics()
    tokens = sum(len(r.tokens_out) for r in completed)
    assert m["completed_tokens"] == tokens
    assert m["completed"] == len(completed)
    wall = max(now - min(r.t_submit for r in completed), 1e-9)
    assert m["throughput_tok_s"] == pytest.approx(tokens / wall, rel=1e-6)
