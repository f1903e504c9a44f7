"""The port's queueing serving model, roofline DB and replica profiles
against the JAX reference's (``repro.sim``, ``repro.serving.profiles``).

Exact, where the arithmetic is the reference's: ``mmc_wait_s`` on a grid
and at the edge cases ``tests/test_multi_region_bench.py`` pins;
``ServingModel.latency_util`` and 20 ``tick`` results for one profile and
seed; ``ReplicaProfile.from_service``; the DB's reading of one
reference-format record (with and without ``probe``) to the same FLOPs,
bytes and collective bytes, its roofline times apart by the constants'
ratio only (H100 against TPU v5e); the analytic fallback's terms equal to
the reference's × 256 (the port counts a ShapeCfg on one card, the
reference on 256 chips).  A record carrying ``scan_flops_counted`` takes no
SSM correction.  A dry-run cell written on the CPU (a small ShapeCfg
through ``analyze_cell``) reads back as measured, and the planner's
decisions over its ``ServiceProfile`` equal the reference allocator's over
the same profile fields.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

from repro.core.allocation.allocator import AllocatorConfig as RefAllocCfg
from repro.core.allocation.allocator import (
    PredictiveAllocator as RefAllocator,
)
from repro.core.dnn.features import deploy_vector as ref_deploy_vector
from repro.core.scaling.scaler import ScalingConstraints as RefConstraints
from repro.serving.profiles import ReplicaProfile as RefReplicaProfile
from repro.sim import roofline_db as ref_db
from repro.sim import serving as ref_serving

from repro_torch.configs import get_smoke_config
from repro_torch.core.allocation.allocator import (
    AllocatorConfig, PredictiveAllocator,
)
from repro_torch.core.dnn.features import deploy_vector
from repro_torch.core.scaling.scaler import ScalingConstraints
from repro_torch.launch import dryrun
from repro_torch.models import SHAPES, ShapeCfg
from repro_torch.serving.profiles import ReplicaProfile
from repro_torch.sim import roofline_db, serving
from repro_torch.sim import (
    HBM_BW, ICI_BW, PEAK_FLOPS, RooflineDB, ServiceProfile, ServingModel,
    WorkloadSpec, mmc_wait_s,
)

PROFILE = dict(arch="h2o-danube-1.8b", chips_per_replica=1, slots=8,
               decode_step_s=0.021, prefill_32k_s=1.7, bottleneck="memory")
RPS = (20.0, 40.0, 80.0, 160.0)


def test_mmc_wait_equals_reference_on_a_grid():
    for lam in (0.0, 0.3, 1.0, 4.9, 5.0, 30.0, 119.0, 250.0):
        for mu in (0.0, 0.05, 1.0, 2.5):
            for c in (0, 1, 2, 5, 119, 120, 150, 400):
                got, want = mmc_wait_s(lam, mu, c), ref_serving.mmc_wait_s(
                    lam, mu, c)
                assert got == want or (math.isnan(got) and math.isnan(want))
    assert mmc_wait_s(0.0, 1.0, 150) == 0.0
    assert mmc_wait_s(0.0, 1.0, 2) == 0.0
    assert mmc_wait_s(1.0, 0.0, 2) == float("inf")
    assert mmc_wait_s(5.0, 1.0, 2) == float("inf")
    assert math.isfinite(mmc_wait_s(1.0, 1.0, 150))
    assert (serving.GAMMA_SHAPE, serving.GAMMA_SCALE, serving.P95_DISPERSION
            ) == (ref_serving.GAMMA_SHAPE, ref_serving.GAMMA_SCALE,
                  ref_serving.P95_DISPERSION)


def _models(profile=PROFILE, seed=3):
    w = dict(prompt_len=512, gen_len=64)
    return (ServingModel(ServiceProfile(**profile), WorkloadSpec(**w),
                         slo_ms=900.0, seed=seed),
            ref_serving.ServingModel(ref_serving.ServiceProfile(**profile),
                                     ref_serving.WorkloadSpec(**w),
                                     slo_ms=900.0, seed=seed))


def test_serving_model_equals_reference():
    port, ref = _models()
    for replicas in (1, 2, 5, 30):
        for rps in (0.0, 1.0, 7.5, 40.0, 400.0):
            assert port.latency_util(replicas, rps) == ref.latency_util(
                replicas, rps)
    for i in range(20):
        replicas, rps = 1 + i % 4, [2.0, 9.0, 30.0, 0.5, 120.0][i % 5]
        a, b = port.tick(replicas, rps), ref.tick(replicas, rps)
        assert np.array_equal(a.latency_ms_samples, b.latency_ms_samples)
        assert (a.served, a.errors, a.utilization, a.queue_depth, a.tokens
                ) == (b.served, b.errors, b.utilization, b.queue_depth,
                      b.tokens)


def test_replica_profile_from_service_equals_reference():
    fast = dict(PROFILE, decode_step_s=0.007, arch="qwen2.5-3b")
    for kw in ({}, {"cost_per_tick": 2.5, "preemptible": True,
                    "region": "eu"}):
        got = ReplicaProfile.from_service(ServiceProfile(**fast),
                                          ServiceProfile(**PROFILE), **kw)
        want = RefReplicaProfile.from_service(
            ref_serving.ServiceProfile(**fast),
            ref_serving.ServiceProfile(**PROFILE), **kw)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert ReplicaProfile.from_service(ServiceProfile(**fast)).speed == 1.0


def _record(arch, shape, probe):
    rec = {"arch": arch, "shape": shape, "mesh": [16, 16], "chips": 256,
           "cost": {"flops": 3.1e13, "bytes": 7.7e11},
           "memory": {"argument_size_in_bytes": 2_000_000_000,
                      "temp_size_in_bytes": 300_000_000},
           "collective_bytes": 4.4e9, "collective_detail": {}}
    if probe:
        rec["probe"] = {"flops": {"total": 4.2e13}, "bytes": {"total": 9e11},
                        "coll": {"total": 5.5e9}, "units": 24}
    return rec


@pytest.mark.parametrize("probe", [False, True])
@pytest.mark.parametrize("arch,shape", [("qwen2.5-3b", "decode_32k"),
                                        ("zamba2-2.7b", "prefill_32k")])
def test_db_reads_reference_records_as_the_reference(tmp_path, arch, shape,
                                                     probe):
    path = tmp_path / f"{arch}__{shape}__single.json"
    path.write_text(json.dumps(_record(arch, shape, probe)))
    got = RooflineDB(tmp_path).terms(arch, shape)
    want = ref_db.RooflineDB(tmp_path).terms(arch, shape)
    assert got.measured and want.measured
    assert (got.flops, got.bytes, got.coll_bytes, got.chips, got.mem_per_dev
            ) == (want.flops, want.bytes, want.coll_bytes, want.chips,
                  want.mem_per_dev)
    assert got.t_compute == pytest.approx(
        want.t_compute * ref_db.PEAK_FLOPS / PEAK_FLOPS, rel=1e-12)
    assert got.t_memory == pytest.approx(
        want.t_memory * ref_db.HBM_BW / HBM_BW, rel=1e-12)
    assert got.t_collective == pytest.approx(
        want.t_collective * ref_db.ICI_BW / ICI_BW, rel=1e-12)


def test_h100_constants():
    assert (PEAK_FLOPS, HBM_BW, ICI_BW) == (989e12, 3.35e12, 450e9)
    assert str(roofline_db.DEFAULT_DIR) == "results/torch_dryrun"


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ["qwen2.5-3b", "zamba2-2.7b",
                                  "olmoe-1b-7b", "falcon-mamba-7b"])
def test_analytic_fallback_is_the_reference_on_one_card(tmp_path, arch,
                                                        shape):
    got = RooflineDB(tmp_path).terms(arch, shape)
    want = ref_db.RooflineDB(tmp_path).terms(arch, shape)
    assert not got.measured and got.chips == 1
    assert (got.flops, got.bytes, got.coll_bytes) == (
        want.flops * 256, want.bytes * 256, want.coll_bytes * 256)


def test_scan_flops_counted_skips_the_ssm_correction(tmp_path):
    rec = _record("zamba2-2.7b", "prefill_32k", False)
    path = tmp_path / "zamba2-2.7b__prefill_32k__single.json"
    path.write_text(json.dumps(rec))
    corrected = RooflineDB(tmp_path).terms("zamba2-2.7b", "prefill_32k")
    path.write_text(json.dumps({**rec, "scan_flops_counted": True}))
    counted = RooflineDB(tmp_path).terms("zamba2-2.7b", "prefill_32k")
    assert counted.flops == rec["cost"]["flops"]
    assert corrected.flops > counted.flops


def _decide(allocator_cls, cfg_cls, constraints_cls, dv, model):
    alloc = allocator_cls(model.latency_util, constraints_cls(slo_ms=200.0),
                          dv, cfg=cfg_cls(mode="planner"),
                          **({} if allocator_cls is RefAllocator
                             else {"device": "cpu"}))
    out = []
    for rps in RPS:
        alloc.observe({"rps": rps})
        d = alloc.decide({"rps": rps, "rps_window": [rps]})
        alloc.apply(d)
        out.append((d.target_replicas, d.predicted_latency_ms, d.reason))
    return out


def test_cpu_dryrun_cells_ground_the_planner(tmp_path):
    arch = "h2o-danube-1.8b"
    cfg = dataclasses.replace(get_smoke_config(arch), name=arch)
    for name, kind in (("decode_32k", "decode"), ("prefill_32k", "prefill")):
        rec = dryrun.analyze_cell(cfg, ShapeCfg(name, 24, 32, kind), "cpu",
                                  reps=1)
        dryrun.cell_path(tmp_path, arch, name).write_text(json.dumps(rec))
    db = RooflineDB(tmp_path)
    for name in ("decode_32k", "prefill_32k"):
        t = db.terms(arch, name)
        rec = json.loads(dryrun.cell_path(tmp_path, arch, name).read_text())
        assert t.measured and t.chips == 1
        assert t.flops == rec["cost"]["flops"]      # no SSM correction
    profile = ServiceProfile.from_db(db, arch)
    assert (profile.chips_per_replica, profile.slots) == (1, 8)
    assert profile.prefill_32k_s == db.terms(arch, "prefill_32k").step_time / 2
    fields = dataclasses.asdict(profile)
    # the smoke cell's profile, and one at a card's scale, where decisions
    # change with the load
    for f in (fields, dict(fields, decode_step_s=0.008, prefill_32k_s=1.7)):
        w = dict(prompt_len=256, gen_len=12)
        port = ServingModel(ServiceProfile(**f), WorkloadSpec(**w),
                            slo_ms=200.0)
        ref = ref_serving.ServingModel(ref_serving.ServiceProfile(**f),
                                       ref_serving.WorkloadSpec(**w),
                                       slo_ms=200.0)
        dv = dict(model_params_b=1.8, family="dense", mesh_model=1,
                  mesh_data=1, region_idx=0, slo_ms=200, cost_weight=0.5)
        got = _decide(PredictiveAllocator, AllocatorConfig,
                      ScalingConstraints, deploy_vector(**dv), port)
        want = _decide(RefAllocator, RefAllocCfg, RefConstraints,
                       ref_deploy_vector(**dv), ref)
        assert got == want
