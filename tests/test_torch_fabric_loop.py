"""The port's closed control loop across replica topologies, on the CPU.

``run_closed_loop`` on the same seed over ``inproc``, ``proc`` and ``tcp``
replicas gives the same decisions, the same ``served`` per tick and the
same token streams, request for request — with and without regions (a
FleetPlan striping the fleet over two regions, its RTT injected by
``DelayedReplica`` on the virtual clock).  The port's ``inproc`` is held to
the reference by ``tests/test_torch_closed_loop.py``, and the reference
holds its own topologies equal (``tests/test_replica_fabric.py``), so the
chain reaches the reference.  The ``tcp`` runs attach to one module-scoped
fleet of four pre-started workers and observe all of them read-only
(``observe_addrs``): the out-of-band lifetime counters add up to the
router's own fleet metrics, and nothing spawns off the attach list.

The default ``LoopConfig`` is the one ``chip_smoke.py`` runs at full width
on the card: 14 ticks, 1 → 3 → 4 → 1 replicas, so workers park and
revive.
"""
import dataclasses

import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.serving import launch_fleet
from repro_torch.serving.closed_loop import LoopConfig, run_closed_loop

CFG = get_smoke_config("qwen2.5-3b")
CASES = {
    "default": (LoopConfig(), 14),
    "regions": (LoopConfig(slots=2, max_replicas=2, max_seq=32,
                           prefill_chunk=4, steps_per_tick=6,
                           reserved_replicas=2, regions=("na", "apac"),
                           spot_market=True), 8),
}


@pytest.fixture(scope="module")
def fleet():
    """Four listening workers on the CPU, one OpenMP thread each."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        with launch_fleet(4, device="cpu") as f:
            yield f


def _run(lc, ticks):
    sink = []
    router, logs = run_closed_loop(CFG, autoscale=True, ticks=ticks, seed=0,
                                   lc=lc, sink=sink, device="cpu")
    return router, logs, {
        "decisions": [(t.replicas, t.reason) for t in logs],
        "served": [t.served for t in logs],
        "spills": [t.region_spills for t in logs],
        "streams": {r.rid: tuple(r.tokens_out) for r in sink},
    }


@pytest.mark.parametrize("case", sorted(CASES))
def test_closed_loop_identical_across_topologies(case, fleet):
    lc, ticks = CASES[case]
    router, _, want = _run(lc, ticks)
    router.close()
    assert want["streams"]                       # the loop served
    if case == "default":
        assert len({d[0] for d in want["decisions"]}) > 1

    router, _, got = _run(dataclasses.replace(lc, topology="proc"), ticks)
    try:
        assert got == want
        assert router.metrics()["rpc_count"] > 0
        procs = [r._proc for r in router.all_replicas]
    finally:
        router.close()
    assert all(p.poll() is not None for p in procs)   # no worker survives

    router, logs, got = _run(dataclasses.replace(
        lc, topology="tcp", addrs=tuple(fleet.addrs),
        observe_addrs=tuple(fleet.addrs)), ticks)
    try:
        assert got == want
        m = router.metrics()
        assert m["off_list_spawns"] == 0
        # two views of one fleet over two kinds of session: the observers'
        # out-of-band lifetime counters add up to the router's metrics
        assert all(len(t.observed) == len(fleet.addrs) for t in logs)
        # (a worker this router never attached holds no engine)
        by_id = {r.replica_id: r.lifetime() for r in router.all_replicas}
        observed = logs[-1].observed
        assert [o["initialized"] for o in observed] == \
            [rid in by_id for rid in range(len(fleet.addrs))]
        served = [o["lifetime"] for o in observed if o["initialized"]]
        assert sum(lt["total_completed"] for lt in served) == m["completed"]
        assert sum(lt["total_tokens"] for lt in served) \
            == m["completed_tokens"]
        for rid, lifetime in by_id.items():
            assert observed[rid]["addr"] == fleet.addrs[rid]
            for key in ("total_completed", "total_tokens"):
                assert observed[rid]["lifetime"][key] == lifetime[key]
    finally:
        router.close()
    assert all(p.poll() is None for _, p in fleet.workers)  # detach only

