"""The port's socket replicas under the router, on the CPU: the proc/tcp
cases of ``tests/test_replica_fabric.py`` and ``tests/test_transport.py``'s
crash test, held as the reference holds its own.

* A step reply left unread (an abandoned round) is drained before the next
  RPC, so the strict request/reply stream never shifts by one.
* A killed worker surfaces as a failed replica (never a hang): its report
  carries n_errors, the collector flags it, and its requests come back
  rewound; under the router it is reaped mid-run, its requests requeued
  and a replacement built, every request completing exactly once.
* A submit that finds a silently dead replica reroutes to a survivor, and
  a one-replica fleet heals itself on submit.
* tcp attaches to pre-started workers, measures transport, survives a
  detach mid-round, and a second router re-attaches.
* Whatever the topology, the streams equal an in-process replica's on the
  same seed and device.

Workers are ``--device cpu`` subprocesses with one OpenMP thread each.
"""
import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.core.monitoring.collector import (
    MetricsCollector, ReplicaReport,
)
from repro_torch.serving import (
    InProcessReplica, ProcessReplica, ReplicaRouter, Request, TcpReplica,
    launch_fleet,
)

CFG = get_smoke_config("qwen2.5-3b")
SLOTS = 2


@pytest.fixture(scope="module", autouse=True)
def one_thread_workers():
    """Spawned workers inherit this environment: one OpenMP thread each."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _requests(n, prompt_len=5, gen_len=3, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
                3, CFG.vocab, size=prompt_len).astype(np.int32),
                gen_len=gen_len) for i in range(n)]


def _run(target, reqs, until, max_now=200):
    done, now = [], 0.0
    for r in reqs:
        target.submit(r, now=0.0)
    while len(done) < until and now < max_now:
        now += 1.0
        done.extend(target.step(now))
    return done, now


def _streams(done):
    return {r.rid: tuple(r.tokens_out) for r in done}


def _inproc_streams(reqs, max_seq):
    rep = InProcessReplica.build(CFG, slots=SLOTS, max_seq=max_seq,
                                 prefill_chunk=4, device="cpu")
    return _streams(_run(rep, reqs, len(reqs))[0])


def test_rpc_drains_pending_step_reply_before_other_ops():
    rep = ProcessReplica(CFG, slots=SLOTS, max_seq=16, prefill_chunk=4,
                         replica_id=4, device="cpu")
    try:
        for r in _requests(2, gen_len=2):
            rep.submit(r, now=0.0)
        rep.begin_step(1.0)                # round in flight, reply unread
        report = rep.report(tick=0)        # must drain, then see a window
        assert report.replica_id == 4 and report.n_errors == 0
        assert report.transport_ms > 0.0
        done = rep.finish_step()           # the drained completions, if any
        more, _ = _run(rep, [], 2 - len(done))
        done += more
        assert sorted(r.rid for r in done) == [0, 1]
        assert all(len(r.tokens_out) == 2 for r in done)
        assert rep.lifetime()["total_completed"] == 2
        assert _streams(done) == _inproc_streams(_requests(2, gen_len=2), 16)
    finally:
        rep.close()
    assert rep._proc.poll() is not None    # the stub reaped its worker


def test_process_replica_crash_surfaces_as_straggler():
    rep = ProcessReplica(CFG, slots=1, max_seq=16, prefill_chunk=4,
                         replica_id=7, rpc_timeout_s=60.0, device="cpu")
    try:
        req = Request(rid=1, prompt=np.arange(3, 8, dtype=np.int32),
                      gen_len=8)
        rep.submit(req, now=0.0)
        rep.step(1.0)                       # mid-generation
        rep._proc.kill()
        rep._proc.wait(timeout=30)
        assert rep.step(2.0) == [] and rep.failed
        report = rep.report(tick=5)
        assert report.n_errors > 0 and report.replica_id == 7
        collector = MetricsCollector()
        collector.submit(report)
        assert 7 in collector.stragglers()
        collector.submit(ReplicaReport(
            replica_id=8, tick=5, latency_ms_samples=[1.0], n_requests=1,
            n_errors=0, flop_util=0.5, hbm_util=0.5, ici_util=0.0,
            mem_frac=0.5, queue_depth=0))
        assert collector.stragglers() == [7]
        lost = rep.lost_requests()
        assert [r.rid for r in lost] == [1]
        assert lost[0].tokens_out == [] and lost[0].t_admit is None
    finally:
        rep.close()


def test_router_reaps_failed_process_replica_mid_run():
    router = ReplicaRouter.from_topology(CFG, "proc", slots=SLOTS,
                                         max_seq=16, prefill_chunk=4,
                                         n_replicas=2, max_replicas=3,
                                         device="cpu")
    try:
        reqs = _requests(6, gen_len=6)
        done, now = _run(router, reqs, 2)  # the victim serves work first
        victim = router.replicas[1]
        assert isinstance(victim, ProcessReplica)
        victim._proc.kill()
        victim._proc.wait(timeout=30)
        while len(done) < 6 and now < 200:
            now += 1.0
            done.extend(router.step(now))
        assert sorted(r.rid for r in done) == list(range(6))
        assert all(len(r.tokens_out) == 6 for r in done)
        assert router.replica_count == 2   # replacement spawned
        assert router.metrics()["completed"] == 6
        assert victim.replica_id not in [r.replica_id
                                         for r in router.replicas]
        collector = MetricsCollector()
        for rep in router.reports(0):
            collector.submit(rep)
        assert victim.replica_id in collector.stragglers()
        for rep in router.reports(1):
            collector.submit(rep)
        assert victim.replica_id not in collector.stragglers()
        # a preempted request restarts on a survivor with the same stream
        assert _streams(done) == _inproc_streams(_requests(6, gen_len=6),
                                                 16)
    finally:
        router.close()


def test_submit_reroutes_around_silently_dead_replica():
    router = ReplicaRouter.from_topology(CFG, "proc", slots=SLOTS,
                                         max_seq=16, prefill_chunk=4,
                                         n_replicas=2, max_replicas=2,
                                         device="cpu")
    try:
        dead = router.replicas[1]
        dead._proc.kill()
        dead._proc.wait(timeout=30)
        reqs = _requests(4)
        for r in reqs:                     # the second submit finds the
            router.submit(r, now=0.0)      # corpse and must fail over
        assert dead.failed
        done, _ = _run(router, [], 4)
        assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    finally:
        router.close()


def test_single_replica_fleet_self_heals_on_submit():
    router = ReplicaRouter.from_topology(CFG, "proc", slots=SLOTS,
                                         max_seq=16, prefill_chunk=4,
                                         n_replicas=1, max_replicas=2,
                                         device="cpu")
    try:
        dead = router.replicas[0]
        dead._proc.kill()
        dead._proc.wait(timeout=30)
        [req] = _requests(1)
        router.submit(req, now=0.0)        # discovers, reaps, replaces
        assert router.replica_count == 1
        assert router.replicas[0] is not dead
        done, _ = _run(router, [], 1)
        assert [r.rid for r in done] == [0]
        assert len(done[0].tokens_out) == 3
    finally:
        router.close()


def test_tcp_router_attaches_to_prestarted_fleet():
    """Workers started by a stand-in scheduler, a router that ATTACHES:
    requests complete, per-replica transport is measured, a detach in the
    middle of a round leaves the workers alive, and a second router
    re-attaches to them."""
    with launch_fleet(2, device="cpu") as fleet:
        router = ReplicaRouter.from_topology(
            CFG, "tcp", slots=SLOTS, max_seq=16, prefill_chunk=4,
            n_replicas=2, max_replicas=2, addrs=fleet.addrs, device="cpu")
        assert all(isinstance(r, TcpReplica) for r in router.replicas)
        assert [r.addr for r in router.replicas] == fleet.addrs
        assert all(r._proc is None for r in router.replicas)
        done, now = _run(router, _requests(4), 4)
        assert sorted(r.rid for r in done) == [0, 1, 2, 3]
        router.reports(0)                  # report RPC → transport EWMA
        assert all(r.transport_ms > 0.0 for r in router.replicas)
        assert router.metrics()["rpc_count"] > 0
        router.replicas[0].begin_step(now + 1)   # detach MID-ROUND
        router.close()
        assert all(proc.poll() is None for _, proc in fleet.workers)
        router2 = ReplicaRouter.from_topology(
            CFG, "tcp", slots=SLOTS, max_seq=16, prefill_chunk=4,
            n_replicas=2, max_replicas=2, addrs=fleet.addrs, device="cpu")
        try:
            [req] = _requests(1, gen_len=2)
            done, _ = _run(router2, [req], 1)
            assert [r.rid for r in done] == [0]
            assert _streams(done) == _inproc_streams(
                _requests(1, gen_len=2), 16)
        finally:
            router2.close()


def test_params_cannot_cross_the_process_boundary():
    from repro_torch.models import LM
    lm = LM(CFG, device="cpu", seed=0)
    for topology in ("proc", "tcp"):
        with pytest.raises(ValueError, match="params"):
            ReplicaRouter.from_topology(CFG, topology, slots=SLOTS,
                                        max_seq=16, params=lm, device="cpu")
