"""Fault injection against the port's socket replicas, on the CPU: the
cases of ``tests/test_fault_injection.py`` and one seed of
``tests/test_chaos_soak.py``'s mixed-fleet soak.

Every injected fault surfaces as a typed TransportError or a reaped
replica — never a hang, never a stranded or double-served request — while
benign faults (splits, delays) leave the TCP topology observationally
identical to in-process serving.  Faults go through
``repro_torch.serving.chaos``: a byte-level proxy between a TcpReplica stub
and a real ``--device cpu`` worker, an endpoint-level FaultyConnection,
and scripted protocol-speaking fakes for the deterministic desync and
deadline cases.

The reference's three proxy cases on its ``tcp_worker`` fixture (split and
delayed frames, a reply severed mid-frame, a duplicated reply) fail on the
JAX package's own runs ("peer closed the connection"), so they are no
oracle yet: here they hold the port to the behaviour the reference's
tests state.
"""
import socket
import threading
import time
from collections import Counter

import numpy as np
import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.core.monitoring.collector import (
    MetricsCollector, ReplicaReport,
)
from repro_torch.core.scaling.scaler import EvictionPolicy
from repro_torch.serving import (
    InProcessReplica, ProcessReplica, ReplicaRouter, Request, TcpReplica,
    launch_fleet,
)
from repro_torch.serving.chaos import ChaosProxy, FaultPlan, FaultyConnection
from repro_torch.serving.transport import Connection, Listener, TransportError

CFG = get_smoke_config("qwen2.5-3b")
SLOTS, MAX_SEQ = 2, 24


@pytest.fixture(scope="module", autouse=True)
def one_thread_workers():
    """Spawned workers inherit this environment: one OpenMP thread each."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def tcp_worker(one_thread_workers):
    """One pod-like worker shared by the proxy cases: each severed or
    finished session sends it back to accept."""
    with launch_fleet(1, device="cpu") as fleet:
        yield fleet.addrs[0]


def _requests(n, gen_len=3, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
                3, CFG.vocab, size=5).astype(np.int32),
                gen_len=gen_len) for i in range(n)]


def _drive(rep, reqs, max_now=100):
    done, now = [], 0.0
    for r in reqs:
        rep.submit(r, now=0.0)
    while len(done) < len(reqs) and now < max_now:
        now += 1.0
        done.extend(rep.step(now))
    return {r.rid: tuple(r.tokens_out) for r in done}


def _tcp(addr, **kw):
    kw.setdefault("prefill_chunk", 4)
    return TcpReplica(CFG, slots=SLOTS, max_seq=MAX_SEQ, addr=addr,
                      device="cpu", **kw)


# ----------------------------------------------------- benign faults absorb


def test_split_and_delayed_frames_are_observationally_identical(tcp_worker):
    want = _drive(InProcessReplica.build(CFG, slots=SLOTS, max_seq=MAX_SEQ,
                                         prefill_chunk=4, device="cpu"),
                  _requests(3))
    plan = FaultPlan(chunk_bytes=7, delay_s=0.0005)
    with ChaosProxy(tcp_worker, c2s=plan, s2c=plan) as proxy:
        rep = _tcp(proxy.addr)
        try:
            got = _drive(rep, _requests(3))
        finally:
            rep.close()
    assert got == want and not rep.failed


# -------------------------------------------------- hard faults surface typed


def test_sever_mid_frame_reaps_replica_and_recovers_requests(tcp_worker):
    """The first step reply (server frame 3, after the attach and init
    acks) is cut in half."""
    with ChaosProxy(tcp_worker, s2c=FaultPlan(sever_in_frame=3)) as proxy:
        rep = _tcp(proxy.addr, replica_id=9, rpc_timeout_s=60.0)
        try:
            for r in _requests(2):
                rep.submit(r, now=0.0)
            assert rep.step(1.0) == [] and rep.failed
            report = rep.report(tick=0)
            assert report.n_errors > 0 and report.replica_id == 9
            collector = MetricsCollector()
            collector.submit(report)
            assert 9 in collector.stragglers()
            lost = rep.lost_requests()
            assert sorted(r.rid for r in lost) == [0, 1]
            assert all(r.tokens_out == [] and r.t_admit is None
                       for r in lost)
        finally:
            rep.close()


def test_duplicated_reply_frame_retires_replica_never_mismatches(tcp_worker):
    with ChaosProxy(tcp_worker, s2c=FaultPlan(duplicate_frame=3)) as proxy:
        rep = _tcp(proxy.addr, replica_id=3, rpc_timeout_s=60.0)
        try:
            [req] = _requests(1)
            rep.submit(req, now=0.0)
            rep.step(1.0)                  # reply #3 arrives twice
            with pytest.raises(TransportError):
                rep._rpc({"op": "report"})
            assert rep.failed
            assert rep.report(tick=1).n_errors > 0
            assert [r.rid for r in rep.lost_requests()] == [0]
        finally:
            rep.close()


class _ScriptedWorker:
    """A protocol-speaking fake worker (no engine, no subprocess): answers
    every op with a minimal well-formed reply echoing seq, and replays the
    step reply when told to."""

    def __init__(self, *, duplicate_step_reply: bool = False):
        self.listener = Listener("127.0.0.1", 0)
        self.duplicate_step_reply = duplicate_step_reply
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    @property
    def addr(self):
        return self.listener.addr

    def _serve(self):
        try:
            conn = self.listener.accept(timeout=30, conn_timeout=30)
            while True:
                msg = conn.recv()
                op = msg.get("op")
                if op == "step":
                    reply = {"completed": [], "queue_depth": 0, "active": 0,
                             "slot_utilization": 0.0}
                elif op == "report":
                    reply = {"window": {"latency_ms_samples": [],
                                        "n_requests": 0, "n_tokens": 0,
                                        "slot_util": 0.0, "queue_depth": 0}}
                else:
                    reply = {"ok": True}
                reply["seq"] = msg.get("seq")
                conn.send(reply)
                if op == "step" and self.duplicate_step_reply:
                    conn.send(reply)       # the injected twin
                if op == "shutdown":
                    return
        except TransportError:
            return

    def close(self):
        self.listener.close()
        self.thread.join(timeout=10)


def test_duplicated_reply_is_a_seq_desync_not_a_silent_mismatch():
    worker = _ScriptedWorker(duplicate_step_reply=True)
    rep = _tcp(worker.addr, replica_id=5, rpc_timeout_s=30.0,
               prefill_chunk=None)
    try:
        rep.step(1.0)                      # the reply arrives twice
        with pytest.raises(TransportError, match="desync"):
            rep._rpc({"op": "report"})
        assert rep.failed
    finally:
        rep.close()
        worker.close()
    assert not worker.thread.is_alive()


def test_corrupted_reply_payload_is_typed_error(tcp_worker):
    with ChaosProxy(tcp_worker, s2c=FaultPlan(corrupt_in_frame=1)) as proxy:
        with pytest.raises(TransportError):
            _tcp(proxy.addr, rpc_timeout_s=60.0)


def test_delayed_handshake_hits_the_init_deadline():
    """A peer that grants the attach but never answers init bounces the
    constructor at init_timeout_s (the RPC deadline stays 120 s)."""
    lst = Listener("127.0.0.1", 0)
    stop = threading.Event()

    def black_hole():
        conn = lst.accept(timeout=30)          # connect succeeds, the
        msg = conn.recv()                      # attach is granted...
        conn.send({"ok": True, "role": "mutate", "seq": msg["seq"]})
        stop.wait(30)                          # ...but init never answers
        conn.close()

    t = threading.Thread(target=black_hole, daemon=True)
    t.start()
    t0 = time.monotonic()
    with pytest.raises(TransportError, match="timed out"):
        _tcp(lst.addr, prefill_chunk=None, init_timeout_s=1.0)
    assert time.monotonic() - t0 < 20.0
    stop.set()
    t.join(timeout=10)
    assert not t.is_alive()
    lst.close()


def test_connect_deadline_surfaces_refused_peer():
    lst = Listener("127.0.0.1", 0)
    addr = lst.addr
    lst.close()
    with pytest.raises(TransportError):
        _tcp(addr, prefill_chunk=None, connect_timeout_s=2.0)


def test_faulty_connection_sever_is_mid_frame_eof_for_the_peer():
    a_sock, b_sock = socket.socketpair()
    a = FaultyConnection(a_sock, FaultPlan(sever_in_frame=2), timeout=10.0)
    b = Connection(b_sock, timeout=10.0)
    a.send({"fine": 1})
    assert b.recv() == {"fine": 1}
    with pytest.raises(TransportError):
        a.send({"doomed": list(range(32))})
    with pytest.raises(TransportError):
        b.recv()
    b.close()


def test_faulty_connection_duplicate_and_split_reassemble():
    a_sock, b_sock = socket.socketpair()
    a = FaultyConnection(a_sock, FaultPlan(chunk_bytes=3, duplicate_frame=1),
                         timeout=10.0)
    b = Connection(b_sock, timeout=10.0)
    a.send({"msg": "dup"})
    assert b.recv() == {"msg": "dup"}      # the frame...
    assert b.recv() == {"msg": "dup"}      # ...and its injected twin
    a.close(), b.close()


# ------------------------------------------------- fleet-level fault closure


def test_tcp_worker_kill_mid_decode_completes_every_request_exactly_once():
    router = ReplicaRouter.from_topology(CFG, "tcp", slots=SLOTS,
                                         max_seq=16, prefill_chunk=4,
                                         n_replicas=2, max_replicas=3,
                                         device="cpu")
    try:
        reqs = _requests(6, gen_len=6)
        for r in reqs:
            router.submit(r, now=0.0)
        done, now = [], 0.0
        while len(done) < 2 and now < 100:   # the victim serves work first
            now += 1.0
            done.extend(router.step(now))
        victim = router.replicas[1]
        assert isinstance(victim, TcpReplica)
        victim._proc.kill()
        victim._proc.wait(timeout=30)
        while len(done) < 6 and now < 200:
            now += 1.0
            done.extend(router.step(now))
        assert sorted(r.rid for r in done) == list(range(6))
        assert all(len(r.tokens_out) == 6 for r in done)
        assert router.replica_count == 2
        assert router.metrics()["completed"] == 6
    finally:
        router.close()


# ------------------------------------------------------------- chaos soak

N_REQUESTS, GEN_LEN, SOAK_SEQ = 14, 4, 16
KILL_TICKS = (4, 9)            # scripted worker kills (any live victim)
STRAGGLE_TICKS = (6, 7)        # injected straggler windows (K=2 → evict)


def _lat_report(rid, tick, lat_ms):
    return ReplicaReport(replica_id=rid, tick=tick,
                         latency_ms_samples=[lat_ms] * 4, n_requests=4,
                         n_errors=0, flop_util=0.5, hbm_util=0.5,
                         ici_util=0.0, mem_frac=0.5, queue_depth=0)


@pytest.mark.chaos
def test_chaos_soak_mixed_fleet_exactly_once_and_counters_balance():
    """A mixed proc+TCP fleet with scripted worker kills and straggler
    injections: every admitted request completes exactly once, the fleet's
    lifetime counters balance against what the loop collected, and
    every fault reaches the collector."""
    def factory(rid):
        cls = ProcessReplica if rid % 2 == 0 else TcpReplica
        return cls(CFG, slots=SLOTS, max_seq=SOAK_SEQ, prefill_chunk=4,
                   replica_id=rid, device="cpu")

    router = ReplicaRouter(factory, n_replicas=3, max_replicas=4)
    collector = MetricsCollector(straggler_factor=1.5)
    policy = EvictionPolicy(k_windows=2)
    rng = np.random.default_rng(42)
    reqs = [Request(rid=i, prompt=rng.integers(
                3, CFG.vocab, size=5).astype(np.int32), gen_len=GEN_LEN)
            for i in range(N_REQUESTS)]
    done, killed, evicted_ids = [], [], []
    flagged_ever: set[int] = set()
    submitted, now, tick = 0, 0.0, 0
    try:
        while (len(done) < N_REQUESTS or submitted < N_REQUESTS) \
                and tick < 120:
            tick += 1
            now += 1.0
            for _ in range(2):                     # staggered admissions
                if submitted < N_REQUESTS:
                    router.submit(reqs[submitted], now=now)
                    submitted += 1
            if tick in KILL_TICKS:                 # scripted SIGKILL
                victim = router.replicas[-1]
                killed.append(victim.replica_id)
                victim._proc.kill()
                victim._proc.wait(timeout=30)
            done.extend(router.step(now))
            for rep in router.reports(tick):
                collector.submit(rep)
                if rep.n_errors > 0:
                    flagged_ever.add(rep.replica_id)
            if tick in STRAGGLE_TICKS:
                live = sorted(r.replica_id for r in router.serving_replicas)
                slow, rest = live[0], live[1:]
                collector.submit(_lat_report(slow, tick, 5000.0))
                for rid in rest:
                    collector.submit(_lat_report(rid, tick, 100.0))
            evicted_ids.extend(router.evict_stragglers(
                policy.update(collector.stragglers(),
                              router.replica_count), now=now))
            collector.aggregate(tick, n_replicas=router.replica_count,
                                max_replicas=4)
        for _ in range(collector.max_staleness + 1):   # drain ticks
            tick += 1
            collector.aggregate(tick, n_replicas=router.replica_count,
                                max_replicas=4)

        counts = Counter(r.rid for r in done)
        assert sorted(counts) == list(range(N_REQUESTS))
        assert all(c == 1 for c in counts.values()), counts
        assert all(len(r.tokens_out) == GEN_LEN for r in done)
        assert len(killed) == 2
        assert len(evicted_ids) >= 1
        assert not set(evicted_ids) & set(killed)
        m = router.metrics()
        assert m["completed"] == N_REQUESTS
        assert m["completed_tokens"] == sum(len(r.tokens_out) for r in done)
        assert m["replicas"] == 3
        assert set(killed) <= flagged_ever
        retired = set(killed) | set(evicted_ids)
        assert retired and not retired & set(collector.reports)
        assert not retired & set(collector._errored)
        assert not retired & set(collector._lat_ewma)
        assert len(collector.reports) <= router.replica_count + 1
        # requeued work restarts with the stream an undisturbed engine gives
        inproc = InProcessReplica.build(CFG, slots=SLOTS, max_seq=SOAK_SEQ,
                                        prefill_chunk=4, device="cpu")
        fresh = [Request(rid=r.rid, prompt=r.prompt, gen_len=GEN_LEN)
                 for r in reqs]
        assert {r.rid: tuple(r.tokens_out) for r in done} == \
            _drive(inproc, fresh, max_now=400)
    finally:
        router.close()
    assert all(r._proc.poll() is not None for r in router.all_replicas)
