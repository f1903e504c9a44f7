"""The port's worker process: one mutating session + read-only observers,
as ``tests/test_worker_attach.py`` holds the reference's, on the CPU.

Workers are ``python -m repro_torch.serving.worker --device cpu``
subprocesses; the module shares one pod-like worker (``once=False``), which
returns to accept after each test's router detaches.  Pinned here:

* a second mutate attach is rejected with a TYPED WorkerBusyError (via the
  explicit attach handshake and via a legacy implicit first op), while an
  observer polls the same lifetime() counters the router's session sees,
  mid-decode, without perturbing the token stream;
* an observer severed or stalled mid-frame leaves the mutator unharmed;
* an observer's mutating op is bounced with a typed PermissionError and
  its session survives;
* the tcp factory counts off-list local spawns into
  ``router.metrics()["off_list_spawns"]``;
* a PodDesyncError step reply reaps the replica instead of crashing;
* the command line: ``--device`` is cuda unless told, a worker asked for
  cuda without a card raises before it listens, and each pod flag, in a
  command line the reference refuses, is refused with the reference's
  message and exit code.
"""
import os
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.serving import (
    MetricsObserver, ReplicaRouter, Request, TcpReplica, WorkerBusyError,
    launch_fleet, spawn_worker,
)
from repro_torch.serving import worker
from repro_torch.serving.transport import (
    Connection, Listener, TransportError, dial, encode_config,
)

CFG = get_smoke_config("qwen2.5-3b")
SLOTS = 2
MAX_SEQ = 24
RPC_S = 60.0


@pytest.fixture(scope="module", autouse=True)
def one_thread_workers():
    """Spawned workers inherit this environment: one OpenMP thread each."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


@pytest.fixture(scope="module")
def pod(one_thread_workers):
    """One listening worker on the CPU, shared by the module's tests."""
    with launch_fleet(1, device="cpu") as fleet:
        yield fleet.addrs[0]
        assert fleet.workers[0][1].poll() is None, "the shared worker died"


def _requests(n, prompt_len=6, gen_len=4, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(
                3, CFG.vocab, size=prompt_len).astype(np.int32),
                gen_len=gen_len) for i in range(n)]


def _tcp(addr, **kw):
    return TcpReplica(CFG, slots=SLOTS, max_seq=MAX_SEQ, prefill_chunk=4,
                      addr=addr, rpc_timeout_s=RPC_S, device="cpu", **kw)


def _drive(rep, reqs, poll=None, max_now=100):
    for r in reqs:
        rep.submit(r, now=0.0)
    done, now = [], 0.0
    while len(done) < len(reqs) and now < max_now:
        now += 1.0
        done.extend(rep.step(now))
        if poll is not None:
            poll()
    return {r.rid: tuple(r.tokens_out) for r in done}


def test_second_mutator_rejected_typed_and_observers_concurrent(pod):
    """The first TcpReplica owns the mutating session; a second attach
    fails with WorkerBusyError (typed, no desync); an observer attached
    THROUGHOUT polls the same lifetime counters the router-side stub sees
    mid-decode — and its polls never perturb the token stream (held
    against an unobserved run on a fresh attach)."""
    rep = _tcp(pod)
    obs = MetricsObserver(pod)
    try:
        with pytest.raises(WorkerBusyError):
            _tcp(pod)
        assert obs.ping()               # the rejection disturbed nothing
        mid = []
        streams = _drive(rep, _requests(4, gen_len=5),
                         poll=lambda: mid.append((obs.lifetime(),
                                                  rep.lifetime())))
        assert sorted(streams) == [0, 1, 2, 3]
        assert all(seen_obs == seen_router for seen_obs, seen_router in mid)
        assert any(lt["total_completed"] > 0 for lt, _ in mid[:-1]), \
            "the observer never caught the worker mid-stream"
        status = obs.status()
        assert status["initialized"] and status["lifetime"][
            "total_completed"] == 4
    finally:
        rep.close()
        obs.close()
    rep2 = _tcp(pod)
    try:
        assert _drive(rep2, _requests(4, gen_len=5)) == streams
    finally:
        rep2.close()


def test_observer_severed_mid_frame_leaves_mutator_unharmed(pod):
    rep = _tcp(pod)
    try:
        for r in _requests(2, gen_len=4):
            rep.submit(r, now=0.0)
        done = list(rep.step(1.0))
        raw = socket.create_connection(pod, timeout=10)
        conn = Connection(raw, timeout=10)
        conn.send({"op": "attach", "mode": "observe", "seq": 0})
        assert conn.recv()["ok"]
        raw.sendall(struct.pack(">I", 64) + b'{"o')
        raw.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                       struct.pack("ii", 1, 0))   # RST, not FIN
        raw.close()
        now = 1.0
        while len(done) < 2 and now < 100:
            now += 1.0
            done.extend(rep.step(now))
        assert sorted(r.rid for r in done) == [0, 1]
        assert all(len(r.tokens_out) == 4 for r in done)
        assert rep.lifetime()["total_completed"] == 2
    finally:
        rep.close()


def test_observer_stalled_mid_frame_does_not_block_mutator(pod):
    """An observer that sends HALF a frame and goes quiet costs the
    mutating session nothing; when it finishes the frame it is served."""
    rep = _tcp(pod)
    raw = socket.create_connection(pod, timeout=30)
    stalled = Connection(raw, timeout=30)
    try:
        stalled.send({"op": "attach", "mode": "observe", "seq": 0})
        assert stalled.recv()["ok"]
        raw.sendall(struct.pack(">I", 30) + b'{"op":"ping"')   # 12 of 30
        t0 = time.monotonic()
        assert sorted(_drive(rep, _requests(2, gen_len=3))) == [0, 1]
        assert time.monotonic() - t0 < 20.0
        raw.sendall(b',"seq":1}' + b" " * (30 - 12 - 9))
        reply = stalled.recv()
        assert reply["ok"] and reply["seq"] == 1
    finally:
        stalled.close()
        rep.close()


def test_observer_mutating_op_bounced_typed_session_survives(pod):
    rep = _tcp(pod)
    obs = MetricsObserver(pod)
    try:
        for bad_op in ("evacuate", "resume", "report", "step", "shutdown",
                       "submit", "init"):
            with pytest.raises(PermissionError):
                obs._rpc({"op": bad_op})
        assert obs.ping()
        assert obs.status()["initialized"]
    finally:
        obs.close()
        rep.close()


def test_legacy_implicit_mutator_claim_still_works(pod):
    """A pre-attach client whose first op is init gets the mutating
    session; a second such client bounces typed."""
    conn = dial(*pod, timeout=RPC_S)
    late = None
    try:
        conn.send({"op": "init", "cfg": encode_config(CFG), "slots": SLOTS,
                   "max_seq": MAX_SEQ, "seed": 0, "prefill_chunk": None,
                   "replica_id": 0, "seq": 0})
        assert conn.recv()["ok"]
        late = dial(*pod, timeout=30)
        late.send({"op": "ping", "seq": 0})
        assert late.recv().get("etype") == "WorkerBusyError"
    finally:
        if late is not None:
            late.close()
        conn.close()


def test_off_list_spawns_surface_in_router_metrics(pod):
    """A replica past an explicit attach list spawns a LOCAL worker: warned,
    and counted in router.metrics(); a proc fleet counts none."""
    with pytest.warns(RuntimeWarning, match="attach list"):
        router = ReplicaRouter.from_topology(
            CFG, "tcp", slots=SLOTS, max_seq=16, prefill_chunk=4,
            n_replicas=2, max_replicas=2, addrs=[pod], device="cpu")
    try:
        assert router.metrics()["off_list_spawns"] == 1
        assert router.replicas[0].addr == pod
        assert router.replicas[1]._proc is not None     # the local stand-in
    finally:
        router.close()
    router2 = ReplicaRouter.from_topology(
        CFG, "proc", slots=SLOTS, max_seq=16, prefill_chunk=4,
        n_replicas=1, max_replicas=1, device="cpu")
    try:
        assert router2.metrics()["off_list_spawns"] == 0
    finally:
        router2.close()


def test_pod_desync_reply_reaps_replica_instead_of_crashing():
    """A PodDesyncError step reply must surface exactly like a lost replica
    — stub flips failed, step returns, lost requests recoverable."""
    lst = Listener("127.0.0.1", 0)

    def fake_pod_head():
        conn = lst.accept(timeout=30, conn_timeout=30)
        while True:
            msg = conn.recv()
            if msg["op"] == "step":
                conn.send({"error": "pod lockstep divergence on step",
                           "etype": "PodDesyncError", "seq": msg["seq"]})
                return
            conn.send({"ok": True, "seq": msg["seq"]})

    t = threading.Thread(target=fake_pod_head, daemon=True)
    t.start()
    rep = TcpReplica(CFG, slots=SLOTS, max_seq=MAX_SEQ, prefill_chunk=4,
                     addr=lst.addr, rpc_timeout_s=30.0, device="cpu")
    [req] = _requests(1, gen_len=2)
    rep.submit(req, now=0.0)
    assert rep.step(1.0) == [] and rep.failed
    assert [r.rid for r in rep.lost_requests()] == [0]
    t.join(timeout=10)
    assert not t.is_alive()
    rep.close()
    lst.close()


# ------------------------------------------------------------ command line


def test_worker_device_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        worker.main(["--listen", "127.0.0.1:0"])
    with pytest.raises(TransportError, match="exited before listening"):
        spawn_worker(start_timeout_s=60.0)


# for each pod flag, the rest of a command line the reference refuses
POD_FLAG_REFUSALS = {
    "--pod-rank": ["--listen", "127.0.0.1:0"],                 # no size
    "--pod-size": ["--listen", "127.0.0.1:0", "--pod-rank", "2"],  # range
    "--coordinator": ["--pod-rank", "0", "--pod-size", "1"],  # no --listen
    "--pod-peers": ["--listen", "127.0.0.1:0", "--pod-rank", "1",
                    "--pod-size", "2"],                        # head-only
}


@pytest.mark.parametrize("flag,value", [
    ("--pod-rank", "0"), ("--pod-size", "2"),
    ("--coordinator", "127.0.0.1:1"), ("--pod-peers", "127.0.0.1:2")])
def test_pod_flags_refused_by_name(flag, value, capsys):
    """The worker refuses each pod flag's bad command line as the
    reference's worker does: exit code 2 and the same message."""
    from repro.serving import worker as ref_worker
    argv = POD_FLAG_REFUSALS[flag] + [flag, value]
    errs = []
    for main, extra in ((worker.main, ["--device", "cpu"]),
                        (ref_worker.main, [])):
        with pytest.raises(SystemExit) as e:
            main(argv + extra)
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.strip().splitlines()[-1]
                    .split("error: ", 1)[1])
    assert errs[0] == errs[1]
    assert "--pod-rank" in errs[0] or flag in errs[0]


def test_worker_needs_an_fd_or_a_listen_address(capsys):
    with pytest.raises(SystemExit):
        worker.main(["--device", "cpu"])
    assert "--listen" in capsys.readouterr().err


def test_worker_writes_its_stats_when_asked(tmp_path, monkeypatch):
    """With REPRO_TORCH_WORKER_STATS set, the worker leaves its process's
    kernel launch counts in that directory before it answers shutdown
    (zeros on the CPU: the plain versions run there), and no device
    peak (it never used a card)."""
    monkeypatch.setenv(worker.STATS_ENV, str(tmp_path))
    a, b = socket.socketpair()
    fd = b.detach()                    # the worker owns its end
    t = threading.Thread(target=lambda: worker.main(
        [str(fd), "--device", "cpu"]), daemon=True)
    t.start()
    conn = Connection(a, timeout=RPC_S)
    conn.send({"op": "ping", "seq": 0})
    assert conn.recv() == {"ok": True, "seq": 0}
    conn.send({"op": "shutdown", "seq": 1})
    assert conn.recv()["ok"]
    import json
    from repro_torch.kernels import ops
    written = json.loads((tmp_path / f"stats-{os.getpid()}.json")
                         .read_text())
    assert written == {"launches": ops.launch_counts(),
                       "device_peak_bytes": None}
    t.join(timeout=30)
    assert not t.is_alive()
    conn.close()
