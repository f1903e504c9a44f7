"""Multi-process pods on the port, on the CPU: ranks are ``python -m
repro_torch.serving.worker --pod-rank R --pod-size 2 --device cpu``
processes joined over a gloo group, rank 0 the RPC head, lockstep checked
by per-step digests.

* A 2-rank pod (``DistributedPodReplica``) serves, with a read-only
  ``MetricsObserver`` polling its head between steps, the streams of the
  port's ``sharded`` topology and of the reference's in-process replica
  holding the same weights (the pod's ranks draw theirs from the seed;
  ``models.bridge.to_reference`` carries them into the reference); the
  observer's lifetime counters equal the stub's at every poll.
* The closed loop over the ``pod`` topology (each replica a 2-rank pod)
  gives the ``inproc`` loop's decisions, ``served`` and streams.
* ``dispatch`` on a head whose follower is a socketpair in this process:
  a matching digest passes, a different one raises ``PodDesyncError``, a
  follower error raises it too, and a follower gone is a TransportError.

``spmd_capable`` is not held against the reference: gloo's probe says
True on the CPU where JAX's CPU backend says False, and both serve in
mirror mode.
"""
import socket
import threading

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.serving import InProcessReplica as RefInProcessReplica
from repro.serving import Request as RefRequest
from repro.serving.engine import EngineCore as RefEngineCore

from repro_torch.configs import get_smoke_config
from repro_torch.models import LM
from repro_torch.models.bridge import to_reference
from repro_torch.serving import (
    DistributedPodReplica, MetricsObserver, Request, ServingEngine,
    ShardedReplica,
)
from repro_torch.serving import worker
from repro_torch.serving.closed_loop import LoopConfig, run_closed_loop
from repro_torch.serving.transport import Connection, TransportError

CFG = get_smoke_config("qwen2.5-3b")
SLOTS, MAX_SEQ = 2, 24


@pytest.fixture(scope="module", autouse=True)
def one_thread_workers():
    """Spawned ranks inherit this environment: one OpenMP thread each."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield


def _requests(cls, n=3, seed=7):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(3, CFG.vocab, size=6
                                           ).astype(np.int32), gen_len=4)
            for i in range(n)]


def _drive(rep, reqs, poll=None):
    done, now = [], 0.0
    for r in reqs[:2]:
        rep.submit(r, now=0.0)
    for _ in range(2):
        now += 1.0
        done.extend(rep.step(now))
        if poll:
            poll()
    for r in reqs[2:]:
        rep.submit(r, now=now)
    while len(done) < len(reqs) and now < 200:
        now += 1.0
        done.extend(rep.step(now))
        if poll:
            poll()
    return {r.rid: tuple(r.tokens_out) for r in done}


def _reference_streams():
    """The reference's unsharded replica on the weights a worker draws."""
    ref = RefEngineCore(ref_smoke_config("qwen2.5-3b"), MAX_SEQ, seed=0)
    tree = to_reference(dict(LM(CFG, device="cpu", seed=0)
                             .named_parameters()), CFG)
    ref.params = jax.tree.map(jax.numpy.asarray, tree)
    rep = RefInProcessReplica.build(ref.cfg, slots=SLOTS, max_seq=MAX_SEQ,
                                    prefill_chunk=4, core=ref)
    return _drive(rep, _requests(RefRequest))


def test_pod_matches_sharded_topology_and_reference_with_observer():
    sharded = _drive(ShardedReplica(CFG, slots=SLOTS, max_seq=MAX_SEQ,
                                    prefill_chunk=4, device="cpu"),
                     _requests(Request))
    assert sharded == _reference_streams()
    pod = DistributedPodReplica(CFG, slots=SLOTS, max_seq=MAX_SEQ,
                                prefill_chunk=4, pod_size=2, device="cpu")
    procs = list(pod._pod_handle.procs)
    try:
        obs = MetricsObserver(pod.addr)
        info = obs.status()["pod"]
        assert (info["rank"], info["size"], info["mode"]) == (0, 2, "mirror")
        assert info["process_count"] == 2     # the group really formed
        assert info["device_count"] == 2      # one device per rank
        polls = []

        def agree():
            polls.append(obs.lifetime() == pod.lifetime())

        got = _drive(pod, _requests(Request), poll=agree)
        assert got == sharded
        assert polls and all(polls)
        obs.close()
    finally:
        pod.close()
    assert all(p.poll() is not None for p in procs)


def test_pod_closed_loop_matches_inproc():
    results = {}
    for topology in ("inproc", "pod"):
        lc = LoopConfig(slots=2, max_replicas=2, max_seq=32, prefill_chunk=4,
                        steps_per_tick=6, topology=topology, pod_size=2)
        sink = []
        router, logs = run_closed_loop(CFG, autoscale=True, ticks=6, seed=0,
                                       lc=lc, sink=sink, device="cpu")
        try:
            results[topology] = {
                "decisions": [(t.replicas, t.reason) for t in logs],
                "served": [t.served for t in logs],
                "streams": {r.rid: tuple(r.tokens_out) for r in sink},
            }
            kinds = {r.kind for r in router.all_replicas}
        finally:
            router.close()
        assert kinds == {topology}
    assert results["inproc"] == results["pod"]
    assert results["inproc"]["streams"]


# ----------------------------------------------- lockstep on the rank fabric


def _head_with_follower(reply_fn):
    """A head PodRuntime whose one follower is a thread on a socketpair,
    answering each message with ``reply_fn(msg)`` (None: hang up)."""
    a, b = socket.socketpair()
    head = worker.PodRuntime(0, 2, None, ("unused:0",), device="cpu")
    head.followers.append(Connection(a, timeout=30.0))
    head._seqs.append(0)
    far = Connection(b, timeout=30.0)

    def follow():
        while True:
            try:
                msg = far.recv()
            except TransportError:
                return
            reply = reply_fn(msg)
            if reply is None:
                far.close()
                return
            reply["seq"] = msg["seq"]
            far.send(reply)

    t = threading.Thread(target=follow, daemon=True)
    t.start()
    return head, t


def _engine_with_request():
    eng = ServingEngine(CFG, slots=SLOTS, max_seq=MAX_SEQ, prefill_chunk=4,
                        device="cpu")
    eng.submit(_requests(Request, n=1)[0], now=0.0)
    return eng


def test_dispatch_checks_follower_digests():
    mirror = _engine_with_request()
    rank1 = worker.PodRuntime(1, 2, None, device="cpu")
    head, t = _head_with_follower(
        lambda msg: worker.handle(mirror, msg, rank1, device="cpu"))
    eng = _engine_with_request()
    reply = worker.dispatch(eng, {"op": "step", "now": 1.0}, head)
    assert "completed" in reply and "digest" not in reply
    assert reply["active"] == 1
    head.close()
    t.join(timeout=10)
    assert not t.is_alive()


@pytest.mark.parametrize("follower,error", [
    (lambda msg: {"digest": "0" * 16, "queue_depth": 0, "active": 1},
     "divergence"),
    (lambda msg: {"error": "boom", "etype": "RuntimeError"}, "errored"),
], ids=["digest", "error"])
def test_dispatch_raises_pod_desync(follower, error):
    head, t = _head_with_follower(follower)
    with pytest.raises(worker.PodDesyncError, match=error):
        worker.dispatch(_engine_with_request(), {"op": "step", "now": 1.0},
                        head)
    head.close()
    t.join(timeout=10)
    assert not t.is_alive()


def test_dispatch_lost_follower_is_a_transport_error():
    head, t = _head_with_follower(lambda msg: None)
    with pytest.raises(TransportError):
        worker.dispatch(_engine_with_request(), {"op": "step", "now": 1.0},
                        head)
    # ops outside the lockstep set never touch the fabric
    assert worker.dispatch(None, {"op": "ping"}, head) == {"ok": True}
    head.close()
    t.join(timeout=10)
    assert not t.is_alive()
