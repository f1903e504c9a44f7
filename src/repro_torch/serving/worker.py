"""Replica worker: a ServingEngine driven over the socket transport
(``repro.serving.worker``).

Three ways to become a worker:

  ``python -m repro_torch.serving.worker <fd> [--device cuda|cpu]``
      serve one engine on an inherited socketpair fd (ProcessReplica
      spawns it with ``pass_fds`` — single-host).
  ``python -m repro_torch.serving.worker --listen host:port [--once]
      [--device cuda|cpu]``
      bind a TCP listener (port 0 → kernel-picked) and print
      ``WORKER_LISTENING host:port`` so a parent or script can attach.
      The worker is a pod: a router DIALS it (TcpReplica), and when that
      router goes away the worker returns to accept for the next one —
      unless started ``--once``, which ties its lifetime to the first
      mutating session (stub-owned local workers).
  ``python -m repro_torch.serving.worker --listen host:port --pod-rank R
      --pod-size N [--coordinator host:port] [--pod-peers a:p,b:q]
      [--device cuda|cpu]``
      one rank of a MULTI-PROCESS POD: N listening workers jointly back
      one router-visible replica.  Rank 0 is the RPC head — the only rank
      a router dials; it holds a mutating session on every non-head rank
      and forwards each mutating op before running it locally, so all
      ranks step in lockstep.  Ranks join a ``torch.distributed`` gloo
      group when ``--coordinator`` is given (process count and rank are
      plumbed from these flags, never discovered ambiently).  See "Pod
      execution" below.

``--device`` is the one addition to the reference's command line: the
worker process owns its device, and ``init`` builds its engine there
(``ServingEngine(..., device=...)``), so the wire protocol's ``init``
fields stay exactly the reference's.  It defaults to ``cuda``; without a
card the worker raises at startup rather than carry on on the CPU.  Every
rank of a pod takes its own ``--device``.

Concurrent sessions (``--listen`` mode): the accept loop multiplexes ONE
mutating session (a router's SocketReplica, or the pod head for a non-head
rank) with ANY number of read-only
observer sessions over ``select``.  A connection's first message decides
its role: ``attach {mode}`` claims it explicitly (a second ``mutate``
attach is rejected with a typed ``WorkerBusyError`` reply and closed — the
racing router fails typed, not desynced), and any other first op falls
back to an implicit mutate claim (pre-attach clients keep working).
Observers may send only the read-only ops (ping / lifetime / status — none
of which drain the mutator's metric window); anything else is bounced
per-message with a typed ``PermissionError`` reply.  An observer torn down
mid-frame is simply dropped — the mutating session never notices.  When
the mutating session ends, the worker drops its engine and returns the
device's cached memory before it accepts the next one, so a re-attached
worker never holds two engines.

The RPC stream per session is strict request/reply: every message is
answered exactly once, in order, and the reply echoes the request's
``seq`` — so the parent can measure transport latency per call, a missing
reply always means the worker is gone (never "still thinking about an
older message"), and a duplicated or dropped frame surfaces parent-side
as a seq desync.

Ops mirror the Replica protocol 1:1 (see serving/replica.py):

  attach    — session handshake: {"mode": "mutate" | "observe"}
  init      — build the engine from an encoded ModelConfig (the handshake)
  submit    — enqueue one request (validation errors bounce back typed)
  step      — one scheduling round; batched submits (``"submits": [...]``)
              are enqueued first, so one message per round replaces one per
              request; replies completed requests + queue state
  report    — drain the metric window for one ReplicaReport
  lifetime  — lifetime accumulators for fleet-level metrics
  status    — NON-DRAINING snapshot (observer-safe): lifetime counters,
              queue depth, active slots, pod rank/mode when applicable
  evacuate  — preempt + return every queued/in-flight request (downscale)
  resume    — clear the draining flag (warm revive)
  shutdown  — clean exit (a pod head forwards it, so one shutdown retires
              every rank)

Pod execution: each rank builds the SAME engine (same config, same seed →
identical weights and per-request sampling streams) over a one-shard mesh
of its own device (``launch.mesh.local_pod_mesh``) and runs the full slot
set in lockstep with every other rank — mirror mode, the reference's
layout whenever its host loop cannot gather logits across processes, and
the only one here.  With ``--coordinator`` the ranks form a gloo group
(``init_distributed``) and probe it once (``spmd_across_processes``);
``status`` reports the verdict, the group's process count and its summed
device count.  Lockstep is verified, not assumed: non-head ranks answer
each step with a DIGEST of (completed rids+tokens, queue state) instead of
echoing completions, and the head compares digests every round — a
diverging rank surfaces as a typed ``PodDesyncError`` reply and the pod
retires, it does not silently serve two histories.  A lost rank is fatal
the same way: the head drops its router connection so the parent reaps
the pod cleanly.  Every wait on the rank fabric has a deadline
(``POD_RANK_TIMEOUT_S``; the group's rendezvous and collectives their
own), so a wedged rank retires the pod instead of hanging it.

Engine exceptions are caught per-message and replied as
``{"error": ..., "etype": ...}`` — a bad request must not kill the worker
that other requests are mid-generation on.  A rejected *batched* submit is
replied per-request (``"submit_errors"``) so one bad request cannot take
the round's good submits down with it.

Kernel launches and device memory are the worker's own, out of the
parent's sight: with ``REPRO_TORCH_WORKER_STATS=<dir>`` in its
environment, a worker writes ``<dir>/stats-<pid>.json`` — its process's
``kernels.ops.launch_counts()`` and, once it has used the card, its peak
allocated device bytes — whenever a mutating session ends, before it
answers ``shutdown``, and when it exits (``chip_smoke.py`` reads them over
a fleet).
"""
from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import select
import socket
import sys
import traceback
from pathlib import Path

from repro_torch.serving.transport import (
    _LEN,
    MAX_FRAME,
    Connection,
    Listener,
    TransportError,
    decode_config,
    decode_request,
    dial,
    encode_completion,
    parse_addr,
    unpack_payload,
)

# ops an observer session may issue — all read-only, none drain the
# mutator's metric window (report DOES drain: it stays mutator-only)
OBSERVER_OPS = frozenset({"ping", "lifetime", "status"})

# ops the pod head forwards to every non-head rank before running them
# locally (report rides along so follower windows drain instead of
# accumulating forever); shutdown is forwarded separately on exit
POD_LOCKSTEP_OPS = frozenset(
    {"init", "submit", "step", "evacuate", "resume", "report"})

# session RECEIVES never block (per-session buffers — a peer stalled
# mid-frame just parks its partial frame); this deadline bounds the SEND
# side: a peer that stops reading long enough to fill its receive window
# plus our send buffer is dropped instead of freezing the accept loop
SESSION_IO_TIMEOUT_S = 30.0

# the head's deadline per lockstep op on the rank fabric: generous enough
# for a rank's first step on a full-width model, finite so a wedged-but-
# alive rank (stuck device call; keepalive never fires) surfaces as a typed
# rank loss and the pod retires instead of hanging forever
POD_RANK_TIMEOUT_S = 600.0

# where a worker writes its launch counts and peak device memory (see the
# module docstring)
STATS_ENV = "REPRO_TORCH_WORKER_STATS"


class PodDesyncError(RuntimeError):
    """Two pod ranks produced different step results.  The ranks' engine
    states have already diverged, so the pod cannot serve another round —
    the head replies this typed error and retires."""


def _percentile(sorted_vals: list, q: float) -> float:
    """Nearest-rank percentile over an already-sorted list (stdlib-only —
    the worker avoids importing numpy for one summary)."""
    if not sorted_vals:
        return 0.0
    idx = min(int(q * len(sorted_vals)), len(sorted_vals) - 1)
    return float(sorted_vals[idx])


def step_digest(reply: dict) -> str:
    """Order-independent fingerprint of one step's observable outcome —
    what lockstep ranks must agree on (completions and queue state; NOT
    timestamps, which are host-local)."""
    basis = sorted((int(d["rid"]), tuple(int(t) for t in d["tokens_out"]))
                   for d in reply.get("completed", ()))
    blob = json.dumps([basis, int(reply["queue_depth"]),
                       int(reply["active"])]).encode()
    return hashlib.sha1(blob).hexdigest()[:16]


class PodRuntime:
    """One rank's pod context: identity (rank/size/coordinator), its
    ``device``, and — on the head — the mutating sessions it holds on
    every non-head rank."""

    def __init__(self, rank: int, size: int, coordinator: str | None,
                 peers: tuple[str, ...] = (), *, device: str = "cuda"):
        self.rank = int(rank)
        self.size = int(size)
        self.coordinator = coordinator
        self.peer_addrs = tuple(peers)
        self.device = device
        self.followers: list[Connection] = []
        self._seqs: list[int] = []
        self.mode: str | None = None       # "mirror" once the engine is up
        self.spmd_capable: bool | None = None
        self.process_count: int | None = None
        self.device_count: int | None = None
        self.digest_rounds = 0             # steps whose digests the head
        #                                    compared (the port's counter)

    @property
    def is_head(self) -> bool:
        return self.rank == 0

    # ----------------------------------------------------------- head side

    def connect_followers(self, *, connect_timeout_s: float = 60.0):
        """Dial every non-head rank and claim its mutating session.  The
        connections are owned by the head PROCESS, not by any one router
        session — a router detaching and re-attaching re-inits the
        engines over the same rank fabric."""
        for addr in self.peer_addrs:
            conn = dial(*parse_addr(addr), connect_timeout=connect_timeout_s,
                        timeout=POD_RANK_TIMEOUT_S)
            self.followers.append(conn)
            self._seqs.append(0)
            [reply] = self._collect([self._send(len(self.followers) - 1,
                                                {"op": "attach",
                                                 "mode": "mutate"})],
                                    conns=[conn])
            if "error" in reply:
                raise TransportError(
                    f"pod rank {len(self.followers)} refused the head's "
                    f"mutate attach: {reply['error']}")

    def _send(self, i: int, msg: dict) -> int:
        msg = dict(msg)
        seq, self._seqs[i] = self._seqs[i], self._seqs[i] + 1
        msg["seq"] = seq
        self.followers[i].send(msg)
        return seq

    def _collect(self, seqs: list[int], conns=None) -> list[dict]:
        replies = []
        for conn, seq in zip(conns or self.followers, seqs):
            reply = conn.recv()
            if reply.get("seq") != seq:
                raise TransportError(
                    f"pod lockstep desync on the rank fabric: expected "
                    f"reply seq {seq}, got {reply.get('seq')!r}")
            replies.append(reply)
        return replies

    def forward(self, msg: dict) -> list[int]:
        """Put one lockstep op on every rank's wire (send-only — the head
        runs its local copy while the ranks compute)."""
        return [self._send(i, msg) for i in range(len(self.followers))]

    def collect(self, seqs: list[int]) -> list[dict]:
        return self._collect(seqs)

    def close(self):
        for conn in self.followers:
            conn.close()
        self.followers.clear()

    # ---------------------------------------------------------- both sides

    def build_engine(self, msg: dict):
        """The pod's engine: one per rank, in mirror mode over this rank's
        one-device mesh.  Every rank passes through here exactly once per
        init (the head forwards init before running its own), so the
        group's rendezvous, its probe and its device count — collectives —
        are reached by every rank together.

        ``spmd_capable`` is gloo's verdict, where the reference's JAX CPU
        backend says False: both serve in mirror mode either way."""
        from repro_torch.launch.mesh import (
            global_device_count, init_distributed, local_pod_mesh,
            process_count, spmd_across_processes,
        )
        from repro_torch.serving.engine import ServingEngine
        from repro_torch.serving.replica import make_sharded_decode

        if self.size > 1 and self.coordinator:
            init_distributed(self.coordinator, self.size, self.rank)
            self.spmd_capable = spmd_across_processes(self.device)
        else:
            self.spmd_capable = False
        self.mode = "mirror"
        mesh = local_pod_mesh(device=self.device)
        if self.device_count is None:
            self.process_count = process_count()
            self.device_count = global_device_count(mesh.size)
        cfg = decode_config(msg["cfg"])
        slots, max_seq = int(msg["slots"]), int(msg["max_seq"])
        pool = msg.get("pool") or "dense"
        block_size, num_blocks = msg.get("block_size"), msg.get("num_blocks")
        engine = ServingEngine(cfg, slots=slots, max_seq=max_seq,
                               seed=int(msg.get("seed", 0)),
                               prefill_chunk=msg.get("prefill_chunk"),
                               replica_id=int(msg.get("replica_id", 0)),
                               pool=pool, block_size=block_size,
                               num_blocks=num_blocks, partitions=mesh.size,
                               spec_k=int(msg.get("spec_k", 0) or 0),
                               spec_ngram=int(msg.get("spec_ngram", 3) or 3),
                               mesh=mesh, device=self.device)
        engine.decode = make_sharded_decode(cfg, mesh, slots, max_seq,
                                            pool=pool, block_size=block_size,
                                            num_blocks=num_blocks)
        return engine

    def info(self) -> dict:
        out = {"rank": self.rank, "size": self.size, "mode": self.mode,
               "spmd_capable": self.spmd_capable}
        if self.mode is not None:
            out["process_count"] = self.process_count
            out["device_count"] = self.device_count
            out["digest_rounds"] = self.digest_rounds
        return out


def handle(engine, msg: dict, pod: PodRuntime | None = None, *,
           device: str = "cuda"):
    """One op → reply dict (engine may be None before init).  ``init``
    builds the engine on ``device``, the worker's own (a pod rank's
    through its PodRuntime)."""
    op = msg["op"]
    if op == "ping":
        return {"ok": True}
    if op == "attach":
        # fd-mode / pod-fabric reachable only: the --listen accept loop
        # arbitrates attaches itself.  A lone socketpair peer is the
        # mutator by construction, so the claim is always granted.
        return {"ok": True, "role": msg.get("mode", "mutate")}
    if op == "init":
        if pod is not None:
            return {"ok": True, "engine": pod.build_engine(msg)}
        from repro_torch.serving.engine import ServingEngine
        cfg = decode_config(msg["cfg"])
        engine = ServingEngine(cfg, slots=int(msg["slots"]),
                               max_seq=int(msg["max_seq"]),
                               seed=int(msg.get("seed", 0)),
                               prefill_chunk=msg.get("prefill_chunk"),
                               replica_id=int(msg.get("replica_id", 0)),
                               pool=msg.get("pool") or "dense",
                               block_size=msg.get("block_size"),
                               num_blocks=msg.get("num_blocks"),
                               spec_k=int(msg.get("spec_k", 0) or 0),
                               spec_ngram=int(msg.get("spec_ngram", 3) or 3),
                               device=device)
        return {"ok": True, "engine": engine}
    if op == "status":
        # observer-safe: reads accumulators, drains nothing.  The lifetime
        # latency SAMPLES are summarized to percentiles — a per-tick poll
        # must not ship the whole 4096-float history every round (the
        # authoritative samples stay available via the lifetime op)
        out = {"initialized": engine is not None}
        if engine is not None:
            lt = engine.lifetime()
            lats = sorted(lt.pop("latencies_ms"))
            lt["n_latencies"] = len(lats)
            lt["latency_p50_ms"] = _percentile(lats, 0.50)
            lt["latency_p95_ms"] = _percentile(lats, 0.95)
            out.update(queue_depth=engine.scheduler.depth,
                       active=int(engine.active.sum()),
                       draining=bool(engine.draining),
                       lifetime=lt)
        if pod is not None:
            out["pod"] = pod.info()
        return out
    if engine is None:
        raise RuntimeError(f"op {op!r} before init")
    if op == "submit":
        engine.submit(decode_request(msg["request"]), now=msg.get("now", 0.0))
        return {"ok": True}
    if op == "step":
        if "batch_gate" in msg:
            # gate changes ride the step message (like batched submits) and
            # apply BEFORE this round's submits/admission
            engine.scheduler.batch_gated = bool(msg["batch_gate"])
        submit_errors = []
        for d in msg.get("submits", ()):
            # enqueue BEFORE the round runs — identical ordering to the
            # unbatched flow, where each submit RPC preceded the step
            try:
                engine.submit(decode_request(d["request"]),
                              now=d.get("now", 0.0))
            except Exception as e:     # bounce per-request, run the round
                submit_errors.append({"rid": d["request"].get("rid"),
                                      "error": str(e),
                                      "etype": type(e).__name__})
        completed = engine.step(now=msg.get("now"))
        reply = {"completed": [encode_completion(r) for r in completed],
                 "queue_depth": engine.scheduler.depth,
                 "active": int(engine.active.sum()),
                 # one float so the parent's lifetime mirror (crash-proof
                 # fleet accounting) tracks occupancy too, not just counts
                 "slot_utilization": float(engine.stats.slot_utilization)}
        if submit_errors:
            reply["submit_errors"] = submit_errors
        if pod is not None and not pod.is_head:
            # lockstep verification beats N identical completion copies:
            # the head's stream is authoritative, the rank proves parity
            return {"digest": step_digest(reply),
                    "queue_depth": reply["queue_depth"],
                    "active": reply["active"]}
        return reply
    if op == "report":
        return {"window": engine.stats.drain_window()}
    if op == "lifetime":
        return {"lifetime": engine.lifetime()}
    if op == "evacuate":
        # rids only: the parent rewinds its own originals — the rewound
        # request state is derivable, so shipping it back would be waste
        engine.draining = True
        return {"rids": [r.rid for r in engine.evacuate()]}
    if op == "resume":
        engine.draining = False
        return {"ok": True}
    raise RuntimeError(f"unknown op {op!r}")


def dispatch(engine, msg: dict, pod: PodRuntime | None = None, *,
             device: str = "cuda"):
    """handle() plus pod lockstep: the head forwards a mutating op to every
    rank BEFORE running it locally (the ranks' compute overlaps the
    head's), then reconciles — step digests must match rank-for-rank, and
    a local exception is re-raised only after the rank replies are drained
    (the ranks failed the same deterministic way; leaving their replies
    unread would desync the fabric for the NEXT op)."""
    op = msg.get("op")
    if pod is None or not pod.is_head or op not in POD_LOCKSTEP_OPS \
            or not pod.followers:
        return handle(engine, msg, pod, device=device)
    seqs = pod.forward(msg)
    err = None
    reply = None
    try:
        reply = handle(engine, msg, pod, device=device)
    except Exception as e:
        err = e
    echoes = pod.collect(seqs)             # TransportError here is fatal
    if err is not None:
        raise err
    failed = [e for e in echoes if "error" in e]
    if failed:
        raise PodDesyncError(
            f"pod rank(s) errored where the head succeeded on {op!r}: "
            f"{[e['error'] for e in failed]}")
    if op == "step":
        pod.digest_rounds += 1
        mine = step_digest(reply)
        theirs = [e.get("digest") for e in echoes]
        if any(d != mine for d in theirs):
            raise PodDesyncError(
                f"pod lockstep divergence on step: head digest {mine}, "
                f"ranks {theirs} — the ranks' engine states have split")
    return reply


def _error_reply(e: Exception) -> dict:
    return {"error": f"{e}", "etype": type(e).__name__,
            "trace": traceback.format_exc(limit=8)}


def release(device: str):
    """The engine is gone: collect it and return the device's cached
    blocks, so the next session's engine finds the memory free."""
    gc.collect()
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()


def dump_stats():
    """Write this process's kernel launch counts and peak allocated device
    bytes (None before it used the card) where ``REPRO_TORCH_WORKER_STATS``
    says, if it is set."""
    out = os.environ.get(STATS_ENV)
    if not out:
        return
    import torch
    from repro_torch.kernels import ops
    peak = (torch.cuda.max_memory_allocated()
            if torch.cuda.is_initialized() else None)
    path = Path(out) / f"stats-{os.getpid()}.json"
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps({"launches": ops.launch_counts(),
                               "device_peak_bytes": peak}))
    os.replace(tmp, path)


def serve(conn: Connection, engine=None, *, device: str = "cuda") -> str:
    """Drive one connection to completion (fd mode — a lone socketpair
    peer, no listener); → "eof" (peer went away) or "shutdown"."""
    while True:
        try:
            msg = conn.recv()
        except TransportError:
            return "eof"
        if msg.get("op") == "shutdown":
            dump_stats()           # before the reply: the parent may
            try:                      # terminate us once it has it
                conn.send({"ok": True, "seq": msg.get("seq")})
            except TransportError:
                pass
            return "shutdown"
        try:
            reply = dispatch(engine, msg, device=device)
            engine = reply.pop("engine", engine)
        except Exception as e:            # typed bounce, worker stays up
            reply = _error_reply(e)
        reply["seq"] = msg.get("seq")     # the desync-detection echo
        try:
            conn.send(reply)
        except TransportError:
            # the peer detached mid-round (router torn down with a step in
            # flight): same as EOF on recv
            return "eof"


class _Session:
    __slots__ = ("conn", "role", "buf")

    def __init__(self, conn: Connection):
        self.conn = conn
        self.role: str | None = None       # None until the first message
        self.buf = b""                     # partial-frame receive buffer


def _reject(conn: Connection, seq, error: str, etype: str):
    try:
        conn.send({"error": error, "etype": etype, "seq": seq})
    except TransportError:
        pass


def serve_listener(listener: Listener, *, once: bool = False,
                   pod: PodRuntime | None = None,
                   device: str = "cuda") -> int:
    """The concurrent accept loop: one mutating session + any number of
    read-only observers, multiplexed over select with NON-BLOCKING
    per-session receive buffers — a peer stalled mid-frame parks its
    partial frame in its own buffer and costs the other sessions nothing
    (the isolation the observer contract promises; only a peer that stops
    *reading* long enough to back up the send side is dropped, after
    SESSION_IO_TIMEOUT_S).  EOF on the mutator drops its engine, releases
    the device's cached memory and sends us back to accept (the next
    router re-inits its own engine); shutdown — or ``once`` after the
    first mutating session ends — ends the process.  A pod head
    additionally holds the rank fabric: losing a rank (TransportError) or
    a lockstep divergence (PodDesyncError) is fatal for the whole pod —
    the head retires so the router reaps it."""
    engine = None
    mutator: _Session | None = None
    sessions: dict[socket.socket, _Session] = {}

    def drop(sess: _Session):
        nonlocal mutator, engine
        sessions.pop(sess.conn.sock, None)
        sess.conn.close()
        if sess is mutator:
            mutator = None
            engine = None             # the next mutator re-inits its own
            release(device)
            dump_stats()

    def close_all():
        for sess in list(sessions.values()):
            sess.conn.close()
        sessions.clear()
        if pod is not None:
            pod.close()
        listener.close()

    def pump(sess: _Session):
        """Drain the bytes available RIGHT NOW (select guarantees one recv
        returns promptly) and slice complete frames off the session
        buffer; → decoded messages, or None when the peer is gone or its
        framing broke (oversized length, garbage payload)."""
        try:
            chunk = sess.conn.sock.recv(1 << 16)
        except (BlockingIOError, InterruptedError):
            return []
        except OSError:
            return None
        if not chunk:
            return None
        sess.buf += chunk
        msgs = []
        while len(sess.buf) >= _LEN.size:
            (n,) = _LEN.unpack(sess.buf[:_LEN.size])
            if n > MAX_FRAME:
                return None
            if len(sess.buf) < _LEN.size + n:
                break
            payload = sess.buf[_LEN.size:_LEN.size + n]
            sess.buf = sess.buf[_LEN.size + n:]
            try:
                msgs.append(unpack_payload(payload))
            except TransportError:
                return None
        return msgs

    def process(sess: _Session, msg: dict):
        """One message through role assignment + dispatch; → None to keep
        serving, or the process's exit code."""
        nonlocal mutator, engine
        seq = msg.get("seq")
        op = msg.get("op")

        # -------------------------------------------- role assignment
        if sess.role is None:
            if op == "attach":
                mode = msg.get("mode", "mutate")
                if mode == "observe":
                    sess.role = "observe"
                elif mode == "mutate":
                    if mutator is not None:
                        _reject(sess.conn, seq,
                                "worker already has a mutating session; "
                                "attach as an observer or wait for the "
                                "detach", "WorkerBusyError")
                        drop(sess)
                        return None
                    sess.role = "mutate"
                    mutator = sess
                else:
                    _reject(sess.conn, seq,
                            f"unknown attach mode {mode!r}", "ValueError")
                    drop(sess)
                    return None
                try:
                    sess.conn.send({"ok": True, "role": sess.role,
                                    "seq": seq})
                except TransportError:
                    drop(sess)
                return None
            # legacy first op: an implicit mutate claim
            if mutator is not None:
                _reject(sess.conn, seq,
                        "worker already has a mutating session",
                        "WorkerBusyError")
                drop(sess)
                return None
            sess.role = "mutate"
            mutator = sess

        # ------------------------------------------------ dispatch
        if sess.role == "observe" and op not in OBSERVER_OPS:
            _reject(sess.conn, seq,
                    f"op {op!r} needs the mutating session (observers "
                    f"are read-only)", "PermissionError")
            return None
        if op == "shutdown":
            if pod is not None and pod.is_head:
                try:
                    pod.forward({"op": "shutdown"})
                except TransportError:
                    pass              # a rank already gone cannot object
            dump_stats()
            try:
                sess.conn.send({"ok": True, "seq": seq})
            except TransportError:
                pass
            return 0
        try:
            reply = dispatch(engine, msg, pod, device=device)
            engine = reply.pop("engine", engine)
        except TransportError as e:
            # a pod rank is gone: the lockstep contract is broken for
            # good — retire the whole pod; the parent's dead connection
            # is its typed signal to reap us
            print(f"pod head: rank fabric lost ({e}); retiring",
                  file=sys.stderr, flush=True)
            return 1
        except PodDesyncError as e:
            _reject(sess.conn, seq, str(e), "PodDesyncError")
            print(f"pod head: {e}; retiring", file=sys.stderr, flush=True)
            return 1
        except Exception as e:        # typed bounce, worker stays up
            reply = _error_reply(e)
        reply["seq"] = seq            # the desync-detection echo
        try:
            sess.conn.send(reply)
        except TransportError:
            was_mutator = sess is mutator
            drop(sess)
            if was_mutator and once:
                return 0
        return None

    try:
        while True:
            rlist = [listener.sock] + list(sessions)
            readable, _, _ = select.select(rlist, [], [])
            for sock in readable:
                if sock is listener.sock:
                    try:
                        conn = listener.accept(
                            timeout=SESSION_IO_TIMEOUT_S,
                            conn_timeout=SESSION_IO_TIMEOUT_S)
                    except TransportError:
                        continue
                    sessions[conn.sock] = _Session(conn)
                    continue
                sess = sessions.get(sock)
                if sess is None:
                    continue
                msgs = pump(sess)
                if msgs is None:
                    was_mutator = sess is mutator
                    drop(sess)
                    if was_mutator and once:
                        return 0
                    continue
                for msg in msgs:
                    rc = process(sess, msg)
                    if rc is not None:
                        return rc
                    if sess.conn.sock not in sessions:
                        break         # process() dropped this session
    finally:
        close_all()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    ap = argparse.ArgumentParser(prog="repro_torch.serving.worker")
    ap.add_argument("fd", nargs="?", type=int,
                    help="inherited socketpair fd (ProcessReplica mode)")
    ap.add_argument("--listen", metavar="HOST:PORT",
                    help="bind a TCP listener instead (port 0 = kernel-"
                         "picked); prints WORKER_LISTENING host:port")
    ap.add_argument("--once", action="store_true",
                    help="exit after the first mutating session ends")
    ap.add_argument("--pod-rank", type=int, default=None,
                    help="this worker's rank in a multi-process pod "
                         "(0 = the RPC head)")
    ap.add_argument("--pod-size", type=int, default=None,
                    help="total ranks in the pod")
    ap.add_argument("--coordinator", metavar="HOST:PORT", default=None,
                    help="the pod's gloo rendezvous address (rank 0 "
                         "binds it; all ranks dial it)")
    ap.add_argument("--pod-peers", metavar="HOST:PORT,...", default=None,
                    help="head only: the non-head ranks' listen addresses, "
                         "rank-ordered")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where init builds the engine (the port's one "
                         "addition to the reference's flags; cuda raises "
                         "without a card)")
    args = ap.parse_args(argv)
    pod = None
    if args.pod_rank is not None:
        if not args.listen:
            ap.error("--pod-rank needs --listen")
        if not args.pod_size or args.pod_size < 1:
            ap.error("--pod-rank needs --pod-size >= 1")
        if not (0 <= args.pod_rank < args.pod_size):
            ap.error("--pod-rank must be in [0, pod-size)")
        peers = tuple(p for p in (args.pod_peers or "").split(",") if p)
        if args.pod_rank == 0:
            if len(peers) != args.pod_size - 1:
                ap.error(f"head needs --pod-peers with {args.pod_size - 1} "
                         f"address(es)")
        elif peers:
            ap.error("--pod-peers is head-only (rank 0)")
        pod = PodRuntime(args.pod_rank, args.pod_size, args.coordinator,
                         peers, device=args.device)
    if args.listen is None and args.fd is None:
        ap.error("need an inherited fd or --listen host:port")
    from repro_torch.device import resolve_device
    resolve_device(args.device)           # no card for cuda: raise now
    try:
        if args.listen:
            host, port = parse_addr(args.listen)
            listener = Listener(host, port)
            if pod is not None and pod.is_head and pod.peer_addrs:
                # claim every rank's mutating session BEFORE announcing
                # the pod — the banner means "dialable and whole"
                pod.connect_followers()
            print(f"WORKER_LISTENING {listener.host}:{listener.port}",
                  flush=True)
            return serve_listener(listener, once=args.once, pod=pod,
                                  device=args.device)
        sock = socket.socket(fileno=args.fd)
        serve(Connection(sock), device=args.device)
        return 0
    finally:
        dump_stats()


if __name__ == "__main__":
    sys.exit(main())
