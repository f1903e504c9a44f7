"""Replica worker: a ServingEngine driven over the socket transport
(``repro.serving.worker`` without its pod mode).

Two ways to become a worker:

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

``--device`` is the one addition to the reference's command line: the
worker process owns its device, and ``init`` builds its engine there
(``ServingEngine(..., device=...)``), so the wire protocol's ``init``
fields stay exactly the reference's.  It defaults to ``cuda``; without a
card the worker raises at startup rather than carry on on the CPU.  The
reference's multi-process pod flags (``--pod-rank``, ``--pod-size``,
``--coordinator``, ``--pod-peers``) are accepted and refused by name: pods
wait for the port's multi-device work (D3).

Concurrent sessions (``--listen`` mode): the accept loop multiplexes ONE
mutating session (a router's SocketReplica) with ANY number of read-only
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
              queue depth, active slots
  evacuate  — preempt + return every queued/in-flight request (downscale)
  resume    — clear the draining flag (warm revive)
  shutdown  — clean exit

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
    encode_completion,
    parse_addr,
    unpack_payload,
)

# ops an observer session may issue — all read-only, none drain the
# mutator's metric window (report DOES drain: it stays mutator-only)
OBSERVER_OPS = frozenset({"ping", "lifetime", "status"})

# session RECEIVES never block (per-session buffers — a peer stalled
# mid-frame just parks its partial frame); this deadline bounds the SEND
# side: a peer that stops reading long enough to fill its receive window
# plus our send buffer is dropped instead of freezing the accept loop
SESSION_IO_TIMEOUT_S = 30.0

# where a worker writes its launch counts and peak device memory (see the
# module docstring)
STATS_ENV = "REPRO_TORCH_WORKER_STATS"

# the reference's pod flags, refused by name until D3
POD_FLAGS = ("--pod-rank", "--pod-size", "--coordinator", "--pod-peers")


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


def handle(engine, msg: dict, *, device: str = "cuda"):
    """One op → reply dict (engine may be None before init).  ``init``
    builds the engine on ``device``, the worker's own."""
    op = msg["op"]
    if op == "ping":
        return {"ok": True}
    if op == "attach":
        # fd-mode reachable only: the --listen accept loop arbitrates
        # attaches itself.  A lone socketpair peer is the mutator by
        # construction, so the claim is always granted.
        return {"ok": True, "role": msg.get("mode", "mutate")}
    if op == "init":
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


def dispatch(engine, msg: dict, *, device: str = "cuda"):
    """One session message through ``handle``.  The reference's pod head
    forwards its mutating ops to the other ranks here first; pods wait for
    D3, so every op runs locally."""
    return handle(engine, msg, device=device)


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
    first mutating session ends — ends the process."""
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
            dump_stats()
            try:
                sess.conn.send({"ok": True, "seq": seq})
            except TransportError:
                pass
            return 0
        try:
            reply = dispatch(engine, msg, device=device)
            engine = reply.pop("engine", engine)
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
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where init builds the engine (the port's one "
                         "addition to the reference's flags; cuda raises "
                         "without a card)")
    for flag in POD_FLAGS:
        ap.add_argument(flag, default=None,
                        help="multi-process pods: not ported yet (D3)")
    args = ap.parse_args(argv)
    for flag in POD_FLAGS:
        if getattr(args, flag[2:].replace("-", "_")) is not None:
            ap.error(f"{flag}: multi-process pods are not ported yet (they "
                     f"wait for D3)")
    if args.listen is None and args.fd is None:
        ap.error("need an inherited fd or --listen host:port")
    from repro_torch.device import resolve_device
    resolve_device(args.device)           # no card for cuda: raise now
    try:
        if args.listen:
            host, port = parse_addr(args.listen)
            listener = Listener(host, port)
            print(f"WORKER_LISTENING {listener.host}:{listener.port}",
                  flush=True)
            return serve_listener(listener, once=args.once,
                                  device=args.device)
        sock = socket.socket(fileno=args.fd)
        serve(Connection(sock), device=args.device)
        return 0
    finally:
        dump_stats()


if __name__ == "__main__":
    sys.exit(main())
