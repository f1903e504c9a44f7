"""The Replica protocol: the router's only view of a serving engine
(``repro.serving.replica``).

The router is written purely against this surface (submit / step / report
/ scale hooks), so the replica boundary is a message protocol, never an
engine reference.  Backends:

  InProcessReplica — the port's ServingEngine wrapped 1:1 (zero transport).
  ProcessReplica   — the engine lives in a worker subprocess
                     (``python -m repro_torch.serving.worker <fd>``) and is
                     driven over the length-prefixed JSON transport
                     (serving/transport.py + serving/worker.py).  Reports
                     stream back as wire messages and are materialized into
                     the same ReplicaReport the collector already consumes;
                     the parent-side stub measures per-call transport
                     latency (EWMA) and stamps it on every report.
  TcpReplica       — the same stub over a TCP connection: the worker is a
                     pod (``--listen host:port``) the router ATTACHES to
                     rather than forks, with connect/handshake deadlines and
                     keepalive.  When no address is given the stub spawns a
                     local TCP worker (demos/CI) and owns its lifetime.
  ShardedReplica   — ONE engine spanning a device mesh (launch/mesh.py):
                     the pool's slots (and, paged, its blocks) are split
                     into one shard per mesh device, and the decode tick
                     runs ``LM.decode`` shard by shard, each on its device
                     with the parameters carried there once.  Prefill
                     stays on the core's device (batch-1); only the
                     per-tick batched decode is sharded.
  DistributedPodReplica — TcpReplica against the HEAD of a multi-process
                     pod: N worker ranks (``--pod-rank/--pod-size``, a
                     gloo ``--coordinator``) jointly back one replica the
                     router addresses as a single unit; rank 0 forwards
                     mutating ops so the ranks step in lockstep
                     (digest-verified).

Each worker process owns its device (``--device``, cuda unless the caller
asks for cpu) and draws its weights from the init message's seed, so a
worker on the device an in-process ``EngineCore`` uses serves the same
weights.

Attach handshake: a listening worker serves ONE mutating session plus any
number of read-only observers (serving/observe.py) concurrently, so an
external monitor can poll lifetime()/status() without stealing the
router's connection.  SocketReplica claims the mutating session with an
explicit ``attach`` before init; losing the race surfaces as a typed
WorkerBusyError, never a protocol desync.

Remote stubs share SocketReplica: a strict request/reply RPC stream where
every message carries a sequence number the reply must echo — a duplicated,
dropped, or reordered frame (fault injection, a broken proxy) surfaces as a
typed TransportError desync instead of silently mismatched replies.  Per-
tick submits are BATCHED into the step message (``batch_submits``, default
on): one step RPC per round per replica replaces 1 + len(submits)
messages.

Protocol semantics the router relies on:

* ``step(now)`` returns the *caller's* completed Request objects (a remote
  backend merges wire results back into the originals), and never hangs —
  a dead peer flips ``failed`` and returns [].
* ``evacuate()`` empties the replica NOW: queued requests plus in-flight
  ones preempted and rewound (Request.reset_generation) — the router
  requeues them through surviving replicas' schedulers, so a downscale
  never strands a mid-generation request.
* ``report(tick)`` must keep flowing after park/evacuate (an explicit empty
  window zeroes the collector's last-report replay) and after failure (an
  ``n_errors > 0`` report is how a crash surfaces as a collector straggler).
* ``lost_requests()`` recovers the submitter-side copies of everything that
  was inside a failed replica.
"""
from __future__ import annotations

import copy
import socket
import subprocess
import sys
import time
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from repro_torch.core.monitoring.collector import ReplicaReport
from repro_torch.serving.engine import (
    EngineCore, ServingEngine, validate_request,
)
from repro_torch.serving.fleet import spawn_worker, worker_env
from repro_torch.serving.scheduler import Request, validate_tier
from repro_torch.serving.transport import (
    Connection,
    TransportError,
    WorkerBusyError,
    apply_request,
    dial,
    encode_config,
    encode_request,
    parse_addr,
)


@runtime_checkable
class Replica(Protocol):
    """What the router is allowed to know about a replica."""

    replica_id: int

    def submit(self, request: Request, now: float = 0.0) -> None: ...
    def step(self, now: float | None = None) -> list[Request]: ...
    # split-phase step: the router begins the round on EVERY replica before
    # collecting ANY result, so remote replicas decode concurrently (one
    # outstanding request per connection) instead of serializing the fleet's
    # decode round.  step(now) ≡ begin_step(now); finish_step().
    def begin_step(self, now: float | None = None) -> None: ...
    def finish_step(self) -> list[Request]: ...
    def report(self, tick: int) -> ReplicaReport: ...
    def lifetime(self) -> dict: ...
    def evacuate(self) -> list[Request]: ...
    def resume(self) -> None: ...
    # control-plane lane gate: while on, the engine admits no batch-tier
    # work (queued batch requests stay queued) — interactive SLO protection
    def gate_batch(self, on: bool) -> None: ...
    def lost_requests(self) -> list[Request]: ...
    def close(self) -> None: ...

    @property
    def load(self) -> float: ...
    @property
    def idle(self) -> bool: ...
    @property
    def queue_depth(self) -> int: ...
    @property
    def pending(self) -> int: ...
    @property
    def draining(self) -> bool: ...
    @property
    def failed(self) -> bool: ...
    @property
    def transport_ms(self) -> float: ...


def _report_from_window(replica_id: int, tick: int, w: dict, *,
                        n_errors: int = 0,
                        transport_ms: float = 0.0) -> ReplicaReport:
    return ReplicaReport(
        replica_id=replica_id, tick=tick,
        latency_ms_samples=w["latency_ms_samples"],
        n_requests=w["n_requests"], n_errors=n_errors,
        flop_util=w["slot_util"],
        hbm_util=w["slot_util"],          # slot occupancy stands in
        ici_util=0.0,                     # for the device's own signals
        mem_frac=w["slot_util"],
        queue_depth=w["queue_depth"],
        # .get: pre-speculation windows (the empty-window tombstone, a
        # worker running older code) simply report zero speculation
        spec_proposed=int(w.get("spec_proposed", 0)),
        spec_accepted=int(w.get("spec_accepted", 0)),
        # .get → None: pre-tier windows feed the untiered channels only
        lat_tiers=w.get("lat_tiers") or None,
        transport_ms=transport_ms)


_EMPTY_WINDOW = {"latency_ms_samples": [], "n_requests": 0, "n_tokens": 0,
                 "slot_util": 0.0, "queue_depth": 0}


def empty_report(replica_id: int, tick: int) -> ReplicaReport:
    """A clean idle-window report — the router's tombstone for retired
    replicas reuses the one report-shape definition instead of a by-hand
    field list."""
    return _report_from_window(replica_id, tick, dict(_EMPTY_WINDOW))


# ---------------------------------------------------------------------------
# in-process backend
# ---------------------------------------------------------------------------


class InProcessReplica:
    """The protocol over a same-process ServingEngine (zero transport)."""

    kind = "inproc"

    def __init__(self, engine: ServingEngine):
        self.engine = engine
        self.failed = False
        self._step_done: list[Request] = []

    @classmethod
    def build(cls, cfg, *, slots: int, max_seq: int, seed: int = 0,
              prefill_chunk: int | None = None,
              core: EngineCore | None = None,
              replica_id: int = 0, pool: str = "dense",
              block_size: int | None = None,
              num_blocks: int | None = None, spec_k: int = 0,
              spec_ngram: int = 3, device="cuda") -> "InProcessReplica":
        return cls(ServingEngine(cfg, slots=slots, max_seq=max_seq,
                                 seed=seed, prefill_chunk=prefill_chunk,
                                 core=core, replica_id=replica_id,
                                 pool=pool, block_size=block_size,
                                 num_blocks=num_blocks, spec_k=spec_k,
                                 spec_ngram=spec_ngram, device=device))

    # ------------------------------------------------------------- protocol

    @property
    def replica_id(self) -> int:
        return self.engine.replica_id

    def submit(self, request: Request, now: float = 0.0):
        self.engine.submit(request, now=now)

    def step(self, now: float | None = None) -> list[Request]:
        return self.engine.step(now=now)

    def begin_step(self, now: float | None = None):
        # in-process: nothing to overlap with — run the round eagerly.
        # EXTEND, don't replace: if the previous round's results were never
        # collected (the caller's collection loop raised mid-way), they are
        # still owed to the caller
        self._step_done.extend(self.engine.step(now=now))

    def finish_step(self) -> list[Request]:
        out, self._step_done = self._step_done, []
        return out

    def report(self, tick: int) -> ReplicaReport:
        return _report_from_window(self.replica_id, tick,
                                   self.engine.stats.drain_window())

    def lifetime(self) -> dict:
        return self.engine.lifetime()

    def evacuate(self) -> list[Request]:
        self.engine.draining = True
        return self.engine.evacuate()

    def resume(self):
        self.engine.draining = False

    def gate_batch(self, on: bool):
        self.engine.scheduler.batch_gated = bool(on)

    def lost_requests(self) -> list[Request]:
        return []                      # an in-process replica cannot crash

    def close(self):
        pass

    @property
    def load(self) -> float:
        return self.engine.load

    @property
    def idle(self) -> bool:
        return self.engine.idle

    @property
    def queue_depth(self) -> int:
        return self.engine.scheduler.depth

    @property
    def pending(self) -> int:
        """Queued + in-flight — everything inside this replica."""
        return self.engine.scheduler.depth + int(self.engine.active.sum())

    @property
    def draining(self) -> bool:
        return self.engine.draining

    @draining.setter
    def draining(self, value: bool):
        self.engine.draining = bool(value)

    @property
    def transport_ms(self) -> float:
        return 0.0


# ---------------------------------------------------------------------------
# sharded backend: one replica spanning a device mesh
# ---------------------------------------------------------------------------


def make_sharded_decode(cfg, mesh, slots: int, max_seq: int, *,
                        pool: str = "dense", block_size: int | None = None,
                        num_blocks: int | None = None):
    """The engine decode step over a mesh: the slot axis of the tokens, the
    cache and the logits is split over EVERY mesh axis (the pool's
    ``ShardedCache``, laid out by ``sharding.pod_decode_rules`` and
    ``spec_for``), and each shard runs ``LM.decode`` over its slots on its
    device.  The decode is collective-free (purely batch-parallel).  The
    shards launch one after another from the host thread; CUDA launches
    are asynchronous, so shards on distinct devices overlap.  Returns the
    logits in slot order, on the tokens' device, and the sharded cache.

    The parameters are replicated: the caller's ``LM`` serves every shard
    on its own device, and a copy is carried once to each other distinct
    device and kept — never one copy per shard.  ``pool``,
    ``block_size`` and ``num_blocks`` keep the reference's signature; the
    pool itself carries its layout."""
    from repro_torch.device import same_device
    from repro_torch.models.steps import make_decode_step

    devices = mesh.flat_devices()
    n = len(devices)
    if slots % n:
        raise ValueError(f"slots ({slots}) must divide evenly over the "
                         f"mesh ({n} devices)")
    per = slots // n
    step = make_decode_step(cfg)
    copies: dict = {}            # device → (source LM, its copy there)

    def params_on(params, dev):
        if same_device(params.device, dev):
            return params
        src, there = copies.get(dev, (None, None))
        if src is not params:
            there = copy.deepcopy(params).to(dev)
            there.recast()
            copies[dev] = (params, there)
        return there

    def decode(params, tokens, cache):
        logits, shards = [], []
        for k, dev in enumerate(devices):
            lg, c = step(params_on(params, dev),
                         tokens[k * per:(k + 1) * per].to(dev),
                         cache.shards[k])
            logits.append(lg)
            shards.append(c)
        return (torch.cat([lg.to(tokens.device) for lg in logits]),
                cache.replace(shards))

    return decode


class ShardedReplica(InProcessReplica):
    """One engine spanning a device mesh: S slots / N shards, shard k's
    slots (and, paged, its block range) on the mesh's k-th device.  With
    no ``mesh``: one shard on each CUDA device (``device="cpu"``: one shard
    on the CPU).  Prefill runs on the engine core's device."""

    kind = "sharded"

    def __init__(self, cfg, *, slots: int, max_seq: int, mesh=None,
                 seed: int = 0, prefill_chunk: int | None = None,
                 core: EngineCore | None = None, replica_id: int = 0,
                 decode_fn=None, pool: str = "dense",
                 block_size: int | None = None,
                 num_blocks: int | None = None, spec_k: int = 0,
                 spec_ngram: int = 3, device="cuda"):
        if mesh is None:
            mesh = default_mesh(core.device if core is not None else device)
        n_dev = int(mesh.devices.size)
        if slots % n_dev != 0:
            raise ValueError(f"slots ({slots}) must divide evenly over the "
                             f"mesh ({n_dev} devices)")
        # paged allocator partitions track the mesh: slot s draws blocks
        # only from its own shard's contiguous block range.  The spec knobs
        # are accepted but inert: the sharded decode routes every tick down
        # the legacy bulk-pull path
        engine = ServingEngine(cfg, slots=slots, max_seq=max_seq, seed=seed,
                               prefill_chunk=prefill_chunk, core=core,
                               replica_id=replica_id, pool=pool,
                               block_size=block_size, num_blocks=num_blocks,
                               partitions=n_dev, spec_k=spec_k,
                               spec_ngram=spec_ngram, mesh=mesh,
                               device=device)
        engine.decode = (decode_fn if decode_fn is not None
                         else make_sharded_decode(cfg, mesh, slots, max_seq,
                                                  pool=pool,
                                                  block_size=block_size,
                                                  num_blocks=num_blocks))
        super().__init__(engine)
        self.mesh = mesh


def default_mesh(device="cuda"):
    """The sharded topology's mesh when none is given: one ("data",) shard
    on each CUDA device, or one on the CPU."""
    from repro_torch.launch.mesh import make_mesh
    if torch.device(device).type == "cpu":
        return make_mesh((1,), ("data",), devices=["cpu"])
    return make_mesh((max(torch.cuda.device_count(), 1),), ("data",))


# ---------------------------------------------------------------------------
# remote backends: the engine behind a socket (subprocess pipe or TCP)
# ---------------------------------------------------------------------------


class SocketReplica:
    """Parent-side stub driving a remote engine over the framed JSON
    transport.  The stub tracks every in-system request so (a) routing
    load is computed locally without an RPC per submit, and (b) a worker
    crash loses no submitter state — ``lost_requests()`` rewinds and
    returns the originals for requeue.

    The RPC stream is strict request/reply with per-message sequence
    numbers: the reply must echo the request's ``seq``, so a duplicated or
    dropped frame anywhere on the path surfaces as a TransportError desync
    (→ the router reaps the replica) instead of every later reply landing
    on the wrong call.  With ``batch_submits`` (default), submits buffer
    parent-side and ride the next step message — one RPC per decode round
    per replica; a malformed request still bounces at submit because the
    stub runs the engine's own ``validate_request`` locally.

    Subclasses own transport establishment: ProcessReplica forks a worker
    over a socketpair, TcpReplica dials a listening worker (and optionally
    owns a locally-spawned one).  ``proc`` is the owned worker process, if
    any — its exit is probed at submit so a silently-dead local worker
    fails over immediately rather than a round later."""

    kind = "socket"

    def __init__(self, cfg, conn: Connection, *, slots: int, max_seq: int,
                 seed: int = 0, prefill_chunk: int | None = None,
                 replica_id: int = 0, proc: subprocess.Popen | None = None,
                 rpc_timeout_s: float = 120.0,
                 init_timeout_s: float = 600.0,
                 batch_submits: bool = True, pool: str = "dense",
                 block_size: int | None = None,
                 num_blocks: int | None = None, spec_k: int = 0,
                 spec_ngram: int = 3):
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.replica_id = replica_id
        self.failed = False
        self._closed = False
        self.batch_submits = batch_submits
        self._draining = False
        self.transport_ms = 0.0
        self.rpc_count = 0                # frames sent (the batching metric)
        self._seq = 0
        self._requests: dict[int, Request] = {}   # rid → submitter's object
        self._outbox: list[dict] = []     # encoded submits awaiting a step
        self._queue_depth = 0
        self._active = 0
        self._step_pending = False
        self._step_seq = -1
        self._stepped_once = False
        self._late: list[Request] = []    # completions drained out-of-band
        self._rpc_timeout_s = rpc_timeout_s
        self._init_timeout_s = init_timeout_s
        self._batch_gated = False
        self._gate_dirty = False          # gate change awaiting a step msg
        self._lifetime_cache = {
            "latencies_ms": [], "total_tokens": 0, "total_completed": 0,
            "completed_interactive": 0, "completed_batch": 0,
            "total_ticks": 0, "slot_utilization": 0.0, "queue_depth": 0}
        self._conn = conn
        self._proc = proc
        # two-step handshake: claim the worker's single mutating session
        # (a second router racing us bounces typed as WorkerBusyError —
        # observers attach read-only and are never in contention), then
        # have the worker build the identical engine from the wire (it
        # draws the weights from the seed — give it a generous deadline)
        self._rpc({"op": "attach", "mode": "mutate"})
        self._rpc({"op": "init", "cfg": encode_config(cfg), "slots": slots,
                   "max_seq": max_seq, "seed": seed,
                   "prefill_chunk": prefill_chunk,
                   "replica_id": replica_id, "pool": pool,
                   "block_size": block_size, "num_blocks": num_blocks,
                   "spec_k": spec_k, "spec_ngram": spec_ngram},
                  timeout=init_timeout_s)

    # ------------------------------------------------------------- plumbing

    # ops whose worker-side cost is negligible: their round trip IS the
    # transport.  step/init RPCs contain real compute (weights, decode) —
    # folding those in would report model time as fabric overhead.
    _TRANSPORT_OPS = frozenset({"ping", "report", "lifetime", "resume"})

    def _send(self, msg: dict) -> int:
        """Stamp the next sequence number and put one frame on the wire."""
        seq, self._seq = self._seq, self._seq + 1
        msg["seq"] = seq
        self.rpc_count += 1
        self._conn.send(msg)
        return seq

    def _recv_reply(self, seq: int) -> dict:
        reply = self._conn.recv()
        if reply.get("seq") != seq:
            raise TransportError(
                f"replica {self.replica_id} protocol desync: expected reply "
                f"seq {seq}, got {reply.get('seq')!r} (duplicated, dropped, "
                f"or reordered frame)")
        return reply

    def _rpc(self, msg: dict, *, timeout: float | None = None) -> dict:
        if self._closed:
            # a retired replica still answers lifetime() from its mirror —
            # the raise must be typed, not an EBADF from the dead socket
            raise TransportError(f"replica {self.replica_id} is closed")
        if self.failed:
            raise TransportError(f"replica {self.replica_id} is lost")
        if self._step_pending:
            # an unread step reply from an abandoned round: drain it first —
            # otherwise THIS op's recv would read the stale step reply and
            # every later RPC on the connection would be off by one
            self._late.extend(self.finish_step())
            if self.failed:
                raise TransportError(f"replica {self.replica_id} is lost")
        self._conn.sock.settimeout(timeout if timeout is not None
                                   else self._rpc_timeout_s)
        t0 = time.perf_counter()
        try:
            seq = self._send(msg)
            reply = self._recv_reply(seq)
        except TransportError:
            self._mark_failed()
            raise
        if msg["op"] in self._TRANSPORT_OPS:
            dt_ms = (time.perf_counter() - t0) * 1e3
            self.transport_ms = (dt_ms if self.transport_ms == 0.0
                                 else 0.8 * self.transport_ms + 0.2 * dt_ms)
        if "error" in reply:
            if reply.get("etype") == "ValueError":
                raise ValueError(reply["error"])
            if reply.get("etype") == "WorkerBusyError":
                # the worker's mutating session belongs to someone else —
                # this stub never owned the peer, so fail typed and final
                self._mark_failed()
                raise WorkerBusyError(
                    f"replica {self.replica_id}: {reply['error']}")
            if reply.get("etype") == "PodDesyncError":
                # a pod whose ranks diverged retires as a unit — same
                # router-side surface as a lost rank (reap + requeue),
                # NEVER a loop-crashing engine error
                self._mark_failed()
                raise TransportError(
                    f"replica {self.replica_id} pod desync: "
                    f"{reply['error']}")
            raise RuntimeError(
                f"worker {self.replica_id}: {reply['error']}\n"
                f"{reply.get('trace', '')}")
        return reply

    def _mark_failed(self):
        self.failed = True
        self._step_pending = False
        self._conn.close()
        if self._proc is not None:
            if self._proc.poll() is None:
                self._proc.kill()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                # un-reaped zombie; do not let the reap race replace the
                # TransportError the caller's failover path is matching on
                pass

    # ------------------------------------------------------------- protocol

    def submit(self, request: Request, now: float = 0.0):
        if self.failed:
            raise TransportError(f"replica {self.replica_id} is lost")
        if self._proc is not None and self._proc.poll() is not None:
            # owned worker died between steps: one cheap probe turns a
            # doomed buffered submit into an immediate router failover
            self._mark_failed()
            raise TransportError(
                f"replica {self.replica_id} worker exited "
                f"(rc={self._proc.returncode})")
        if self.batch_submits:
            # the submit rides the NEXT step message (one RPC per round,
            # not per request); the engine's own validation runs locally so
            # a malformed request still bounces at the submit call
            validate_tier(request.tier)
            validate_request(self.cfg, self.max_seq,
                             np.asarray(request.prompt).reshape(-1),
                             frames=request.frames)
            self._outbox.append({"request": encode_request(request),
                                 "now": now})
        else:
            self._rpc({"op": "submit", "request": encode_request(request),
                       "now": now})
        if request.t_submit is None:      # mirror the worker-side stamp
            request.t_submit = now
        self._requests[request.rid] = request

    def step(self, now: float | None = None) -> list[Request]:
        self.begin_step(now)
        return self.finish_step()

    def begin_step(self, now: float | None = None):
        """Fire the step message without waiting for the reply — the router
        begins the round on every replica first, so N workers decode
        concurrently and the fleet's round costs max(worker time), not the
        sum.  Buffered submits flush inside this one message."""
        if self._step_pending:
            # an unread reply from an abandoned round (the caller caught an
            # error mid-collection): drain it — dropping it would desync the
            # strict request/reply stream, and its completions are real
            self._late.extend(self.finish_step())
        if self.failed:
            return
        msg: dict = {"op": "step", "now": now}
        if self._gate_dirty:
            # the gate rides the step message like batched submits do: one
            # RPC per round, applied worker-side before this round admits
            msg["batch_gate"] = self._batch_gated
            self._gate_dirty = False
        if self._outbox:
            msg["submits"], self._outbox = self._outbox, []
        # the worker's first step runs its first prefill (on the card it
        # may load the kernel library) — the first round gets the init
        # deadline, every later round the (much tighter) RPC one
        self._conn.sock.settimeout(self._rpc_timeout_s if self._stepped_once
                                   else self._init_timeout_s)
        try:
            self._step_seq = self._send(msg)
            self._step_pending = True
        except TransportError:
            self._mark_failed()

    def finish_step(self) -> list[Request]:
        out, self._late = self._late, []
        if not self._step_pending:
            return out
        self._step_pending = False
        try:
            reply = self._recv_reply(self._step_seq)
        except TransportError:
            self._mark_failed()
            return out
        if reply.get("etype") == "PodDesyncError":
            # the pod's ranks split mid-step: it is dead as a unit — flip
            # failed so the router's normal reap path (evict + requeue via
            # lost_requests) handles it like any other lost replica
            self._mark_failed()
            return out
        if "error" in reply:           # engine bug, not a transport failure
            raise RuntimeError(
                f"worker {self.replica_id}: {reply['error']}\n"
                f"{reply.get('trace', '')}")
        self._stepped_once = True
        self._queue_depth = int(reply["queue_depth"])
        self._active = int(reply["active"])
        fresh = []
        for d in reply["completed"]:
            orig = self._requests.pop(int(d["rid"]), None)
            if orig is not None:
                fresh.append(apply_request(orig, d))
            # an untracked rid cannot reach a submitter anyway (nothing was
            # recorded parent-side) — completions are slim records, so there
            # is no request to reconstruct; drop it
        self._mirror_lifetime(fresh, reply)   # ONLY this reply's — drained
        errs = reply.get("submit_errors")     # _late ones were mirrored then
        if errs:
            # defense in depth: the stub validated these locally, so a
            # worker-side rejection means the two sides disagree — drop the
            # rejected requests from tracking (they are not on the worker)
            # and surface the bug; completions already in hand are parked
            # for redelivery, not lost
            for e in errs:
                orig = self._requests.pop(int(e["rid"]), None)
                if orig is not None:
                    orig.reset_generation()
            self._late = out + fresh
            raise RuntimeError(
                f"worker {self.replica_id} rejected {len(errs)} batched "
                f"submit(s): {errs}")
        return out + fresh

    def _mirror_lifetime(self, completed: list[Request], reply: dict):
        """Keep a parent-side running copy of the worker's lifetime stats —
        every completion flows through this stub, so the mirror equals the
        worker's own accumulators.  A crash must not erase served work from
        fleet metrics; the authoritative 'lifetime' RPC simply replaces the
        mirror when the worker is reachable."""
        lc = self._lifetime_cache
        lc["total_ticks"] = lc.get("total_ticks", 0) + 1
        for r in completed:
            lc["total_completed"] += 1
            key = f"completed_{getattr(r, 'tier', 'interactive')}"
            lc[key] = lc.get(key, 0) + 1
            lc["total_tokens"] += len(r.tokens_out)
            if r.latency_s is not None:
                lc["latencies_ms"].append(r.latency_s * 1e3)
        if "slot_utilization" in reply:
            lc["slot_utilization"] = float(reply["slot_utilization"])
        lc["queue_depth"] = self._queue_depth

    def report(self, tick: int) -> ReplicaReport:
        if not self.failed:
            try:
                w = self._rpc({"op": "report"})["window"]
                return _report_from_window(self.replica_id, tick, w,
                                           transport_ms=self.transport_ms)
            except TransportError:
                pass
        # the crash report: no samples, one error — the collector marks the
        # replica a straggler off this instead of replaying its last window
        return _report_from_window(
            self.replica_id, tick, dict(_EMPTY_WINDOW,
                                        queue_depth=len(self._requests)),
            n_errors=1, transport_ms=self.transport_ms)

    def lifetime(self) -> dict:
        if not self.failed:
            try:
                self._lifetime_cache = self._rpc({"op": "lifetime"})["lifetime"]
            except TransportError:
                pass
        out = dict(self._lifetime_cache)
        # snapshot the nested list too: _mirror_lifetime appends to the
        # cache in place, and a shallow copy would retroactively mutate
        # every lifetime() result already handed to a caller
        out["latencies_ms"] = list(out.get("latencies_ms", ()))
        return out

    def evacuate(self) -> list[Request]:
        self._draining = True
        # buffered submits never reached the worker — recover them locally
        # (the evacuate RPC can only return what the worker has)
        local: list[Request] = []
        outbox, self._outbox = self._outbox, []
        for d in outbox:
            orig = self._requests.pop(int(d["request"]["rid"]), None)
            if orig is not None:
                orig.reset_generation()
                local.append(orig)
        if self.failed:
            return local + self.lost_requests()
        try:
            reply = self._rpc({"op": "evacuate"})
        except TransportError:
            return local + self.lost_requests()
        for rid in reply["rids"]:
            orig = self._requests.pop(int(rid), None)
            if orig is None:
                continue
            orig.reset_generation()
            local.append(orig)
        return local

    def resume(self):
        self._draining = False
        if not self.failed:
            try:
                self._rpc({"op": "resume"})
            except TransportError:
                pass

    def gate_batch(self, on: bool):
        on = bool(on)
        if on != self._batch_gated:
            self._batch_gated = on
            self._gate_dirty = True

    def lost_requests(self) -> list[Request]:
        self._outbox.clear()           # their originals are in _requests too
        out = []
        for req in self._requests.values():
            req.reset_generation()
            out.append(req)
        self._requests.clear()
        return out

    def close(self):
        if self._closed:
            return
        self._closed = True
        if not self.failed and self._proc is not None:
            # the stub owns the worker's lifetime → ask it to exit.  An
            # ATTACHED worker (proc is None) is somebody else's pod: just
            # drop the connection — it returns to accept for the next
            # router (a detach must not shut the pod down).
            try:
                self._conn.sock.settimeout(5.0)
                self._send({"op": "shutdown"})
                self._conn.recv()
            except (TransportError, OSError):
                pass
        self._conn.close()
        if self._proc is not None and self._proc.poll() is None:
            self._proc.terminate()
            try:
                self._proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self._proc.kill()
                self._proc.wait(timeout=10)

    def __del__(self):
        try:
            proc = getattr(self, "_proc", None)
            if proc is not None and proc.poll() is None:
                proc.kill()
        except Exception:
            pass

    # ---------------------------------------------------------- properties

    @property
    def load(self) -> float:
        """In-system work over slot capacity.  len(_requests) is exactly the
        engine's (active + queued + about-to-be-queued) at every quiescent
        point — submissions and completions both pass through this stub —
        so routing behaves bit-identically to the in-process backend."""
        return len(self._requests) / max(self.slots, 1)

    @property
    def idle(self) -> bool:
        return not self._requests

    @property
    def queue_depth(self) -> int:
        return max(len(self._requests) - self._active, 0)

    @property
    def pending(self) -> int:
        return len(self._requests)

    @property
    def draining(self) -> bool:
        return self._draining

    @draining.setter
    def draining(self, value: bool):
        self._draining = bool(value)


class ProcessReplica(SocketReplica):
    """SocketReplica over a forked worker subprocess (single-host): the
    transport is an inherited socketpair, so there is no listen/dial step
    and the worker's lifetime is owned by the stub.  The worker builds its
    engine on ``device`` (its ``--device`` flag)."""

    kind = "proc"

    def __init__(self, cfg, *, slots: int, max_seq: int, seed: int = 0,
                 prefill_chunk: int | None = None, replica_id: int = 0,
                 rpc_timeout_s: float = 120.0,
                 init_timeout_s: float = 600.0,
                 batch_submits: bool = True, pool: str = "dense",
                 block_size: int | None = None,
                 num_blocks: int | None = None, spec_k: int = 0,
                 spec_ngram: int = 3, device: str = "cuda"):
        parent_sock, child_sock = socket.socketpair()
        child_sock.set_inheritable(True)
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.serving.worker",
             str(child_sock.fileno()), "--device", str(device)],
            pass_fds=(child_sock.fileno(),), env=worker_env(), close_fds=True)
        child_sock.close()
        super().__init__(cfg, Connection(parent_sock, timeout=rpc_timeout_s),
                         slots=slots, max_seq=max_seq, seed=seed,
                         prefill_chunk=prefill_chunk, replica_id=replica_id,
                         proc=proc, rpc_timeout_s=rpc_timeout_s,
                         init_timeout_s=init_timeout_s,
                         batch_submits=batch_submits, pool=pool,
                         block_size=block_size, num_blocks=num_blocks,
                         spec_k=spec_k, spec_ngram=spec_ngram)


class TcpReplica(SocketReplica):
    """SocketReplica over TCP: the worker is a listening pod the router
    ATTACHES to (``addr``), possibly on another host — or, when no address
    is given, a local worker spawned on a kernel-picked port (demos/CI;
    the stub then owns the worker process, spawned on ``device``).
    Connect and init handshake each get their own deadline; the socket
    carries keepalive so a vanished peer surfaces as an error, never a
    wedged fleet.  An attached worker's device is its own ``--device``."""

    kind = "tcp"

    def __init__(self, cfg, *, slots: int, max_seq: int,
                 addr: str | tuple[str, int] | None = None, seed: int = 0,
                 prefill_chunk: int | None = None, replica_id: int = 0,
                 rpc_timeout_s: float = 120.0,
                 init_timeout_s: float = 600.0,
                 connect_timeout_s: float = 10.0,
                 batch_submits: bool = True, pool: str = "dense",
                 block_size: int | None = None,
                 num_blocks: int | None = None, spec_k: int = 0,
                 spec_ngram: int = 3, device: str = "cuda"):
        proc = None
        if addr is None:
            addr, proc = spawn_worker(device=device)
        if isinstance(addr, str):
            addr = parse_addr(addr)
        self.addr = (addr[0], int(addr[1]))
        try:
            conn = dial(*self.addr, connect_timeout=connect_timeout_s,
                        timeout=rpc_timeout_s)
            super().__init__(cfg, conn, slots=slots, max_seq=max_seq,
                             seed=seed, prefill_chunk=prefill_chunk,
                             replica_id=replica_id, proc=proc,
                             rpc_timeout_s=rpc_timeout_s,
                             init_timeout_s=init_timeout_s,
                             batch_submits=batch_submits, pool=pool,
                             block_size=block_size, num_blocks=num_blocks,
                             spec_k=spec_k, spec_ngram=spec_ngram)
        except TransportError:
            # dial or handshake died before the stub owned the worker's
            # lifetime — do not leak a locally-spawned process
            if proc is not None and proc.poll() is None:
                proc.kill()
            raise


class DistributedPodReplica(TcpReplica):
    """A TcpReplica whose far side is a MULTI-PROCESS POD: ``pod_size``
    worker ranks (``worker.py --pod-rank R --pod-size N``) jointly backing
    one replica.  The router's view is unchanged — it dials rank 0 (the
    RPC head) and speaks the ordinary replica protocol; the head forwards
    every mutating op to the non-head ranks so the pod steps in lockstep,
    and cross-checks per-step digests (see worker.py "Pod execution").

    ``addr`` is the HEAD's address of a pod somebody else scheduled; with
    no address the stub launches a local pod on ``device``
    (fleet.launch_pod — demos, CI, the card) and owns every rank's
    lifetime: close() shuts the head down over the wire (which forwards
    the shutdown to the ranks) and then reaps all the rank processes."""

    kind = "pod"

    def __init__(self, cfg, *, slots: int, max_seq: int, pod_size: int = 2,
                 addr: str | tuple[str, int] | None = None, seed: int = 0,
                 prefill_chunk: int | None = None, replica_id: int = 0,
                 rpc_timeout_s: float = 120.0,
                 init_timeout_s: float = 600.0,
                 connect_timeout_s: float = 10.0,
                 batch_submits: bool = True, pool: str = "dense",
                 block_size: int | None = None,
                 num_blocks: int | None = None, spec_k: int = 0,
                 spec_ngram: int = 3, device: str = "cuda"):
        from repro_torch.serving.fleet import launch_pod

        self.pod_size = int(pod_size)
        self._pod_handle = None
        if addr is None:
            self._pod_handle = launch_pod(self.pod_size, once=True,
                                          device=device)
            addr = self._pod_handle.head_addr
        try:
            super().__init__(cfg, slots=slots, max_seq=max_seq, addr=addr,
                             seed=seed, prefill_chunk=prefill_chunk,
                             replica_id=replica_id,
                             rpc_timeout_s=rpc_timeout_s,
                             init_timeout_s=init_timeout_s,
                             connect_timeout_s=connect_timeout_s,
                             batch_submits=batch_submits, pool=pool,
                             block_size=block_size, num_blocks=num_blocks,
                             spec_k=spec_k, spec_ngram=spec_ngram)
        except Exception:
            if self._pod_handle is not None:
                self._pod_handle.close()
            raise
        if self._pod_handle is not None:
            # the stub owns the whole pod's lifetime: the head process
            # carries the liveness probe + shutdown RPC (which it forwards
            # to the other ranks), close()/failure reaps everything
            self._proc = self._pod_handle.head_proc

    def close(self):
        super().close()
        if self._pod_handle is not None:
            self._pod_handle.close()

    def __del__(self):
        try:
            handle = getattr(self, "_pod_handle", None)
            if handle is not None:
                for proc in handle.procs:
                    if proc.poll() is None:
                        proc.kill()
        except Exception:
            pass
        super().__del__()
