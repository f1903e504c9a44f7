"""Fault injection for the replica-fabric transport
(``repro.serving.chaos``).

The fabric's failure contract is binary: a fault either (a) is absorbed by
the framing (splits, delays — partial reads are the common case, not an
error) leaving the topology observationally identical, or (b) surfaces as a
typed ``TransportError`` → the router reaps the replica and requeues its
work.  NEVER a hang, never a stranded request, never a silently-wrong
reply.  This module is the adversary that pins that contract:

* ``FaultPlan``      — a declarative per-direction fault script: split
                       writes into N-byte pieces, delay each piece, sever
                       the connection mid-way through a chosen frame,
                       duplicate a chosen frame, or corrupt one byte.
* ``ChaosProxy``     — a byte-level TCP proxy between a dialing stub and a
                       real worker; each direction applies its own plan.
                       Frame-indexed faults (sever-in / duplicate) parse
                       the length-prefix stream so tests can say "cut the
                       SECOND reply in half" deterministically.
* ``FaultyConnection`` — a Connection whose ``send`` applies a plan
                       directly (no proxy) for endpoint-level unit tests.
* ``DelayedReplica``  — deterministic transport latency on the VIRTUAL
                       clock: a Replica-protocol shim that holds each
                       submitted request for ``rtt_ms`` of virtual time
                       before delivering it.  This is how a FleetPlan's
                       inter-region RTT matrix reaches the fabric — the
                       same shim on every topology (no wall-clock sleeps,
                       so inproc fleets stay fast and runs stay
                       reproducible), surfacing through ``transport_ms``
                       like a real remote link.

Lives in src (not tests/) because the benchmark and any future soak script
inject faults through the same shim the test suite does.
"""
from __future__ import annotations

import dataclasses
import socket
import threading
import time

from repro_torch.serving.transport import (
    _LEN,
    Connection,
    Listener,
    TransportError,
    pack_frame,
)


@dataclasses.dataclass
class FaultPlan:
    """One direction's fault script.  Defaults are a clean passthrough."""

    chunk_bytes: int | None = None      # split writes into ≤ this many bytes
    delay_s: float = 0.0                # sleep before each forwarded piece
    sever_in_frame: int | None = None   # 1-based: send HALF this frame, cut
    duplicate_frame: int | None = None  # 1-based: forward this frame twice
    corrupt_in_frame: int | None = None  # 1-based: flip a payload byte

    @property
    def framed(self) -> bool:
        """Frame-indexed faults need the length-prefix parse."""
        return (self.sever_in_frame is not None
                or self.duplicate_frame is not None
                or self.corrupt_in_frame is not None)


class _Severed(Exception):
    """Internal: the plan cut the connection."""


def _chunked_write(sendall, data: bytes, plan: FaultPlan):
    step = plan.chunk_bytes or len(data) or 1
    for lo in range(0, len(data), step):
        if plan.delay_s:
            time.sleep(plan.delay_s)
        sendall(data[lo:lo + step])


def _emit_frame_with_faults(sendall, frame: bytes, frame_no: int,
                            plan: FaultPlan) -> bool:
    """Send one length-prefixed frame through the fault script; → True when
    the plan severed the stream (half the frame went out, the caller must
    close the channel).  The ONE implementation of sever/corrupt/duplicate
    semantics — the proxy pump and the endpoint shim must inject
    byte-identical faults or their tests silently diverge."""
    if plan.sever_in_frame == frame_no:
        _chunked_write(sendall, frame[:max(len(frame) // 2, 1)], plan)
        return True                        # peer sees EOF mid-frame
    if plan.corrupt_in_frame == frame_no and len(frame) > _LEN.size:
        body = bytearray(frame)
        body[_LEN.size] ^= 0xFF            # first payload byte → garbage
        frame = bytes(body)
    _chunked_write(sendall, frame, plan)
    if plan.duplicate_frame == frame_no:
        _chunked_write(sendall, frame, plan)   # the replayed frame
    return False


class _Pump:
    """One direction of the proxy: src socket → plan → dst socket."""

    def __init__(self, src: socket.socket, dst: socket.socket,
                 plan: FaultPlan, on_sever):
        self.src, self.dst, self.plan = src, dst, plan
        self.on_sever = on_sever
        self._buf = b""
        self._frame_no = 0
        self.thread = threading.Thread(target=self._run, daemon=True)

    def start(self):
        self.thread.start()

    def _emit_frame(self, frame: bytes):
        self._frame_no += 1
        if _emit_frame_with_faults(self.dst.sendall, frame, self._frame_no,
                                   self.plan):
            raise _Severed()

    def _run(self):
        try:
            while True:
                data = self.src.recv(65536)
                if not data:
                    raise _Severed()
                if not self.plan.framed:
                    _chunked_write(self.dst.sendall, data, self.plan)
                    continue
                self._buf += data
                while len(self._buf) >= _LEN.size:
                    (n,) = _LEN.unpack(self._buf[:_LEN.size])
                    if len(self._buf) < _LEN.size + n:
                        break
                    frame = self._buf[:_LEN.size + n]
                    self._buf = self._buf[_LEN.size + n:]
                    self._emit_frame(frame)
        except (_Severed, OSError):
            # a sever (scripted or natural EOF) kills BOTH directions: a
            # half-dead proxy would turn a clean fault into a hang
            self.on_sever()


class ChaosProxy:
    """A fault-injecting TCP proxy in front of one upstream worker.

    Dial ``proxy.addr`` instead of the worker's own address; bytes flow
    client ↔ proxy ↔ upstream with each direction's FaultPlan applied.
    One client connection at a time (the stub protocol is one connection
    per replica)."""

    def __init__(self, upstream: tuple[str, int], *,
                 c2s: FaultPlan | None = None,
                 s2c: FaultPlan | None = None,
                 host: str = "127.0.0.1"):
        self.upstream = upstream
        self.c2s = c2s or FaultPlan()
        self.s2c = s2c or FaultPlan()
        self._listener = Listener(host, 0)
        self.addr = self._listener.addr
        self._lock = threading.Lock()
        self._socks: list[socket.socket] = []
        self._closed = False
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self):
        while not self._closed:
            try:
                client = self._listener.accept(timeout=0.25).sock
            except TransportError:
                continue
            try:
                server = socket.create_connection(self.upstream, timeout=10)
            except OSError:
                client.close()
                continue
            with self._lock:
                self._socks = [client, server]

            def sever():
                self._kill_pair(client, server)

            _Pump(client, server, self.c2s, sever).start()
            _Pump(server, client, self.s2c, sever).start()

    def _kill_pair(self, *socks):
        for s in socks:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass

    def close(self):
        self._closed = True
        self._listener.close()
        with self._lock:
            self._kill_pair(*self._socks)
        self._accept_thread.join(timeout=5)

    def __enter__(self) -> "ChaosProxy":
        return self

    def __exit__(self, *exc):
        self.close()


class DelayedReplica:
    """A Replica wrapper that injects a fixed transport RTT on the virtual
    clock: ``submit`` parks the request in an ingress queue stamped
    ``now + rtt_ms``, and each ``begin_step(now)`` delivers every request
    whose stamp has passed before stepping the inner replica.  The full
    round trip is charged on the ingress leg (arrival + return collapsed
    into one delay), so a completion's ``t_done - t_submit`` latency —
    measured engine-side, where the per-tier SLO channels sample — includes
    the RTT without any change to the engine or the wire.

    The delay also rides the metrics surface: ``transport_ms`` (the
    property and every report) reads inner + rtt, exactly as if the link
    were physically that far away — the scaler's transport budgeting sees
    injected geography and real socket latency through one channel.

    Everything else delegates: the wrapper is load/evacuation/failure
    transparent (ingress requests count toward load and queue depth, leave
    with ``evacuate()``/``lost_requests()`` exactly once, and are never
    delivered to a failed inner replica)."""

    def __init__(self, inner, *, rtt_ms: float):
        self.inner = inner
        self.rtt_ms = float(rtt_ms)
        self._ingress: list[tuple[float, object]] = []  # (deliver_at, req)
        self._slots = (getattr(inner, "slots", None)
                       or getattr(getattr(inner, "engine", None),
                                  "slots", None) or 1)

    # ------------------------------------------------------------- protocol

    def submit(self, request, now: float = 0.0):
        if self.inner.failed:
            # mirror the remote stub: touching a corpse raises so the
            # router's failover reroutes instead of stranding the request
            raise TransportError(
                f"replica {self.inner.replica_id} is lost")
        self._ingress.append((float(now) + self.rtt_ms / 1e3, request))

    def _deliver_due(self, now: float):
        due = [(d, r) for d, r in self._ingress if d <= now]
        if not due:
            return
        self._ingress = [(d, r) for d, r in self._ingress if d > now]
        for i, (d, r) in enumerate(due):
            try:
                self.inner.submit(r, now=now)
            except TransportError:
                # inner died mid-delivery: everything undelivered goes back
                # to ingress so lost_requests() can rewind it exactly once
                self._ingress.extend(due[i:])
                return

    def begin_step(self, now: float | None = None):
        t = float(now or 0.0)
        if not self.inner.failed:
            self._deliver_due(t)
        self.inner.begin_step(now)

    def finish_step(self):
        return self.inner.finish_step()

    def step(self, now: float | None = None):
        self.begin_step(now)
        return self.finish_step()

    def report(self, tick: int):
        rpt = self.inner.report(tick)
        rpt.transport_ms = float(rpt.transport_ms) + self.rtt_ms
        rpt.queue_depth = int(rpt.queue_depth) + len(self._ingress)
        return rpt

    def lifetime(self) -> dict:
        return self.inner.lifetime()

    def evacuate(self):
        mine = [r for _, r in self._ingress]
        self._ingress = []
        return mine + list(self.inner.evacuate())

    def resume(self):
        self.inner.resume()

    def gate_batch(self, on: bool):
        self.inner.gate_batch(on)

    def lost_requests(self):
        mine = [r for _, r in self._ingress]
        self._ingress = []
        return mine + list(self.inner.lost_requests())

    def close(self):
        self.inner.close()

    # ---------------------------------------------------------- properties

    @property
    def load(self) -> float:
        # in-flight-to-deliver work is still this replica's work: routing
        # must see it or it would pile submissions onto the longest queue
        return self.inner.load + len(self._ingress) / max(self._slots, 1)

    @property
    def idle(self) -> bool:
        return self.inner.idle and not self._ingress

    @property
    def queue_depth(self) -> int:
        return self.inner.queue_depth + len(self._ingress)

    @property
    def pending(self) -> int:
        return self.inner.pending + len(self._ingress)

    @property
    def draining(self) -> bool:
        return self.inner.draining

    @draining.setter
    def draining(self, value: bool):
        self.inner.draining = bool(value)

    @property
    def failed(self) -> bool:
        return self.inner.failed

    @failed.setter
    def failed(self, value: bool):
        # router.preempt flips this by fiat — it must reach the inner
        # replica or the reap path would see a healthy engine
        self.inner.failed = bool(value)

    @property
    def transport_ms(self) -> float:
        return self.inner.transport_ms + self.rtt_ms

    def __getattr__(self, name):
        # replica_id, rpc_count, slots, engine, … — everything the wrapper
        # doesn't shape passes straight through
        return getattr(self.inner, name)


class FaultyConnection(Connection):
    """A Connection whose ``send`` runs the fault script locally — for
    endpoint unit tests that don't want a proxy in the middle.  Frame
    indices count this connection's sends."""

    def __init__(self, sock: socket.socket, plan: FaultPlan, *,
                 timeout: float | None = None):
        super().__init__(sock, timeout=timeout)
        self.plan = plan
        self._frame_no = 0

    def send(self, obj):
        frame = pack_frame(obj)
        self._frame_no += 1
        try:
            severed = _emit_frame_with_faults(self.sock.sendall, frame,
                                              self._frame_no, self.plan)
        except OSError as e:
            raise TransportError(f"send failed: {e}") from e
        if severed:
            self.sock.close()
            raise TransportError("fault injection: severed mid-frame")
