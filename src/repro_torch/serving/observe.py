"""Read-only observation of a live worker or pod — without its router
(``repro.serving.observe``).

A listening worker serves ONE mutating session (the router's SocketReplica)
plus any number of concurrent read-only sessions.  MetricsObserver is the
client side of the read-only kind: it dials a worker, attaches with
``mode="observe"``, and may then poll

  ping()      liveness round trip
  lifetime()  the engine's lifetime accumulators — the SAME counters the
              router's ``lifetime`` RPC reads, so an external monitor and
              the control plane can never disagree about served work
  status()    a non-draining snapshot: initialized / queue_depth / active /
              draining / lifetime, plus pod rank+mode for pod ranks

None of these drain the mutator's metric window (``report`` stays
mutator-only — an observer draining it would corrupt the control loop's
ReplicaReport stream), and the worker bounces any mutating op from an
observer with a typed PermissionError reply, so a misbehaving monitor
cannot perturb the serving session it is watching.

The observer speaks the same strict seq-echoed request/reply stream as the
router stub: a duplicated or dropped frame surfaces as a TransportError
desync, never as silently shifted replies.
"""
from __future__ import annotations

from repro_torch.serving.transport import Connection, TransportError, dial, parse_addr


class MetricsObserver:
    """One read-only session on a listening worker (or a pod's head)."""

    def __init__(self, addr: str | tuple[str, int], *,
                 connect_timeout_s: float = 10.0,
                 rpc_timeout_s: float = 60.0):
        if isinstance(addr, str):
            addr = parse_addr(addr)
        self.addr = (addr[0], int(addr[1]))
        self._seq = 0
        self._conn: Connection | None = dial(
            *self.addr, connect_timeout=connect_timeout_s,
            timeout=rpc_timeout_s)
        self._rpc({"op": "attach", "mode": "observe"})

    def _rpc(self, msg: dict) -> dict:
        if self._conn is None:
            raise TransportError(f"observer on {self.addr} is closed")
        seq, self._seq = self._seq, self._seq + 1
        msg = dict(msg, seq=seq)
        try:
            self._conn.send(msg)
            reply = self._conn.recv()
        except TransportError:
            self.close()
            raise
        if reply.get("seq") != seq:
            self.close()
            raise TransportError(
                f"observer protocol desync: expected reply seq {seq}, "
                f"got {reply.get('seq')!r}")
        if "error" in reply:
            if reply.get("etype") == "PermissionError":
                raise PermissionError(reply["error"])
            raise RuntimeError(f"worker at {self.addr}: {reply['error']}")
        return reply

    # ------------------------------------------------------------- polls

    def ping(self) -> bool:
        return bool(self._rpc({"op": "ping"}).get("ok"))

    def lifetime(self) -> dict:
        return self._rpc({"op": "lifetime"})["lifetime"]

    def status(self) -> dict:
        reply = self._rpc({"op": "status"})
        reply.pop("seq", None)
        return reply

    def close(self):
        if self._conn is not None:
            self._conn.close()
            self._conn = None

    def __enter__(self) -> "MetricsObserver":
        return self

    def __exit__(self, *exc):
        self.close()
