"""Wire format for the replica fabric: length-prefixed JSON frames.

The replica boundary is a *message protocol*, not an object reference —
every request, completion, and metric report that crosses it is encoded
here, so an engine driven over a socket is observationally identical to one
held in-process.  Design points:

* **Framing.**  Each message is a 4-byte big-endian length followed by a
  UTF-8 JSON payload.  ``Connection.recv`` loops on the socket until the
  whole frame arrives (kernel buffers split frames arbitrarily — a partial
  read is the common case under load, not an error), and raises
  ``TransportError`` on EOF so a dead peer surfaces as a catchable failure,
  never a hang.  ``MAX_FRAME`` is enforced on BOTH ends: the receiver
  rejects an oversized declared length before allocating for it, and the
  sender refuses to emit a frame the peer is guaranteed to drop the
  connection over.

* **Transport-agnostic frames, TCP endpoints.**  ``Connection`` works over
  any stream socket (ProcessReplica rides a socketpair).  For cross-host
  replicas, ``Listener``/``dial`` provide the TCP endpoints: a worker binds
  and accepts (``worker.py --listen host:port``), the router dials with a
  connect deadline.  Both ends get TCP keepalive (a silently-vanished peer
  eventually surfaces as an error instead of a permanently-stuck fleet)
  and TCP_NODELAY (frames are small RPCs; Nagle would add 40 ms stalls to
  every decode round).

* **JSON, not pickle.**  The worker executes nothing it receives; a replica
  peer is a *service*, not a code-injection channel.  Python's JSON codec
  round-trips NaN/±Infinity (``allow_nan``), which metric payloads do
  contain (an empty latency window aggregates to NaN upstream).

* **Typed codecs.**  ``encode_request``/``decode_request`` and
  ``encode_report``/``decode_report`` pin the exact field set that crosses
  the wire; ``encode_config``/``decode_config`` rebuild a frozen
  ModelConfig (with its nested MoE/SSM/Hybrid sub-configs) so a worker can
  construct the identical engine from the handshake message alone.

``repro.serving.transport`` whole, over the port's config, request and
report types: the same objects pack to the reference's frames byte for
byte.
"""
from __future__ import annotations

import dataclasses
import json
import socket
import struct

import numpy as np

from repro_torch.core.monitoring.collector import ReplicaReport
from repro_torch.models.config import HybridCfg, ModelConfig, MoECfg, SSMCfg
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request

_LEN = struct.Struct(">I")
MAX_FRAME = 1 << 30           # 1 GiB sanity bound on a single frame


class TransportError(ConnectionError):
    """The peer is gone (EOF / reset / timeout) or sent a malformed frame."""


class WorkerBusyError(TransportError):
    """The worker already has a mutating session.  A listening worker
    serves ONE mutator (a router's SocketReplica) plus any number of
    read-only observers concurrently; a second ``attach(mode="mutate")``
    is rejected with this type — the wire carries it as
    ``etype: "WorkerBusyError"`` and the dialing stub re-raises it, so a
    router racing another router for a pod fails typed, not desynced."""




# --------------------------------------------------------------------- frames


def pack_frame(obj) -> bytes:
    payload = json.dumps(obj, allow_nan=True,
                         separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_FRAME:
        # the receiver would kill the connection over this frame anyway —
        # reject it at the sender, where the caller can still handle it
        raise TransportError(
            f"refusing to send oversized frame ({len(payload)} bytes "
            f"> MAX_FRAME {MAX_FRAME})")
    return _LEN.pack(len(payload)) + payload


def unpack_payload(payload: bytes):
    try:
        return json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        # garbage on the wire is a peer we can no longer trust to frame
        # correctly — surface it as the same typed failure as EOF/reset
        raise TransportError(f"malformed frame payload: {e}") from e


def read_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes, looping over partial reads."""
    chunks = []
    got = 0
    while got < n:
        try:
            chunk = sock.recv(n - got)
        except (socket.timeout, TimeoutError) as e:
            raise TransportError(f"timed out waiting for peer: {e}") from e
        except OSError as e:
            raise TransportError(f"socket error: {e}") from e
        if not chunk:
            raise TransportError("peer closed the connection")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


class Connection:
    """One framed duplex channel over a connected socket."""

    def __init__(self, sock: socket.socket, *, timeout: float | None = None):
        self.sock = sock
        if timeout is not None:
            sock.settimeout(timeout)

    def send(self, obj):
        try:
            self.sock.sendall(pack_frame(obj))
        except OSError as e:
            raise TransportError(f"send failed: {e}") from e

    def recv(self):
        (n,) = _LEN.unpack(read_exact(self.sock, _LEN.size))
        if n > MAX_FRAME:
            raise TransportError(f"oversized frame ({n} bytes)")
        return unpack_payload(read_exact(self.sock, n))

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


# ------------------------------------------------------------ TCP endpoints

DEFAULT_CONNECT_TIMEOUT_S = 10.0


def parse_addr(addr: str) -> tuple[str, int]:
    """"host:port" → (host, port).  Port 0 means "kernel picks"."""
    host, sep, port = addr.rpartition(":")
    if not sep or not port.isdigit():
        raise ValueError(f"expected host:port, got {addr!r}")
    return host or "127.0.0.1", int(port)


def _tune_tcp(sock: socket.socket):
    """Frames are small RPCs on a strict request/reply stream: Nagle's 40 ms
    coalescing stall would dominate a decode round, and a silently-vanished
    peer must eventually error out instead of wedging the fleet."""
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)


class Listener:
    """One bound TCP accept socket; ``accept()`` yields framed Connections.

    Binding to port 0 lets the kernel pick — ``self.port`` reports the
    realized port (workers print it so a parent/script can attach)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 backlog: int = 16):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(backlog)
        self.host, self.port = self.sock.getsockname()[:2]

    @property
    def addr(self) -> tuple[str, int]:
        return (self.host, self.port)

    def accept(self, timeout: float | None = None, *,
               conn_timeout: float | None = None) -> Connection:
        """Wait for one peer; raises TransportError on deadline/closure."""
        try:
            self.sock.settimeout(timeout)   # EBADF once close() ran — typed
            peer, _ = self.sock.accept()
        except (socket.timeout, TimeoutError) as e:
            raise TransportError(f"accept timed out: {e}") from e
        except OSError as e:
            raise TransportError(f"accept failed: {e}") from e
        _tune_tcp(peer)
        return Connection(peer, timeout=conn_timeout)

    def close(self):
        try:
            self.sock.close()
        except OSError:
            pass


def dial(host: str, port: int, *,
         connect_timeout: float = DEFAULT_CONNECT_TIMEOUT_S,
         timeout: float | None = None) -> Connection:
    """Connect to a listening worker; refused / unreachable / slow connects
    all surface as TransportError within the connect deadline."""
    try:
        sock = socket.create_connection((host, port), timeout=connect_timeout)
    except (socket.timeout, TimeoutError) as e:
        raise TransportError(
            f"connect to {host}:{port} timed out after "
            f"{connect_timeout}s") from e
    except OSError as e:
        raise TransportError(f"connect to {host}:{port} failed: {e}") from e
    _tune_tcp(sock)
    return Connection(sock, timeout=timeout)


# --------------------------------------------------------------------- codecs


def encode_request(req: Request) -> dict:
    return {
        "rid": req.rid,
        "prompt": np.asarray(req.prompt).astype(int).tolist(),
        "gen_len": int(req.gen_len),
        "tier": req.tier,
        "sampling": dataclasses.asdict(req.sampling),
        "t_submit": req.t_submit,
        "t_admit": req.t_admit,
        "t_first_token": req.t_first_token,
        "t_done": req.t_done,
        "replica_id": req.replica_id,
        "tokens_out": [int(t) for t in req.tokens_out],
        "frames": (None if req.frames is None
                   else np.asarray(req.frames, np.float32).tolist()),
    }


def decode_request(d: dict) -> Request:
    req = Request(rid=int(d["rid"]),
                  prompt=np.asarray(d["prompt"], np.int32),
                  gen_len=int(d["gen_len"]),
                  # .get: frames from pre-tier peers default interactive
                  tier=d.get("tier", "interactive"),
                  sampling=SamplingParams(**d["sampling"]),
                  frames=(None if d.get("frames") is None
                          else np.asarray(d["frames"], np.float32)))
    req.t_submit = d.get("t_submit")
    req.t_admit = d.get("t_admit")
    req.t_first_token = d.get("t_first_token")
    req.t_done = d.get("t_done")
    req.replica_id = d.get("replica_id")
    req.tokens_out = [int(t) for t in d.get("tokens_out", [])]
    return req


def encode_completion(req: Request) -> dict:
    """Slim completion record: everything the submitter's original object
    needs updated, and nothing it already has — echoing the prompt (and an
    enc-dec request's whole frames matrix) back over the wire per completion
    would be pure transport waste."""
    return {
        "rid": req.rid,
        "t_submit": req.t_submit,
        "t_admit": req.t_admit,
        "t_first_token": req.t_first_token,
        "t_done": req.t_done,
        "replica_id": req.replica_id,
        "tokens_out": [int(t) for t in req.tokens_out],
    }


def apply_request(dst: Request, d: dict) -> Request:
    """Merge a wire-side completion back into the submitter's original
    object — the caller's handle must reflect completion exactly as it does
    in-process (tokens, timestamps, owning replica)."""
    dst.t_submit = d.get("t_submit")
    dst.t_admit = d.get("t_admit")
    dst.t_first_token = d.get("t_first_token")
    dst.t_done = d.get("t_done")
    dst.replica_id = d.get("replica_id")
    dst.tokens_out = [int(t) for t in d.get("tokens_out", [])]
    return dst


def encode_report(rep: ReplicaReport) -> dict:
    return dataclasses.asdict(rep)


def decode_report(d: dict) -> ReplicaReport:
    fields = {f.name for f in dataclasses.fields(ReplicaReport)}
    return ReplicaReport(**{k: v for k, v in d.items() if k in fields})


_SUBCFGS = {"moe": MoECfg, "ssm": SSMCfg, "hybrid": HybridCfg}


def encode_config(cfg: ModelConfig) -> dict:
    return dataclasses.asdict(cfg)


def decode_config(d: dict) -> ModelConfig:
    d = dict(d)
    for name, klass in _SUBCFGS.items():
        if d.get(name) is not None:
            d[name] = klass(**d[name])
    if d.get("m_rope_sections") is not None:
        d["m_rope_sections"] = tuple(d["m_rope_sections"])
    return ModelConfig(**d)
