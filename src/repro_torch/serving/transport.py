"""Wire format for the replica fabric: length-prefixed JSON frames.

The replica boundary is a *message protocol*, not an object reference —
every request, completion, and metric report that crosses it is encoded
here, so an engine driven over a socket is observationally identical to one
held in-process.  Design points:

* **Framing.**  Each message is a 4-byte big-endian length followed by a
  UTF-8 JSON payload.  ``pack_frame`` refuses to emit a frame over
  ``MAX_FRAME`` (the peer would drop the connection over it), and
  ``unpack_payload`` raises ``TransportError`` on a payload that is not
  JSON, so garbage on the wire is the same catchable failure as a dead
  peer.

* **JSON, not pickle.**  The worker executes nothing it receives; a replica
  peer is a *service*, not a code-injection channel.  Python's JSON codec
  round-trips NaN/±Infinity (``allow_nan``), which metric payloads do
  contain (an empty latency window aggregates to NaN upstream).

* **Typed codecs.**  ``encode_request``/``decode_request`` and
  ``encode_report``/``decode_report`` pin the exact field set that crosses
  the wire; ``encode_config``/``decode_config`` rebuild a frozen
  ModelConfig (with its nested MoE/SSM/Hybrid sub-configs) so a worker can
  construct the identical engine from the handshake message alone.

The framing and codecs of ``repro.serving.transport``, copied over the
port's config, request and report types.  The in-process router imports
``TransportError``; the socket replicas that use the rest are not ported
yet, and neither is the socket side of the reference's module: its
``Connection`` and ``read_exact``, its TCP endpoints (``Listener``,
``dial``, ``parse_addr``) and its attach error (``WorkerBusyError``).
"""
from __future__ import annotations

import dataclasses
import json
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
