"""The port's wire layer against the JAX package's, on the CPU.

``repro_torch.serving.transport`` and ``repro.serving.transport`` get the
same objects and the same byte streams:

- frames packed from the same objects are equal byte for byte, and each
  package unpacks the other's frames to the same objects;
- ``read_exact``/``Connection`` over a socketpair: back-to-back frames,
  partial frames reassemble, EOF and mid-frame EOF raise a typed
  ``TransportError``, an oversized frame is refused at the sender (leaving
  the channel clean), an oversized declared length and garbage payloads
  are typed errors, never a hang;
- ``parse_addr``, the ``Listener``/``dial`` round trip with keepalive and
  nodelay, a refused dial and the accept deadline;
- the error types' names and bases equal the reference's.

The hypothesis cases of ``tests/test_transport_fuzz.py`` run on both
packages' codecs with the same draws.
"""
import dataclasses
import math
import socket
import struct
import threading

import numpy as np
import pytest

pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

import repro.serving.transport as ref_transport
from repro.configs import get_smoke_config as ref_smoke_config
from repro.core.monitoring.collector import ReplicaReport as RefReport
from repro.serving.sampling import SamplingParams as RefSampling
from repro.serving.scheduler import Request as RefRequest

import repro_torch.serving.transport as transport
from repro_torch.configs import get_smoke_config
from repro_torch.core.monitoring.collector import ReplicaReport
from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request
from repro_torch.serving.transport import (
    Connection, Listener, TransportError, WorkerBusyError, dial, pack_frame,
    parse_addr, read_exact, unpack_payload,
)

from conftest import TINY_CFGS

SETTINGS = dict(max_examples=30, deadline=None)
SIDES = {"port": transport, "ref": ref_transport}

finite_or_not = st.floats(allow_nan=True, allow_infinity=True, width=32)


def _eq(a: float, b: float) -> bool:
    return (a == b) or (math.isnan(a) and math.isnan(b))


def _conn_pair(side):
    a, b = socket.socketpair()
    return (SIDES[side].Connection(a, timeout=10.0),
            SIDES[side].Connection(b, timeout=10.0))


# ------------------------------------------------------------------- types


@pytest.mark.parametrize("name", ["TransportError", "WorkerBusyError"])
def test_error_types_match_the_reference(name):
    port, ref = getattr(transport, name), getattr(ref_transport, name)
    assert port.__name__ == ref.__name__
    assert [b.__name__ for b in port.__mro__] == \
        [b.__name__ for b in ref.__mro__]
    assert issubclass(WorkerBusyError, TransportError)
    assert issubclass(TransportError, ConnectionError)
    assert transport.MAX_FRAME == ref_transport.MAX_FRAME
    assert transport._LEN.format == ref_transport._LEN.format


# ------------------------------------------------------------------ frames


def test_frames_equal_the_reference_byte_for_byte():
    """Every message kind the fabric sends, built from the same fields on
    both sides: the frames are identical, and each side unpacks the
    other's."""
    cfg, rcfg = (get_smoke_config("qwen2.5-3b"),
                 ref_smoke_config("qwen2.5-3b"))
    rng = np.random.default_rng(0)
    prompt = rng.integers(3, 64, size=7).astype(np.int32)
    reqs = []
    for R, S in ((Request, SamplingParams), (RefRequest, RefSampling)):
        r = R(rid=5, prompt=prompt, gen_len=4,
              sampling=S(temperature=0.7, top_k=4, seed=9))
        r.t_submit, r.tokens_out = 1.5, [3, 4]
        reqs.append(r)
    rep = dict(replica_id=2, tick=3, latency_ms_samples=[1.0, float("nan")],
               n_requests=2, n_errors=0, flop_util=0.5, hbm_util=0.5,
               ici_util=0.0, mem_frac=0.5, queue_depth=1,
               transport_ms=float("inf"))
    pairs = [
        ({"op": "init", "cfg": transport.encode_config(cfg),
          "slots": 2, "max_seq": 24, "seed": 0, "seq": 1},
         {"op": "init", "cfg": ref_transport.encode_config(rcfg),
          "slots": 2, "max_seq": 24, "seed": 0, "seq": 1}),
        ({"op": "step", "now": 1.0, "seq": 7, "submits": [
            {"request": transport.encode_request(reqs[0]), "now": 0.5}]},
         {"op": "step", "now": 1.0, "seq": 7, "submits": [
             {"request": ref_transport.encode_request(reqs[1]),
              "now": 0.5}]}),
        ({"completed": [transport.encode_completion(reqs[0])], "seq": 7},
         {"completed": [ref_transport.encode_completion(reqs[1])],
          "seq": 7}),
        (transport.encode_report(ReplicaReport(**rep)),
         ref_transport.encode_report(RefReport(**rep))),
        ({"error": "worker already has a mutating session",
          "etype": "WorkerBusyError", "seq": 0},) * 2,
    ]
    for port_obj, ref_obj in pairs:
        frame = pack_frame(port_obj)
        assert frame == ref_transport.pack_frame(ref_obj)
        assert (json_eq(unpack_payload(frame[4:]),
                        ref_transport.unpack_payload(frame[4:])))


def json_eq(a, b) -> bool:
    """Equality that takes NaN == NaN (frames carry NaN metrics)."""
    if isinstance(a, float) and isinstance(b, float):
        return _eq(a, b)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(json_eq(a[k], b[k]) for k in a)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(map(json_eq, a, b))
    return a == b


# ------------------------------------------------------------------ framing


@pytest.mark.parametrize("side", ["port", "ref"])
def test_back_to_back_frames_cross_packages(side):
    """Frames one package sends, the other receives."""
    other = "ref" if side == "port" else "port"
    a_sock, b_sock = socket.socketpair()
    a = SIDES[side].Connection(a_sock, timeout=10.0)
    b = SIDES[other].Connection(b_sock, timeout=10.0)
    a.send({"x": 1})
    a.send({"y": [1.5, None, "z"]})
    assert b.recv() == {"x": 1}
    assert b.recv() == {"y": [1.5, None, "z"]}
    a.close(), b.close()


def test_partial_frame_reads_reassemble():
    a_sock, b_sock = socket.socketpair()
    b = Connection(b_sock, timeout=10.0)
    payload = {"op": "step", "data": list(range(64)), "v": float("nan")}
    raw = pack_frame(payload)
    cuts = [0, 1, 3, 4, 9, len(raw) // 2, len(raw) - 1, len(raw)]

    def dribble():
        for lo, hi in zip(cuts, cuts[1:]):
            a_sock.sendall(raw[lo:hi])

    t = threading.Thread(target=dribble)
    t.start()
    got = b.recv()
    t.join(timeout=10)
    assert not t.is_alive()
    assert got["op"] == "step" and got["data"] == list(range(64))
    assert math.isnan(got["v"])
    a_sock.close(), b.close()


def test_read_exact_loops_over_partial_reads_and_raises_on_eof():
    a_sock, b_sock = socket.socketpair()
    b_sock.settimeout(10.0)
    a_sock.sendall(b"abc")
    a_sock.sendall(b"defg")
    assert read_exact(b_sock, 5) == b"abcde"
    a_sock.close()
    with pytest.raises(TransportError, match="peer closed"):
        read_exact(b_sock, 4)          # two bytes left, then EOF
    b_sock.close()


@pytest.mark.parametrize("side", ["port", "ref"])
def test_eof_and_mid_frame_eof_raise_transport_error(side):
    a, b = _conn_pair(side)
    a.close()
    with pytest.raises(SIDES[side].TransportError):
        b.recv()
    b.close()
    a_sock, b_sock = socket.socketpair()
    b = SIDES[side].Connection(b_sock, timeout=10.0)
    raw = SIDES[side].pack_frame({"op": "step"})
    a_sock.sendall(raw[:len(raw) - 3])
    a_sock.close()
    with pytest.raises(SIDES[side].TransportError):
        b.recv()
    b.close()


def test_recv_deadline_raises_transport_error():
    a, b = socket.socketpair()
    conn = Connection(b, timeout=0.05)
    with pytest.raises(TransportError, match="timed out"):
        conn.recv()
    a.close(), conn.close()


@pytest.mark.parametrize("side", ["port", "ref"])
def test_oversized_frame_refused_at_sender_channel_clean(side, monkeypatch):
    monkeypatch.setattr(SIDES[side], "MAX_FRAME", 64)
    with pytest.raises(SIDES[side].TransportError, match="oversized"):
        SIDES[side].pack_frame({"blob": "x" * 256})
    a, b = _conn_pair(side)
    with pytest.raises(SIDES[side].TransportError):
        a.send({"blob": "y" * 256})
    a.send({"after": True})            # nothing partial hit the wire
    assert b.recv() == {"after": True}
    a.close(), b.close()


def test_garbage_payload_raises_typed_error_not_hang():
    a_sock, b_sock = socket.socketpair()
    b = Connection(b_sock, timeout=10.0)
    junk = b"\xff\xfe\x00not json at all"
    a_sock.sendall(struct.pack(">I", len(junk)) + junk)
    with pytest.raises(TransportError, match="malformed"):
        b.recv()
    a_sock.close(), b.close()


# ---------------------------------------------------------------- TCP layer


def test_parse_addr_equals_the_reference():
    for addr in ("10.0.0.7:7077", ":0", "localhost:1", "[::1]:9"):
        assert parse_addr(addr) == ref_transport.parse_addr(addr)
    for bad in ("no-port", "host:seven", "host:"):
        with pytest.raises(ValueError):
            parse_addr(bad)
        with pytest.raises(ValueError):
            ref_transport.parse_addr(bad)


def test_listener_dial_round_trip_with_keepalive_and_nodelay():
    lst = Listener("127.0.0.1", 0)
    assert lst.port != 0 and lst.addr == (lst.host, lst.port)
    client = dial(lst.host, lst.port, timeout=10.0)
    server = lst.accept(timeout=10.0, conn_timeout=10.0)
    client.send({"hello": "🌍", "v": float("inf")})
    got = server.recv()
    assert got["hello"] == "🌍" and got["v"] == float("inf")
    server.send({"ack": 1})
    assert client.recv() == {"ack": 1}
    for sock in (client.sock, server.sock):
        assert sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY)
        assert sock.getsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE)
    client.close(), server.close(), lst.close()


def test_dial_refused_raises_transport_error():
    lst = Listener("127.0.0.1", 0)
    port = lst.port
    lst.close()
    with pytest.raises(TransportError, match="failed"):
        dial("127.0.0.1", port, connect_timeout=5.0)


def test_accept_deadline_and_closed_listener_raise_transport_error():
    lst = Listener("127.0.0.1", 0)
    with pytest.raises(TransportError, match="timed out"):
        lst.accept(timeout=0.05)
    lst.close()
    with pytest.raises(TransportError):
        lst.accept(timeout=0.05)


# ------------------------------------------------- fuzz, both packages


@settings(**SETTINGS)
@given(lat=st.lists(finite_or_not, max_size=8),
       flop=finite_or_not, transport_ms=finite_or_not,
       n_req=st.integers(0, 1 << 20), n_err=st.integers(0, 64),
       qd=st.integers(0, 1 << 16))
def test_report_codec_round_trips_as_the_reference(lat, flop, transport_ms,
                                                   n_req, n_err, qd):
    kw = dict(replica_id=1, tick=2, latency_ms_samples=lat,
              n_requests=n_req, n_errors=n_err, flop_util=flop,
              hbm_util=0.0, ici_util=0.0, mem_frac=0.0, queue_depth=qd,
              transport_ms=transport_ms)
    frame = pack_frame(transport.encode_report(ReplicaReport(**kw)))
    assert frame == ref_transport.pack_frame(
        ref_transport.encode_report(RefReport(**kw)))
    got = transport.decode_report(unpack_payload(frame[4:]))
    want = ref_transport.decode_report(ref_transport.unpack_payload(
        frame[4:]))
    assert json_eq(dataclasses.asdict(got), dataclasses.asdict(want))
    assert got.n_requests == n_req and _eq(got.transport_ms, transport_ms)


@settings(**SETTINGS)
@given(data=st.data(),
       prompt_len=st.integers(1, 12), gen_len=st.integers(1, 32),
       temperature=st.floats(0.0, 4.0), top_k=st.integers(0, 64),
       seed=st.integers(0, 2**31 - 1), with_frames=st.booleans())
def test_request_codec_round_trips_as_the_reference(
        data, prompt_len, gen_len, temperature, top_k, seed, with_frames):
    prompt = np.asarray(data.draw(st.lists(
        st.integers(0, 2**31 - 1), min_size=prompt_len,
        max_size=prompt_len)), np.int32)
    frames = None
    if with_frames:
        frames = np.asarray(data.draw(st.lists(
            st.lists(st.floats(-1e6, 1e6, width=32), min_size=3, max_size=3),
            min_size=1, max_size=4)), np.float32)
    rid = data.draw(st.integers(0, 2**31 - 1))
    tokens = data.draw(st.lists(st.integers(0, 2**31 - 1), max_size=6))
    built = []
    for R, S in ((Request, SamplingParams), (RefRequest, RefSampling)):
        r = R(rid=rid, prompt=prompt, gen_len=gen_len,
              sampling=S(temperature=temperature, top_k=top_k, seed=seed),
              frames=frames)
        r.tokens_out = list(tokens)
        built.append(r)
    frame = pack_frame(transport.encode_request(built[0]))
    assert frame == ref_transport.pack_frame(
        ref_transport.encode_request(built[1]))
    got = transport.decode_request(unpack_payload(frame[4:]))
    np.testing.assert_array_equal(got.prompt, prompt)
    assert got.rid == rid and got.gen_len == gen_len
    assert dataclasses.asdict(got.sampling) == \
        dataclasses.asdict(built[1].sampling)
    assert got.tokens_out == tokens
    if with_frames:
        np.testing.assert_allclose(got.frames, frames, rtol=1e-6)
    else:
        assert got.frames is None


@settings(**SETTINGS)
@given(family=st.sampled_from(sorted(TINY_CFGS)),
       vocab=st.integers(8, 1 << 17), n_layers=st.integers(1, 12))
def test_config_codec_round_trips_as_the_reference(family, vocab, n_layers):
    rcfg = dataclasses.replace(TINY_CFGS[family], vocab=vocab,
                               n_layers=n_layers)
    enc = ref_transport.encode_config(rcfg)
    cfg = transport.decode_config(enc)
    assert transport.encode_config(cfg) == enc
    assert pack_frame(transport.encode_config(cfg)) == \
        ref_transport.pack_frame(enc)


@settings(**SETTINGS)
@given(obj=st.recursive(
    st.none() | st.booleans() | st.integers(-2**53, 2**53) | st.text()
    | st.floats(allow_nan=False, allow_infinity=True),
    lambda kids: st.lists(kids, max_size=4)
    | st.dictionaries(st.text(max_size=8), kids, max_size=4),
    max_leaves=16))
def test_pack_unpack_arbitrary_json_as_the_reference(obj):
    raw = pack_frame(obj)
    assert raw == ref_transport.pack_frame(obj)
    (n,) = struct.unpack(">I", raw[:4])
    assert n == len(raw) - 4
    assert unpack_payload(raw[4:]) == obj


@settings(**SETTINGS)
@given(data=st.data(), payload=st.dictionaries(
    st.text(max_size=6), st.text(max_size=12) | finite_or_not, max_size=6))
def test_random_split_points_reassemble_on_both(data, payload):
    raw = pack_frame(payload)
    n_cuts = data.draw(st.integers(0, min(len(raw) - 1, 6)))
    cuts = sorted(data.draw(st.sets(st.integers(1, len(raw) - 1),
                                    min_size=n_cuts, max_size=n_cuts)))
    bounds = [0] + cuts + [len(raw)]
    for side in ("port", "ref"):
        a_sock, b_sock = socket.socketpair()
        b = SIDES[side].Connection(b_sock, timeout=10.0)
        t = threading.Thread(target=lambda: [
            a_sock.sendall(raw[lo:hi]) for lo, hi in zip(bounds, bounds[1:])])
        t.start()
        got = b.recv()
        t.join(timeout=10)
        assert json_eq(got, payload)
        a_sock.close(), b.close()


@settings(**SETTINGS)
@given(n_bytes=st.integers(0, 3))
def test_truncated_length_prefix_is_typed_error_on_both(n_bytes):
    for side in ("port", "ref"):
        a_sock, b_sock = socket.socketpair()
        b = SIDES[side].Connection(b_sock, timeout=10.0)
        a_sock.sendall(b"\x00" * n_bytes)
        a_sock.close()
        with pytest.raises(SIDES[side].TransportError):
            b.recv()
        b.close()


@settings(**SETTINGS)
@given(junk=st.binary(min_size=1, max_size=64))
def test_garbage_bytes_give_the_reference_outcome(junk):
    """A framed payload of arbitrary bytes: both packages either decode the
    same object or both raise their TransportError, never hang."""
    outcome = {}
    for side in ("port", "ref"):
        a_sock, b_sock = socket.socketpair()
        b = SIDES[side].Connection(b_sock, timeout=10.0)
        a_sock.sendall(struct.pack(">I", len(junk)) + junk)
        a_sock.close()
        try:
            outcome[side] = ("ok", b.recv())
        except SIDES[side].TransportError:
            outcome[side] = ("error", None)
        b.close()
    assert outcome["port"][0] == outcome["ref"][0]
    assert json_eq(outcome["port"][1], outcome["ref"][1])


@settings(**SETTINGS)
@given(declared=st.integers(transport.MAX_FRAME + 1, 2**32 - 1))
def test_oversized_declared_length_rejected_before_allocation(declared):
    for side in ("port", "ref"):
        a_sock, b_sock = socket.socketpair()
        b = SIDES[side].Connection(b_sock, timeout=10.0)
        a_sock.sendall(struct.pack(">I", declared) + b"x" * 16)
        with pytest.raises(SIDES[side].TransportError, match="oversized"):
            b.recv()
        a_sock.close(), b.close()
