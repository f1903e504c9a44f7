"""The multi-process pod plumbing that runs without spawning a pod, on the
port (``tests/test_pod_mesh.py``'s ten tests): mesh construction, the pod
decode rules' collective-free guarantee, the lockstep step digest (byte
equal to the reference's on the same replies) and the worker CLI's
pod-flag validation (the reference's messages and exit codes).

The port's meshes hold ``torch.device`` entries; here they are laid over
the CPU, where the reference's lie over its one CPU device.
"""
import json

import jax
import numpy as np
import pytest
import torch

from repro.serving import worker as ref_worker
from repro.sharding import rules as ref_rules

from repro_torch.launch.mesh import (
    local_pod_mesh, make_mesh, make_pod_mesh, process_count,
    spmd_across_processes,
)
from repro_torch.serving import worker
from repro_torch.serving.worker import PodRuntime, step_digest
from repro_torch.sharding import SERVE_RULES, pod_decode_rules, spec_for

CPU = torch.device("cpu")


# ------------------------------------------------------------------- meshes


def test_make_pod_mesh_axes_and_layout():
    devices = [CPU, CPU, CPU]
    mesh = make_pod_mesh(devices=devices)
    assert mesh.axis_names == ("data", "model")
    assert mesh.devices.shape == (1, 3) and mesh.size == 3
    assert mesh.shape == {"data": 1, "model": 3}
    # the model axis is the raw device order (process-major in a pod)
    assert list(mesh.devices[0]) == devices
    assert make_pod_mesh(data=3, devices=devices).devices.shape == (3, 1)


def test_make_pod_mesh_rejects_indivisible_data():
    with pytest.raises(ValueError):
        make_pod_mesh(data=3, devices=[CPU, CPU])


def test_local_pod_mesh_covers_local_devices():
    mesh = local_pod_mesh(device="cpu")
    assert mesh.axis_names == ("model",)
    assert mesh.size == 1 and mesh.flat_devices() == [CPU]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            local_pod_mesh()            # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_mesh((2,), ("data",))


def test_spmd_probe_trivially_true_single_process():
    assert process_count() == 1 == jax.process_count()
    assert spmd_across_processes("cpu") is True


# ------------------------------------------------------- pod decode rules


def test_pod_decode_rules_batch_absorbs_every_mesh_axis():
    mesh = make_pod_mesh(devices=[CPU, CPU])
    rules = pod_decode_rules(mesh)
    assert rules.get("batch") == ("data", "model")
    # batch leads a KV-cache leaf, so SERVE_RULES' model-axis mappings
    # (cache_seq here) are dropped by first-use-wins
    kv = spec_for(("layers", "batch", "cache_seq", "kv_heads", None),
                  rules, mesh)
    assert kv == (None, ("data", "model"))
    logits = spec_for(("batch", "seq", "vocab"), rules, mesh)
    assert logits == (("data", "model"),)
    assert SERVE_RULES.get("cache_seq") == ("model",)
    ref = ref_rules.pod_decode_rules(mesh)
    assert rules.rules == ref.rules
    assert tuple(ref_rules.spec_for(("layers", "batch", "cache_seq",
                                     "kv_heads", None), ref, mesh)) == kv


def test_pod_decode_rules_on_classic_data_mesh_match_legacy():
    mesh = make_mesh((2,), ("data",), devices=[CPU, CPU])
    rules = pod_decode_rules(mesh)
    assert spec_for(("layers", "batch", "cache_seq", "kv_heads", None),
                    rules, mesh) == (None, "data")
    assert spec_for(("batch", "seq"), rules, mesh) == ("data",)
    assert spec_for(("batch",), rules, mesh) == ("data",)


# ------------------------------------------------------------ step digest


def _reply(completed, queue_depth=0, active=0):
    return {"completed": completed, "queue_depth": queue_depth,
            "active": active}


def test_step_digest_order_independent_and_sensitive():
    a = _reply([{"rid": 1, "tokens_out": [5, 6]},
                {"rid": 2, "tokens_out": [7]}], 3, 1)
    b = _reply([{"rid": 2, "tokens_out": [7]},
                {"rid": 1, "tokens_out": [5, 6]}], 3, 1)
    c = _reply([{"rid": 1, "tokens_out": [5, 9]},
                {"rid": 2, "tokens_out": [7]}], 3, 1)
    d = _reply(a["completed"], 2, 1)
    assert step_digest(a) == step_digest(b)
    assert step_digest(a) != step_digest(c)
    assert step_digest(a) != step_digest(d)
    json.dumps(step_digest(a))
    for r in (a, b, c, d, _reply([])):
        assert step_digest(r) == ref_worker.step_digest(r)


def test_step_digest_ignores_host_local_timestamps():
    base = [{"rid": 1, "tokens_out": [5], "t_done": 1.0}]
    other = [{"rid": 1, "tokens_out": [5], "t_done": 9.9}]
    assert step_digest(_reply(base)) == step_digest(_reply(other))
    assert step_digest(_reply(base)) == ref_worker.step_digest(_reply(base))


# ------------------------------------------------------------- worker CLI

BAD_POD_ARGS = [
    ["--pod-rank", "0", "--pod-size", "2"],                   # needs --listen
    ["--listen", "127.0.0.1:0", "--pod-rank", "1"],           # no size
    ["--listen", "127.0.0.1:0", "--pod-rank", "2",
     "--pod-size", "2"],                                      # rank range
    ["--listen", "127.0.0.1:0", "--pod-rank", "0",
     "--pod-size", "3", "--pod-peers", "127.0.0.1:1"],        # 1 != 2
    ["--listen", "127.0.0.1:0", "--pod-rank", "1",
     "--pod-size", "2", "--pod-peers", "127.0.0.1:1"],        # head-only
]


def _refusal(main, argv, capsys) -> tuple[int, str]:
    with pytest.raises(SystemExit) as e:
        main(argv)
    err = capsys.readouterr().err.strip().splitlines()[-1]
    return e.value.code, err.split("error: ", 1)[1]


def test_worker_cli_validates_pod_flags(capsys):
    """Each command line the reference refuses, the port refuses with the
    same message and exit code (2), before touching a device."""
    for argv in BAD_POD_ARGS:
        want = _refusal(ref_worker.main, argv, capsys)
        got = _refusal(worker.main, argv + ["--device", "cpu"], capsys)
        assert got == want, argv
        assert want[0] == 2


def test_pod_runtime_roles():
    head = PodRuntime(0, 2, "127.0.0.1:9999", ("127.0.0.1:1",),
                      device="cpu")
    rank = PodRuntime(1, 2, "127.0.0.1:9999", device="cpu")
    assert head.is_head and not rank.is_head
    assert head.info() == {"rank": 0, "size": 2, "mode": None,
                           "spmd_capable": None}
    ref = ref_worker.PodRuntime(0, 2, "127.0.0.1:9999", ("127.0.0.1:1",))
    assert head.info() == ref.info()
    assert rank.info()["size"] == 2
