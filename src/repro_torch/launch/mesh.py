"""Device meshes and multi-process pods (``repro.launch.mesh``).

FUNCTIONS, not module-level constants, so importing this module touches no
device and forms no process group.

Axes:
  pod   — data parallelism across pods.
  data  — within-pod data parallelism / FSDP.
  model — tensor / expert parallelism.

A ``Mesh`` is a numpy object array of ``torch.device`` with one name per
axis, read by ``sharding.spec_for`` through ``axis_names`` and
``devices.shape``, as the reference's ``jax.sharding.Mesh`` is.  A device
may appear in a mesh more than once: then several shards live on one card
(or on the CPU), each with its own slice of the state.  That is how a
one-card machine and the CPU tests lay out a mesh of 2 or 4 shards.

Multi-process (one serving pod spanning processes):

  ``init_distributed`` forms a ``torch.distributed`` gloo group
  idempotently — the coordinator address, process count and rank are
  plumbed from the worker's flags (``--coordinator``, ``--pod-size``,
  ``--pod-rank``), never discovered ambiently.  Gloo, not NCCL: the pod's
  ranks run in mirror mode and exchange no activations, and NCCL refuses
  two ranks on one card.

  ``spmd_across_processes`` probes ONCE, with one all-reduce of a
  one-element tensor on the rank's device, whether a collective spans the
  group, so every rank reaches the same verdict.  Whatever it says, pods
  serve in mirror mode (serving/worker.py).
"""
from __future__ import annotations

import datetime

import numpy as np
import torch


class Mesh:
    """``devices``: an object array of ``torch.device``, one dim per name in
    ``axis_names``."""

    def __init__(self, devices, axis_names):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def flat_devices(self) -> list[torch.device]:
        """The devices in row-major order: the order a dim sharded over
        every axis (in axis order) lays its shards in."""
        return list(self.devices.reshape(-1))


def _device_array(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return arr.reshape(tuple(shape))


def _cuda_devices(n: int) -> list[torch.device]:
    have = torch.cuda.device_count()
    if have < n:
        raise RuntimeError(f"a mesh of {n} devices needs {n} CUDA devices; "
                           f"{have} present (pass devices= to lay shards "
                           f"on fewer devices, or on the CPU)")
    return [torch.device("cuda", i) for i in range(n)]


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The reference's production mesh: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model") with ``multi_pod``; over
    ``cuda:0 ..`` (raising with fewer cards) or an explicit ``devices``
    list, which may repeat a device."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, devices)


def make_mesh(shape, axes, devices=None) -> Mesh:
    """Any (shape, axes) pair.  With no ``devices`` the mesh covers
    ``cuda:0 .. cuda:n-1`` and raises when there are fewer cards than the
    shape needs.  An explicit device list (length = the shape's product)
    may name one device more than once."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    n = int(np.prod(shape))
    devices = _cuda_devices(n) if devices is None else list(devices)
    if len(devices) != n:
        raise ValueError(f"{len(devices)} devices for a mesh of shape "
                         f"{shape}")
    return Mesh(_device_array(devices, shape), axes)


def mesh_chips(mesh) -> int:
    return int(mesh.devices.size)


def make_pod_mesh(*, data: int = 1, devices=None) -> Mesh:
    """The serving-pod mesh: ("data", "model") over ``devices`` (default:
    every CUDA device of this process), the raw device order along
    "model"."""
    if devices is None:
        devices = _cuda_devices(max(torch.cuda.device_count(), 1))
    devices = list(devices)
    n = len(devices)
    if data < 1 or n % data != 0:
        raise ValueError(f"{n} devices do not divide over data={data}")
    return Mesh(_device_array(devices, (data, n // data)), ("data", "model"))


def local_pod_mesh(*, axis: str = "model", device="cuda") -> Mesh:
    """This process's share of a pod as a one-axis mesh — the mirror
    layout: every rank runs the full replica in lockstep on its own
    device.  A port worker owns one device (its ``--device``), where the
    reference's rank spans all of its host's devices."""
    from repro_torch.device import resolve_device
    return Mesh(_device_array([resolve_device(device)], (1,)), (axis,))


# ---------------------------------------------------------------------------
# multi-process pods (torch.distributed over gloo)
# ---------------------------------------------------------------------------


def init_distributed(coordinator: str, num_processes: int, process_id: int,
                     *, timeout_s: int = 120) -> int:
    """Join (or form) the pod's process group; returns this process's rank.
    Rank 0 binds ``coordinator`` (host:port), the others dial it, each
    within ``timeout_s``.  Idempotent: a pod worker re-initialized by a
    second router attach keeps the group it has."""
    import torch.distributed as dist
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=int(num_processes), rank=int(process_id),
            timeout=datetime.timedelta(seconds=int(timeout_s)))
    return int(dist.get_rank())


def shutdown_distributed():
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    _SPMD_PROBE.clear()


def process_count() -> int:
    import torch.distributed as dist
    return int(dist.get_world_size()) if dist.is_initialized() else 1


def global_device_count(local: int) -> int:
    """The pod's device count: ``local`` (this process's mesh size) summed
    over the group by one all-reduce — a collective, so every rank must
    call it together."""
    import torch.distributed as dist
    if process_count() == 1:
        return int(local)
    t = torch.tensor([int(local)], dtype=torch.int64)
    dist.all_reduce(t)
    return int(t.item())


_SPMD_PROBE: dict = {}


def spmd_across_processes(device="cuda") -> bool:
    """Can one collective span every process of the group?

    True trivially for a single process.  Otherwise one all-reduce of a
    one-element tensor on ``device`` (the rank's own), cached: a backend
    that cannot run it raises on every rank, so every rank reaches the
    same verdict without a vote."""
    if process_count() == 1:
        return True
    if "ok" not in _SPMD_PROBE:
        import torch.distributed as dist
        try:
            t = torch.ones(1, device=device)
            dist.all_reduce(t)
            _SPMD_PROBE["ok"] = bool(t.item() == process_count())
        except (RuntimeError, ValueError):
            _SPMD_PROBE["ok"] = False
    return _SPMD_PROBE["ok"]
