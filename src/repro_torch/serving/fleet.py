"""Local worker fleets and pods: spawn listening workers for demos, CI and
the card (``repro.serving.fleet``).

In production a TcpReplica attaches to a worker pod somebody else scheduled
(k8s, a launcher) — the router never forks it.  For demos, CI, and the
cross-host tests, this module stands in for that scheduler: it spawns
``python -m repro_torch.serving.worker --listen host:0 --device ...``
subprocesses, reads the kernel-picked port off each worker's banner line,
and hands back dialable addresses.  A Fleet outlives any one router (a
router detaching leaves the pod listening, unless the worker was started
``--once``), so the same two-terminal flow in the README works in one
process.

``launch_pod`` stands in for a multi-host pod scheduler: it spawns
``pod_size`` ranks of one pod (``--pod-rank/--pod-size`` plus a shared
gloo ``--coordinator``) on localhost — non-head ranks first (they must be
listening before the head can claim their mutating sessions), then the
head with ``--pod-peers`` pointing at them.  Only the HEAD's address is
dialable by a router; the returned PodHandle owns every rank process.

Every worker owns its device: ``device`` (cuda unless the caller asks for
cpu) goes to its ``--device`` flag — every rank of a pod too.
"""
from __future__ import annotations

import dataclasses
import os
import select
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Sequence

from repro_torch.serving.transport import TransportError

BANNER = "WORKER_LISTENING"
# how long a pod's ranks get to exit after a shutdown before they are
# terminated (PodHandle.close)
POD_EXIT_GRACE_S = 5.0


def worker_env() -> dict:
    """The spawned worker must resolve ``repro_torch`` exactly like this
    process (the repo is run from a source tree, not an installed wheel)."""
    env = os.environ.copy()
    src_root = str(Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = (src_root + os.pathsep + env["PYTHONPATH"]
                         if env.get("PYTHONPATH") else src_root)
    return env


def spawn_worker(host: str = "127.0.0.1", port: int = 0, *,
                 once: bool = True, start_timeout_s: float = 60.0,
                 extra_args: Sequence[str] = (), device: str = "cuda",
                 ) -> tuple[tuple[str, int], subprocess.Popen]:
    """Spawn one listening TCP worker on ``device``; → ((host, port),
    process).

    The worker prints ``WORKER_LISTENING host:port`` after binding (port 0
    → kernel-picked); we scan its stdout for the banner under a deadline so
    a worker that dies at import surfaces as a TransportError with its exit
    code, never a hang.  ``once`` ties the worker's lifetime to its first
    mutating session (right for stub-owned workers); pass ``once=False``
    for a pod-like worker that keeps listening across router attach/detach.
    ``extra_args`` rides extra worker flags."""
    proc = _start(host, port, once=once, extra_args=extra_args,
                  device=device)
    return _listening(proc, time.monotonic() + start_timeout_s,
                      start_timeout_s), proc


def _start(host, port, *, once, extra_args=(), device="cuda"):
    cmd = [sys.executable, "-m", "repro_torch.serving.worker",
           "--listen", f"{host}:{port}", "--device", str(device),
           *extra_args]
    if once:
        cmd.append("--once")
    return subprocess.Popen(cmd, env=worker_env(), stdout=subprocess.PIPE,
                            text=True)


def _listening(proc: subprocess.Popen, deadline: float,
               start_timeout_s: float) -> tuple[str, int]:
    """The address off ``proc``'s banner; kills it on any failure."""
    try:
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TransportError(
                    f"worker did not report a listen address within "
                    f"{start_timeout_s}s")
            ready, _, _ = select.select([proc.stdout], [], [], remaining)
            if not ready:
                continue
            line = proc.stdout.readline()
            if not line:                   # EOF: the worker died at startup
                raise TransportError(
                    f"worker exited before listening "
                    f"(rc={proc.wait(timeout=10)})")
            if line.startswith(BANNER):
                addr = line.split(None, 1)[1].strip()
                h, _, p = addr.rpartition(":")
                return h, int(p)
    except Exception:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        raise


@dataclasses.dataclass
class Fleet:
    """N spawned workers: the addresses a router attaches to, plus the
    process handles this stand-in scheduler owns."""

    workers: list[tuple[tuple[str, int], subprocess.Popen]]

    @property
    def addrs(self) -> list[tuple[str, int]]:
        return [addr for addr, _ in self.workers]

    def close(self):
        for _, proc in self.workers:
            if proc.poll() is None:
                proc.terminate()
        for _, proc in self.workers:
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)

    def __enter__(self) -> "Fleet":
        return self

    def __exit__(self, *exc):
        self.close()


def launch_fleet(n: int, *, host: str = "127.0.0.1",
                 device: str = "cuda", start_timeout_s: float = 60.0) -> Fleet:
    """Spawn ``n`` pod-like local TCP workers on ``device`` (``once=False``
    — they keep listening across router attach/detach) and return their
    addresses.  The workers start together and are then awaited in turn
    under one deadline, so the fleet comes up in about one worker's start
    time."""
    procs = [_start(host, 0, once=False, device=device) for _ in range(n)]
    deadline = time.monotonic() + start_timeout_s
    workers = []
    try:
        for proc in procs:
            workers.append((_listening(proc, deadline, start_timeout_s),
                            proc))
    except Exception:
        Fleet([(None, p) for p in procs]).close()
        raise
    return Fleet(workers)


def free_port(host: str = "127.0.0.1") -> int:
    """A kernel-picked free port.  The bind-then-release dance is racy in
    principle; for the localhost demo/CI scheduler stand-in it is the
    standard trade — a real scheduler assigns endpoints itself."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class PodHandle:
    """One spawned multi-process pod: rank-ordered addresses and process
    handles (index 0 is the head — the only rank a router dials)."""

    rank_addrs: list[tuple[str, int]]
    procs: list[subprocess.Popen]
    coordinator: str

    @property
    def head_addr(self) -> tuple[str, int]:
        return self.rank_addrs[0]

    @property
    def head_proc(self) -> subprocess.Popen:
        return self.procs[0]

    def close(self):
        """Give the ranks POD_EXIT_GRACE_S to exit on their own (a head
        that answered shutdown forwarded it to every rank, which then
        writes its stats and exits), then terminate what is left and reap
        all."""
        deadline = time.monotonic() + POD_EXIT_GRACE_S
        for proc in self.procs:
            try:
                proc.wait(timeout=max(deadline - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                pass
        Fleet([(None, p) for p in self.procs]).close()

    def __enter__(self) -> "PodHandle":
        return self

    def __exit__(self, *exc):
        self.close()


def launch_pod(pod_size: int, *, host: str = "127.0.0.1",
               once: bool = True, device: str = "cuda",
               start_timeout_s: float = 120.0) -> PodHandle:
    """Spawn one ``pod_size``-rank pod on localhost, every rank on
    ``device``; → PodHandle.

    Non-head ranks come up first (the head claims their mutating sessions
    at startup, so they must already be listening), each handed the shared
    coordinator address and its rank; the head comes up last with
    ``--pod-peers`` naming the ranks.  The head's banner therefore means
    the whole pod is wired.  ``once`` ties the HEAD's lifetime to its
    first router session (stub-owned pods); non-head ranks always follow
    the head — a forwarded shutdown or the handle's close() retires them."""
    if pod_size < 1:
        raise ValueError(f"pod_size must be >= 1, got {pod_size}")
    coordinator = f"{host}:{free_port(host)}"
    addrs: list[tuple[str, int]] = []
    procs: list[subprocess.Popen] = []
    try:
        for rank in range(1, pod_size):
            addr, proc = spawn_worker(
                host, once=False, start_timeout_s=start_timeout_s,
                device=device,
                extra_args=["--pod-rank", str(rank),
                            "--pod-size", str(pod_size),
                            "--coordinator", coordinator])
            addrs.append(addr)
            procs.append(proc)
        peers = ",".join(f"{h}:{p}" for h, p in addrs)
        head_args = ["--pod-rank", "0", "--pod-size", str(pod_size),
                     "--coordinator", coordinator]
        if peers:
            head_args += ["--pod-peers", peers]
        head_addr, head_proc = spawn_worker(
            host, once=once, start_timeout_s=start_timeout_s,
            device=device, extra_args=head_args)
    except Exception:
        PodHandle(addrs, procs, coordinator).close()
        raise
    return PodHandle([head_addr] + addrs, [head_proc] + procs, coordinator)
