"""The port stands alone: it imports neither JAX nor the JAX package, and
keeps library attention, ``torch.compile`` and kernel packages off its path.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
# chip_smoke.py times library attention as a yardstick beside the kernels,
# so the last three patterns apply to the package alone
IMPORTS = [
    (r"^\s*(import|from)\s+jax\b", "imports jax"),
    (r"^\s*(import|from)\s+repro(\.|\s|$)", "imports the JAX package"),
]
OFF_PATH = [
    (r"scaled_dot_product_attention", "library attention"),
    (r"torch\.compile", "torch.compile"),
    (r"^\s*(import|from)\s+(flash_attn|xformers|flashinfer|vllm)\b",
     "a package of finished kernels"),
]


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.launch.serve, repro_torch.models.bridge\n"
        "import repro_torch.kernels.ops, repro_torch.models.steps\n"
        "import repro_torch.serving.draft, repro_torch.serving.slots\n"
        "import repro_torch.models.mamba, repro_torch.kernels.ssm_scan\n"
        "import repro_torch.models.rotary, repro_torch.models.attention\n"
        "import repro_torch.models.blocks, repro_torch.models.transformer\n"
        "import repro_torch.serving.engine\n"
        "import repro_torch.serving.closed_loop, repro_torch.serving.router\n"
        "import repro_torch.serving.replica, repro_torch.serving.transport\n"
        "import repro_torch.serving.chaos, repro_torch.serving.profiles\n"
        "import repro_torch.serving.worker, repro_torch.serving.fleet\n"
        "import repro_torch.serving.observe, repro_torch.sharding\n"
        "import repro_torch.launch.mesh\n"
        "import repro_torch.core.monitoring, repro_torch.core.scaling\n"
        "import repro_torch.core.allocation, repro_torch.core.dnn\n"
        "import repro_torch.optim, repro_torch.nn\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("pattern,what", IMPORTS + OFF_PATH)
def test_port_sources_stay_clean(pattern, what):
    assert (ROOT / "chip_smoke.py").is_file()
    files = PORT_FILES if (pattern, what) in IMPORTS else PORT_FILES[:-1]
    hits = []
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#", 1)[0]
            if re.search(pattern, code):
                hits.append(f"{path.relative_to(ROOT)}:{n}")
    assert not hits, f"{what}: {hits}"


@pytest.mark.parametrize("topology", ["sharded", "proc", "tcp", "pod"])
def test_unported_topologies_raise_by_name(topology):
    """Every topology is built; an option a topology has no use for
    (``pod_size`` outside pod, ``mesh`` outside sharded) raises by name,
    naming the topology, before any worker spawns or any weight is drawn;
    an unknown topology raises ValueError."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.serving.closed_loop import LoopConfig, run_closed_loop
    from repro_torch.serving.router import ReplicaRouter
    cfg = get_smoke_config("qwen2.5-3b")
    foreign = ({"mesh": make_mesh((1,), ("data",), devices=["cpu"])}
               if topology == "pod" else {"pod_size": 4})
    with pytest.raises(NotImplementedError, match=topology):
        ReplicaRouter.from_topology(cfg, topology, slots=2, max_seq=16,
                                    device="cpu", **foreign)
    if "pod_size" in foreign:
        with pytest.raises(NotImplementedError, match=topology):
            run_closed_loop(cfg, ticks=1,
                            lc=LoopConfig(topology=topology, **foreign),
                            device="cpu")
    with pytest.raises(ValueError, match="unknown topology"):
        ReplicaRouter.from_topology(cfg, "mesh", slots=2, max_seq=16,
                                    device="cpu")


def test_observe_addrs_raise_by_name():
    """observe_addrs attach read-only observers (``MetricsObserver``): an
    address nobody listens on fails the loop typed, naming the address."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.closed_loop import LoopConfig, run_closed_loop
    from repro_torch.serving.transport import Listener, TransportError
    lst = Listener("127.0.0.1", 0)
    addr = f"{lst.host}:{lst.port}"
    lst.close()
    with pytest.raises(TransportError, match=addr):
        run_closed_loop(get_smoke_config("qwen2.5-3b"), ticks=1,
                        lc=LoopConfig(observe_addrs=(addr,)), device="cpu")


def test_spawned_worker_never_loads_jax(tmp_path):
    """A port worker process (``--listen``, ``--once``, ``--device cpu``),
    driven through attach, init, submit and steps by a TcpReplica, reports
    at exit that neither JAX nor the JAX package was ever imported."""
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving import Request, TcpReplica
    from repro_torch.serving.fleet import BANNER, worker_env
    report = tmp_path / "modules.txt"
    code = (
        "import atexit, runpy, sys\n"
        "def report():\n"
        "    bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]\n"
        f"    open({str(report)!r}, 'w').write(repr(bad))\n"
        "atexit.register(report)\n"
        "sys.argv = ['worker', '--listen', '127.0.0.1:0', '--device', "
        "'cpu', '--once']\n"
        "runpy.run_module('repro_torch.serving.worker', "
        "run_name='__main__')\n")
    proc = subprocess.Popen([sys.executable, "-c", code], env=worker_env(),
                            stdout=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert line.startswith(BANNER), line
        host, _, port = line.split()[1].rpartition(":")
        rep = TcpReplica(get_smoke_config("qwen2.5-3b"), slots=2, max_seq=16,
                         addr=(host, int(port)), device="cpu")
        rep.submit(Request(rid=0, prompt=np.arange(3, 8, dtype=np.int32),
                           gen_len=3), now=0.0)
        done, now = [], 0.0
        while not done and now < 50:
            now += 1.0
            done = rep.step(now)
        assert len(done[0].tokens_out) == 3
        rep.close()                     # --once: the worker exits
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
    assert report.read_text() == "[]"


@pytest.mark.parametrize("option,value", [
    ("mesh", object()), ("addrs", ["127.0.0.1:1"]), ("pod_size", 4),
    ("batch_submits", False)])
def test_other_topologies_options_raise_with_inproc(option, value):
    """The options of the other topologies have no effect on inproc, so
    setting one raises by name instead of being ignored; so does a
    LoopConfig that carries one."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.serving.closed_loop import LoopConfig, run_closed_loop
    from repro_torch.serving.router import ReplicaRouter
    cfg = get_smoke_config("qwen2.5-3b")
    with pytest.raises(NotImplementedError, match=option):
        ReplicaRouter.from_topology(cfg, "inproc", slots=2, max_seq=16,
                                    device="cpu", **{option: value})
    if option != "mesh":
        lc = LoopConfig(**{option: tuple(value) if option == "addrs"
                           else value})
        with pytest.raises(NotImplementedError, match=option):
            run_closed_loop(cfg, ticks=1, lc=lc, device="cpu")


def test_loop_entry_points_default_to_cuda():
    """Without a card, the loop, the router, the agent and its network
    raise rather than carry on on the CPU."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.core.allocation.rl import DQNAgent
    from repro_torch.core.dnn.model import (
        DNNConfig, MultiStreamDNN, dnn_from_reference,
    )
    from repro_torch.serving.closed_loop import run_closed_loop
    from repro_torch.serving.router import ReplicaRouter
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = get_smoke_config("qwen2.5-3b")
    for call in (lambda: run_closed_loop(cfg, ticks=1),
                 lambda: ReplicaRouter.shared_core(cfg, slots=2, max_seq=16),
                 lambda: DQNAgent(DNNConfig()),
                 lambda: MultiStreamDNN(DNNConfig()),
                 lambda: dnn_from_reference({}, {}, DNNConfig())):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
