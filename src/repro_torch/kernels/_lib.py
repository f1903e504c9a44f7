"""Build and load the Hopper kernel library.

The CUDA sources under ``csrc/`` compile with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface, loaded through ``ctypes``.
The build runs at first use, one ``nvcc`` per source started together, into
``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``).  The library's name carries a hash of the sources and
flags, so an edited source is rebuilt and an unchanged one is reused.

Nothing here runs at import: ``import repro_torch`` works where there is no
``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

# dtype codes of csrc/common.cuh: the dtypes the configs compute in
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argument types of the launching entry points after the CUDA device each
# takes first (load() prepends it); the last is the stream
_NEW_ROWS = [_P, _P, _L, _L, _I]         # k_new, v_new, strides, dtype
_SIGNATURES = {
    "rt_cache_ring_update": [_P, _I, _L, _L, _P, _I, _L, _P, _I, _I, _I, _I,
                             _P],
    "rt_cache_paged_update": [_P, _I, _L, _L, _P, _I, _L, _P, _P, _I, _I, _I,
                              _I, _I, _P],
    "rt_decode_attention": [_P, _L, _L, _P, _P, _L, _L, _L, _P, *_NEW_ROWS,
                            _P, _P, _P, *[_I] * 11, _P],
    "rt_decode_attention_paged": [_P, _L, _L, _P, _P, _L, _L, _L, _P, _L, _I,
                                  _P, *_NEW_ROWS, _P, _P, _P, *[_I] * 11, _P],
    "rt_flash_attention": [_P, _L, _L, _L, _P, _P, _L, _L, _L, _P, _L, _L, _L,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "rt_fused_sample": [_P, _L, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "rt_sample_noise": [_P, _P, _P, _P, _P, _I, _I, _P],
    "rt_ssm_scan": [_P, _L, _L, _L, _P, _L, _L, _L, _P, _P, _L, _L, _L, _P,
                    _L, _L, _L, _P, _P, _P, *[_I] * 11, _P],
}

# host-side queries of the library's own reckoning (they launch nothing)
_QUERIES = {"rt_flash_smem_bytes": [_I, _I], "rt_ssm_smem_bytes": [_I, _I, _I]}

_lib: ctypes.CDLL | None = None
build_seconds: float | None = None     # wall time of the build, when built here
build_log: str | None = None           # nvcc's output (ptxas registers, spills)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(target: Path) -> str:
    """Compile and link into ``target``; returns nvcc's output."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in _sources():
            obj = Path(tmp) / (src.stem + ".o")
            objs.append(obj)
            procs.append((src, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        failed, logs = [], []
        for src, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"{src.name}:\n{out}")
            if proc.returncode != 0:
                failed.append(logs[-1])
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_so = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        os.replace(tmp_so, target)     # atomic: concurrent builders agree
    return "\n".join(logs)


def load() -> ctypes.CDLL:
    """The kernel library, built on first call if needed."""
    global _lib, build_seconds, build_log
    if _lib is not None:
        return _lib
    target = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
    if not target.exists():
        t0 = time.perf_counter()
        build_log = _build(target)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(target))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = [_I, *argtypes]
        fn.restype = ctypes.c_int
    for name, argtypes in _QUERIES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_longlong
    _lib = lib
    return lib


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device (132 on the H100 SXM)."""
    return torch.cuda.get_device_properties(device_index).multi_processor_count


class NoBackwardError(RuntimeError):
    """A hand kernel was asked for an output autograd must differentiate.
    The kernels fill their outputs through ``ctypes``, which autograd cannot
    see, so such a call would drop the gradient without an error."""


def forward_only(name: str, *tensors):
    """Raise ``NoBackwardError`` when grad is enabled and any of ``tensors``
    requires it: the CUDA kernels have no backward."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NoBackwardError(
            f"{name}: the hand-written CUDA kernels have no backward, so "
            f"their output would carry no gradient; run under torch.no_grad "
            f"(as serving does), or train through the train route, which "
            f"runs no kernel: LM.forward(inputs, train=True), as "
            f"models.steps.make_train_step does")


def check(err: int, name: str):
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as the C functions take
    it."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, t: torch.Tensor, *args):
    """Call the library's entry point ``name`` for tensors on ``t``'s CUDA
    device: the device index first (the library links its own CUDA runtime
    and makes that device current for the launch), then ``args``, then
    PyTorch's current stream on that device.  Raises on a non-zero
    cudaError_t."""
    check(getattr(load(), name)(t.device.index, *args, stream_ptr(t)), name)


def dtype_code(*tensors) -> int:
    """The common dtype's code; raises unless all tensors share a supported
    dtype."""
    dt = tensors[0].dtype
    if dt not in DTYPE_CODES or any(t.dtype != dt for t in tensors):
        raise TypeError(f"unsupported dtypes {[t.dtype for t in tensors]}")
    return DTYPE_CODES[dt]


def per_row(x, like: torch.Tensor, dtype) -> torch.Tensor:
    """An int or tensor as a contiguous (B,) tensor on ``like``'s device,
    B = like.shape[0] (a scalar broadcasts to every row)."""
    t = torch.as_tensor(x, dtype=dtype, device=like.device)
    return t.reshape(-1).expand(like.shape[0]).contiguous()


def rows_16b(hd: int, *tensors) -> bool:
    """Every (hd,) row of the tensors (head_dim last and contiguous) starts
    on a 16-byte boundary and spans whole 16-byte vectors: a kernel may
    move it 16 bytes at a time."""
    per16 = 16 // tensors[0].element_size()
    return hd % per16 == 0 and all(
        t.data_ptr() % 16 == 0 and all(st % per16 == 0 for st in t.stride()[:-1])
        for t in tensors)
