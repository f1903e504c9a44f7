"""K7 SSD scan (Mamba2 prefill).

Replaces ``repro/kernels/ssm_scan.py::ssm_scan_ssd``.  The CUDA kernels
live in ``csrc/ssm_scan.cu``, whose head note says what bounds them on the
H100 and what their design does about it: chunk-local states, a pass over
the chunks, then the outputs, each launch parallel over (chunk, head, row)
and every product on the tensor cores at float32 accuracy (3xTF32), in a
kernel instance built for a padded width W (``width``) that covers hd and N.

The wrapper runs the kernels on CUDA tensors and its plain PyTorch version
(``repro_torch.kernels.ref.ssm_scan_ref``, the sequential recurrence) on
CPU tensors; ``launches`` counts calls that launched the kernels, and
``cost`` is the FLOPs and HBM bytes of one call, which a cost counter
records for each call (``region``).  Unlike
the reference wrapper, a ragged L (not a multiple of the chunk) runs the
kernels too: they mask the tail.  The kernels have no backward: a CUDA call
with grad enabled and an input that requires it raises
``_lib.NoBackwardError``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.kernels import _lib, ref
from repro_torch.kernels.region import Cost, counted

SSD_TILE = 64            # the kernels' largest chunk, as in the CUDA source
SSD_QT = 32              # query rows of an output block
SSD_DG = 32              # state rows (of hd) of a state block
MAX_WIDTH = 128          # largest hd and N the tiles take
SMEM_LIMIT = 232448      # dynamic shared memory a block may use on the H100
PASS_THREADS = 128


def _rup(x: int, m: int) -> int:
    return -(-x // m) * m


def _pitch4(cols: int) -> int:
    return _rup(cols, 32) + 4


def _pitch8(cols: int) -> int:
    return _rup(cols, 32) + 8


class Plan(NamedTuple):
    """How one call is laid out, and the only statement of its grids:
    ``n_chunks`` chunks of ``T`` tokens; the carried state padded to
    (DW, NK); the x extents of the three launches' (x, H, Bsz) grids, the
    state kernel's (one block per chunk and SSD_DG state rows; 0 when it
    does not run), the pass's (0 for one chunk) and the output kernel's
    (two query tiles a chunk); the workspace in float32 elements."""
    T: int
    n_chunks: int
    DW: int
    NK: int
    state_grid: int
    pass_grid: int
    output_grid: int
    workspace: int


def plan(Bsz: int, L: int, H: int, hd: int, N: int, chunk: int,
         return_state: bool = True) -> Plan:
    """The launch plan of ``ssm_scan``, whose grids ``rt_ssm_scan``
    launches as given.  One chunk needs no pass and no workspace: the
    state kernel writes the final state directly, and runs only when it
    is asked for."""
    if not (1 <= hd <= MAX_WIDTH and 1 <= N <= MAX_WIDTH):
        raise ValueError(f"hd {hd} and N {N}: each 1..{MAX_WIDTH}")
    T = min(chunk, SSD_TILE)
    nc = math.ceil(L / T)
    ndg = math.ceil(hd / SSD_DG)
    DW, NK = ndg * SSD_DG, _rup(N, 8)
    many = nc > 1
    state = nc * ndg if many or return_state else 0
    passes = math.ceil(DW * NK // 4 / PASS_THREADS) if many else 0
    ws = Bsz * H * nc * (DW * NK + 1) if many else 0
    return Plan(T, nc, DW, NK, state, passes, 2 * nc, ws)


def width(hd: int, N: int) -> int:
    """The padded width W (32, 64 or 128) whose kernel instance takes hd
    and N: each warp's tile count is fixed at build time."""
    return 32 if max(hd, N) <= 32 else 64 if max(hd, N) <= 64 else 128


def smem_bytes(hd: int, N: int) -> tuple[int, int]:
    """Shared memory a block of the state kernel and of the output kernel
    takes (``rt_ssm_smem_bytes``), at the padded width W: the state kernel
    holds 64 rows of x (32 columns) and of B; the output kernel 32 rows of
    C, 64 of B, W rows of the carried state, 32 rows of M and 64 of x; both
    the chunk's dt and prefix sums."""
    W = width(hd, N)
    state = SSD_TILE * _pitch8(SSD_DG) + SSD_TILE * _pitch8(W) + 3 * SSD_TILE
    out = ((SSD_QT + SSD_TILE + W) * _pitch4(W) + SSD_QT * _pitch4(SSD_TILE)
           + SSD_TILE * _pitch8(W) + 2 * SSD_TILE)
    return 4 * state, 4 * out


def cost(Bsz: int, L: int, H: int, hd: int, N: int, *, groups_b: int = 1,
         groups_c: int = 1, T: int = SSD_TILE, state: bool = True) -> Cost:
    """One call, in float32: each input read once (B and C as the number of
    distinct (N,) rows a token holds, one on zamba2's layout, where every
    head reads the same rows), y (and the final state) written once.  The
    chunked form at the kernels' tile of T tokens, causal and unpadded: per
    chunk of n tokens C B^T and M X over the n(n+1)/2 causal pairs, C . state
    and the state update over n x N x hd, 2 FLOPs a product; one exp a
    causal pair and a token for the decay factors."""
    flops = exps = 0
    for c0 in range(0, L, T):
        n = min(T, L - c0)
        tri = n * (n + 1) // 2
        flops += 2 * tri * N + 2 * tri * hd + 2 * 2 * n * N * hd
        exps += tri + n
    elems = (2 * Bsz * L * H * hd + Bsz * L * H + H
             + Bsz * L * (groups_b + groups_c) * N
             + (Bsz * H * hd * N if state else 0))
    return Cost(flops * Bsz * H, 4 * elems, exps * Bsz * H)


def _call_cost(x, dt, A, B, C, *, chunk: int = 128,
               return_state: bool = False) -> Cost:
    Bsz, L, H, hd = x.shape
    groups = lambda t: 1 if t.stride(2) == 0 else H
    return cost(Bsz, L, H, hd, B.shape[-1], groups_b=groups(B),
                groups_c=groups(C), T=min(chunk, SSD_TILE),
                state=return_state)


@counted("ssm_scan", _call_cost)
def ssm_scan(x, dt, A, B, C, *, chunk: int = 128, return_state: bool = False):
    """x: (Bsz, L, H, hd); dt: (Bsz, L, H); A: (H,); B/C: (Bsz, L, H, N),
    cast to float32 as the reference wrapper does → y (Bsz, L, H, hd)
    float32, and with ``return_state`` also the carried state after the
    last token, (Bsz, H, hd, N) float32.  The kernels evaluate the scan in
    chunks of min(chunk, 64) tokens; B and C may be views with a head
    stride of 0 (one group serving every head)."""
    if not x.is_cuda:
        return ref.ssm_scan_ref(x, dt, A, B, C, return_state=return_state)
    _lib.forward_only("ssm_scan", x, dt, A, B, C)
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    Bsz, L, H, hd = x.shape
    N = B.shape[-1]
    if (dt.shape != (Bsz, L, H) or A.shape != (H,)
            or B.shape != (Bsz, L, H, N) or C.shape != B.shape):
        raise ValueError(f"shapes x {tuple(x.shape)} dt {tuple(dt.shape)} A "
                         f"{tuple(A.shape)} B {tuple(B.shape)} C "
                         f"{tuple(C.shape)}")
    if not all(t.is_cuda for t in (dt, A, B, C)):
        raise ValueError("x, dt, A, B and C must lie on one CUDA device")
    if x.stride(3) != 1 or B.stride(3) != 1 or C.stride(3) != 1:
        raise ValueError("the last axis of x, B and C must be contiguous")
    if L < 1 or chunk < 1:
        raise ValueError(f"L={L} and chunk={chunk} must be >= 1")
    p = plan(Bsz, L, H, hd, N, chunk, return_state)
    A = A.contiguous()
    y = torch.empty((Bsz, L, H, hd), dtype=torch.float32, device=x.device)
    h = (torch.empty((Bsz, H, hd, N), dtype=torch.float32, device=x.device)
         if return_state else None)
    ws = (torch.empty(p.workspace, dtype=torch.float32, device=x.device)
          if p.workspace else None)
    _lib.launch(
        "rt_ssm_scan", x, x.data_ptr(), x.stride(0), x.stride(1),
        x.stride(2), dt.data_ptr(), dt.stride(0), dt.stride(1), dt.stride(2),
        A.data_ptr(), B.data_ptr(), B.stride(0), B.stride(1), B.stride(2),
        C.data_ptr(), C.stride(0), C.stride(1), C.stride(2), y.data_ptr(),
        None if h is None else h.data_ptr(),
        None if ws is None else ws.data_ptr(), Bsz, L, H, hd, N, p.T,
        p.state_grid, p.pass_grid, p.output_grid, int(_lib.rows_16b(hd, x)),
        int(_lib.rows_16b(N, B, C)))
    ssm_scan.launches += 1
    return (y, h) if return_state else y


ssm_scan.launches = 0
