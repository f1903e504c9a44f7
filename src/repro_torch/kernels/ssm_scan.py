"""K7 SSD scan (Mamba2 prefill).

Replaces ``repro/kernels/ssm_scan.py::ssm_scan_ssd``.  The CUDA kernel
lives in ``csrc/ssm_scan.cu``, whose head note says what bounds it on the
H100 and what its design does about it.

The wrapper runs the kernel on CUDA tensors and its plain PyTorch version
(``repro_torch.kernels.ref.ssm_scan_ref``, the sequential recurrence) on
CPU tensors; ``launches`` counts kernel launches.  Unlike the reference
wrapper, a ragged L (not a multiple of the chunk) runs the kernel too: it
masks the tail.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib, ref

SSD_TILE = 64            # the kernel's largest chunk, as in the CUDA source


def ssm_scan(x, dt, A, B, C, *, chunk: int = 128, return_state: bool = False):
    """x: (Bsz, L, H, hd); dt: (Bsz, L, H); A: (H,); B/C: (Bsz, L, H, N),
    cast to float32 as the reference wrapper does → y (Bsz, L, H, hd)
    float32, and with ``return_state`` also the carried state after the
    last token, (Bsz, H, hd, N) float32.  The kernel evaluates the scan in
    chunks of min(chunk, 64) tokens."""
    if not x.is_cuda:
        return ref.ssm_scan_ref(x, dt, A, B, C, return_state=return_state)
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
    A = A.contiguous()
    y = torch.empty((Bsz, L, H, hd), dtype=torch.float32, device=x.device)
    h = (torch.empty((Bsz, H, hd, N), dtype=torch.float32, device=x.device)
         if return_state else None)
    err = _lib.load().rt_ssm_scan(
        x.data_ptr(), x.stride(0), x.stride(1), x.stride(2), dt.data_ptr(),
        dt.stride(0), dt.stride(1), dt.stride(2), A.data_ptr(), B.data_ptr(),
        B.stride(0), B.stride(1), B.stride(2), C.data_ptr(), C.stride(0),
        C.stride(1), C.stride(2), y.data_ptr(),
        None if h is None else h.data_ptr(), Bsz, L, H, hd, N,
        min(chunk, SSD_TILE), _lib.stream_ptr(x))
    _lib.check(err, "ssm_scan")
    ssm_scan.launches += 1
    return (y, h) if return_state else y


ssm_scan.launches = 0
