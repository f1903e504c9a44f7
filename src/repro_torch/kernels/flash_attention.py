"""K4 flash attention (prefill).

Replaces ``repro/kernels/flash_attention.py::flash_attention_bhsd``.  The
CUDA kernel lives in ``csrc/flash_attention.cu``, whose head note says what
bounds it on the H100 and what its design does about it: in bf16 with
hd <= 128 a FlashAttention-2 body on the tensor cores (``mma.sync``, hd
padded to a multiple of 16 in shared memory), otherwise exact float32 FMA.

The wrapper runs the kernel on CUDA tensors and its plain PyTorch version
(``repro_torch.kernels.ref``) on CPU tensors; ``launches`` counts kernel
launches; ``cost`` is the FLOPs and HBM bytes of one launch, which a cost
counter records for each call (``region``).  The kernel has no backward: a
CUDA call with grad enabled and an input that requires it raises
``_lib.NoBackwardError``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _lib, ref
from repro_torch.kernels.region import Cost, counted

SMEM_LIMIT = 232448      # dynamic shared memory a block may use on the H100
# the tiles of csrc/flash_attention.cu
MMA_BQ, MMA_BK, MMA_STAGES, MMA_MAX_HD = 32, 64, 3, 128
FMA_BQ, FMA_BK = 32, 64


def uses_tensor_cores(dtype, hd: int) -> bool:
    """bf16 with hd <= 128 runs the mma.sync body; float32 (and bf16 with a
    larger hd) the exact float32 FMA body."""
    return dtype == torch.bfloat16 and hd <= MMA_MAX_HD


def smem_bytes(dtype, hd: int) -> int:
    """Dynamic shared memory of one K4 block, as the CUDA source reckons it
    (``rt_flash_smem_bytes``): the mma body holds a bf16 query tile and a
    three-stage K/V ring at row pitch round16(hd) + 8; the FMA
    body float32 query, K/V, score and accumulator tiles."""
    if uses_tensor_cores(dtype, hd):
        pitch = -(-hd // 16) * 16 + 8
        return (MMA_BQ + 2 * MMA_STAGES * MMA_BK) * pitch * 2
    return (FMA_BQ * (hd + 1) + FMA_BK * (hd + 1) + FMA_BQ * (FMA_BK + 1)
            + FMA_BQ * hd + 3 * FMA_BQ) * 4


def visible_pairs(Sq: int, Sk: int, *, causal: bool = True,
                  window=None) -> int:
    """(query, key) pairs the mask lets through: key j is visible to query
    i when ``j <= i`` (causal) and ``j > i - window`` (window given)."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i + 1, Sk) if causal else np.full(Sq, Sk, np.int64)
    lo = np.zeros(Sq, np.int64) if window is None else np.maximum(
        i - window + 1, 0)
    return int(np.maximum(hi - lo, 0).sum())


def cost(B: int, Sq: int, Sk: int, H: int, KV: int, hd: int, *,
         causal: bool = True, window=None, itemsize: int = 2) -> Cost:
    """One K4 launch: q read and the output written, k and v read once.
    FLOPs: q.k and p.v, 2 a (visible pair, head, dim) each; transcendentals:
    one exp a (visible pair, head)."""
    pairs = B * visible_pairs(Sq, Sk, causal=causal, window=window)
    return Cost(4 * pairs * H * hd,
                B * (2 * Sq * H * hd + 2 * Sk * KV * hd) * itemsize,
                pairs * H)


def _call_cost(q, k, v, *, causal: bool = True, window=None) -> Cost:
    B, Sq, H, hd = q.shape
    return cost(B, Sq, k.shape[1], H, k.shape[2], hd, causal=causal,
                window=window, itemsize=q.element_size())


@counted("flash_attention", _call_cost)
def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd), read through strides →
    (B, Sq, H, hd) in q's dtype.  Key j is visible to query i when
    ``j <= i`` (causal) and ``j > i - window`` (window given)."""
    if not q.is_cuda:
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    _lib.forward_only("flash_attention", q, k, v)
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    if (k.shape != (B, Sk, KV, hd) or v.shape != k.shape or H % KV):
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.stride(3) != 1 or k.stride(3) != 1 or k.stride() != v.stride():
        raise ValueError("head_dim must be contiguous and K/V strides equal")
    if not (k.is_cuda and v.is_cuda):
        raise ValueError("q, k and v must lie on one CUDA device")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    code = _lib.dtype_code(q, k, v)
    if smem_bytes(q.dtype, hd) > SMEM_LIMIT:
        raise ValueError(f"hd {hd} in {q.dtype} needs "
                         f"{smem_bytes(q.dtype, hd)} bytes of shared memory "
                         f"a block, over the {SMEM_LIMIT} the card allows")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    _lib.launch(
        "rt_flash_attention", q, q.data_ptr(), q.stride(0), q.stride(1),
        q.stride(2), k.data_ptr(), v.data_ptr(), k.stride(0), k.stride(1),
        k.stride(2), out.data_ptr(), out.stride(0), out.stride(1),
        out.stride(2), code, B, Sq, Sk, H, KV, hd, int(causal),
        int(window or 0), int(_lib.rows_16b(hd, q)),
        int(_lib.rows_16b(hd, k, v)))
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
