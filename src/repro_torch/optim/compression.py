"""Error-feedback int8 gradient compression (``repro.optim.compression``),
over dicts of tensors.

Each step compresses (grad + residual) to per-tensor-scaled int8 and carries
the quantization error into the next step's residual, so the sum of the
decompressed gradients tracks the sum of the true ones.  ``torch.round``
rounds half to even, as ``jnp.round`` does.  The compressed stream is meant
for a cross-device all-reduce; the reference's train step calls none of
this, and neither does the port's: its mesh step reduces the gradients
uncompressed (``models/steps.py``), as the reference's does.
"""
from __future__ import annotations

import torch


def compress_int8(x: torch.Tensor):
    """Per-tensor symmetric int8 quantization → (q int8, scale float32)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().max() / 127.0, min=1e-12)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def init_error_feedback(params: dict) -> dict:
    return {k: torch.zeros_like(p, dtype=torch.float32)
            for k, p in params.items()}


def error_feedback_compress(grads: dict, residuals: dict):
    """→ ({name: (q, scale)}, new residuals), with
    decompress(q, scale) + residual' == grad + residual (up to clipping)."""
    comp, new_res = {}, {}
    for k, g in grads.items():
        corrected = g.float() + residuals[k]
        q, scale = compress_int8(corrected)
        comp[k] = (q, scale)
        new_res[k] = corrected - decompress_int8(q, scale)
    return comp, new_res


def decompress_tree(compressed: dict, dtype=torch.float32) -> dict:
    """Inverse of the compress step over {name: (q, scale)}."""
    return {k: decompress_int8(q, s, dtype) for k, (q, s) in
            compressed.items()}
