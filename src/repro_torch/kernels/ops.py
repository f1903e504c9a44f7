"""Public kernel entry points with the signatures of ``repro.kernels.ops``.

Model code calls these in the model layouts.  Each runs its hand-written
Hopper kernel on CUDA tensors and its plain PyTorch version on CPU tensors:
the tensor's device decides, not ``cfg.use_pallas``.  Unlike the Pallas
wrappers there is no fallback for ragged shapes — the CUDA kernels mask the
ragged edge themselves.  ``fused_sample`` with ``top_k > 0`` needs a
per-row sort that the kernel does not do: it runs the plain version on the
tensors' own device, CPU or CUDA, as the reference routes it to its
oracle.  Serving never asks for it: the fused tick passes no ``top_k`` and
top-k rows sample on the host.

Under a cost counter (``repro_torch.launch.cost.CostCounter``) each kernel
wrapper is one region that records its module's ``cost(...)``
(``kernels.region``).

``decode_attention_write`` and ``decode_attention_paged_write`` are what
decode runs: the row's K/V write (``cache_ring_update``,
``cache_paged_update``) folded into the attention's launch.  They have no
counterpart in ``repro.kernels.ops``, where the two are separate calls.
"""
from __future__ import annotations

from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (
    cache_paged_update, cache_ring_update, decode_attention,
    decode_attention_paged, decode_attention_paged_write,
    decode_attention_write,
)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.sample import fused_sample as _fused_sample_kernel
from repro_torch.kernels.ssm_scan import ssm_scan

__all__ = ["flash_attention", "decode_attention", "cache_ring_update",
           "decode_attention_write", "decode_attention_paged",
           "cache_paged_update", "decode_attention_paged_write",
           "fused_sample", "ssm_scan", "KERNELS", "launch_counts",
           "reset_launch_counts"]


def fused_sample(logits, seed, rid, pos, temperature, *, top_k: int = 0):
    """logits: (B, V) float32; seed/rid/pos: (B,) int32 stateless RNG
    counters; temperature: (B,) float32 (0 → greedy argmax) → (B,) int32."""
    if top_k > 0:
        return ref.fused_sample_ref(logits, seed, rid, pos, temperature,
                                    top_k=top_k)
    return _fused_sample_kernel(logits, seed, rid, pos, temperature)


# every kernel wrapper, by name, with its counter
KERNELS = {
    "decode_attention": decode_attention,
    "cache_ring_update": cache_ring_update,
    "fused_sample": _fused_sample_kernel,
    "flash_attention": flash_attention,
    "decode_attention_paged": decode_attention_paged,
    "cache_paged_update": cache_paged_update,
    "ssm_scan": ssm_scan,
    "decode_attention_write": decode_attention_write,
    "decode_attention_paged_write": decode_attention_paged_write,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts():
    for fn in KERNELS.values():
        fn.launches = 0
