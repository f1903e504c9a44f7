"""K3 fused sampling: greedy argmax or Gumbel-max over one logits row.

Replaces ``repro/kernels/sample.py::fused_sample_bv``.  The CUDA kernel
lives in ``csrc/sample.cu``, whose head note says what bounds it on the
H100 and what its design does about it: each row is cut into ``split_plan``
ranges of whole 16-byte vectors, one block a range, and a merge reduces the
ranges' (score, first index) pairs.

The wrapper runs the kernel on CUDA tensors and its plain PyTorch version
(``repro_torch.kernels.ref``) on CPU tensors; ``launches`` counts kernel
launches; ``cost`` is the FLOPs and HBM bytes of one launch, which a cost
counter records for each call (``region``).
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib, ref
from repro_torch.kernels.region import Cost, counted, per_row_list

SAMPLE_VEC = 4            # float32 columns in one 16-byte load
MIN_SPLIT = 1024          # columns one block takes at least: 256 threads x 4
BLOCKS_PER_SM = 2         # split target: about this many blocks per SM


def split_plan(B: int, V: int, sm_count: int) -> tuple[int, int]:
    """(split_len, n_splits): cut each of the B rows of V columns into
    ranges of whole 16-byte vectors (split_len a multiple of SAMPLE_VEC),
    none empty, so that the B * n_splits blocks come to about
    BLOCKS_PER_SM blocks per SM, and no more ranges than V has whole
    MIN_SPLIT-column stretches (rounded up)."""
    want = math.ceil(BLOCKS_PER_SM * sm_count / max(B, 1))
    n = max(1, min(want, math.ceil(V / MIN_SPLIT)))
    split_len = math.ceil(math.ceil(V / n) / SAMPLE_VEC) * SAMPLE_VEC
    return split_len, math.ceil(V / split_len)


def cost(B: int, V: int, sampled: int = 0) -> Cost:
    """One K3 call: the (B, V) float32 logits read once, the four (B,)
    counters read and the tokens written; a compare an element, and on each
    of the ``sampled`` rows (temperature > 0) a divide and an add an
    element and two logs of the Gumbel noise."""
    return Cost(B * V + 2 * sampled * V, B * V * 4 + B * 20,
                2 * sampled * V)


def _call_cost(logits, seed, rid, pos, temperature) -> Cost:
    B, V = logits.shape
    return cost(B, V, sum(t > 0 for t in per_row_list(temperature, B)))


@counted("fused_sample", _call_cost)
def fused_sample(logits, seed, rid, pos, temperature):
    """logits: (B, V) float32; seed/rid/pos: (B,) int32 counters;
    temperature: (B,) float32, 0 → greedy → (B,) int32 tokens."""
    if not logits.is_cuda:
        return ref.fused_sample_ref(logits, seed, rid, pos, temperature)
    if logits.dim() != 2 or logits.dtype != torch.float32 \
            or logits.stride(1) != 1:
        raise ValueError("logits must be (B, V) float32 with unit column "
                         "stride")
    B, V = logits.shape
    split_len, n_splits = split_plan(B, V,
                                     _lib.sm_count(logits.device.index or 0))
    seed, rid, pos = (_lib.per_row(x, logits, torch.int32)
                      for x in (seed, rid, pos))
    temp = _lib.per_row(temperature, logits, torch.float32)
    out = torch.empty(B, dtype=torch.int32, device=logits.device)
    part = torch.empty(2 * B * n_splits if n_splits > 1 else 0,
                       dtype=torch.int32, device=logits.device)
    _lib.launch("rt_fused_sample", logits, logits.data_ptr(),
                logits.stride(0), seed.data_ptr(), rid.data_ptr(),
                pos.data_ptr(), temp.data_ptr(), out.data_ptr(),
                part.data_ptr(), B, V, split_len, n_splits)
    fused_sample.launches += 1
    return out


fused_sample.launches = 0


def sample_noise(seed, rid, pos, V: int):
    """The sampler's hash bits ((B, V), as uint32 values in int64) and
    Gumbel noise g ((B, V) float32), from the kernel's own arithmetic on a
    CUDA tensor and from the plain version on a CPU one.  Tests use it to
    hold the two bit for bit; serving never calls it."""
    seed = torch.as_tensor(seed, dtype=torch.int32)
    if not seed.is_cuda:
        bits = ref.sample_bits(seed, rid, pos, V)
        return bits, ref.gumbel_noise(bits)
    seed = seed.reshape(-1).contiguous()
    rid, pos = (_lib.per_row(x, seed, torch.int32) for x in (rid, pos))
    B = seed.shape[0]
    bits = torch.empty((B, V), dtype=torch.int32, device=seed.device)
    g = torch.empty((B, V), dtype=torch.float32, device=seed.device)
    _lib.launch("rt_sample_noise", seed, seed.data_ptr(), rid.data_ptr(),
                pos.data_ptr(), bits.data_ptr(), g.data_ptr(), B, V)
    return bits.to(torch.int64) & 0xFFFFFFFF, g
