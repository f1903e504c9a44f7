"""Rotary position embeddings (text positions; M-RoPE waits for the VLM
family).  GPT-NeoX half rotation, as in ``repro.models.rotary``."""
from __future__ import annotations

import torch


def inv_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> torch.Tensor:
    """positions: (B, S) int → angles (B, S, head_dim // 2) float32."""
    if positions.dim() != 2:
        raise NotImplementedError("M-RoPE positions are not ported yet")
    freqs = inv_freqs(head_dim, theta, device=positions.device)
    return positions[..., None].to(torch.float32) * freqs


def apply_rope(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """x: (B, S, n_heads, head_dim); angles: (B, S, head_dim // 2)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def text_positions(batch: int, seq: int, start, device=None) -> torch.Tensor:
    """(B, S) int32 positions starting at ``start`` (int or (B,) tensor)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :]
    start = torch.as_tensor(start, dtype=torch.int32, device=device)
    start = start.reshape(-1, 1) if start.dim() else start.reshape(1, 1)
    return (pos + start).expand(batch, seq)
