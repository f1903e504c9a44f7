"""Rotary position embeddings, Qwen2-VL's multimodal M-RoPE included.
GPT-NeoX half rotation, as in ``repro.models.rotary``.

M-RoPE splits the head_dim // 2 rotary frequencies into sections, one for
each of the (temporal, height, width) position streams.  The vision
frontend is a stub: the patch prefix takes the positions of a synthetic
square grid, and text positions set t = h = w, as Qwen2-VL does for a
text-only segment."""
from __future__ import annotations

import torch


def inv_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def section_ids(head_dim: int, sections: tuple[int, ...],
                device=None) -> torch.Tensor:
    """Each frequency's stream index in {0 .. len(sections) - 1}; sections
    that sum to less than head_dim // 2 are padded with the last stream."""
    half = head_dim // 2
    ids = [s for s, n in enumerate(sections) for _ in range(n)]
    ids += [len(sections) - 1] * (half - len(ids))
    return torch.tensor(ids[:half], dtype=torch.int64, device=device)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float,
                sections: tuple[int, ...] | None = None) -> torch.Tensor:
    """positions: (B, S) int, or (B, n_streams, S) for M-RoPE with its
    ``sections`` → angles (B, S, head_dim // 2) float32."""
    freqs = inv_freqs(head_dim, theta, device=positions.device)
    angles = positions[..., None].to(torch.float32) * freqs
    if positions.dim() == 2:
        return angles
    if sections is None:
        raise ValueError("M-RoPE positions need their sections")
    # (B, S, half, n_streams): each frequency takes its own stream's angle
    angles = angles.movedim(1, -1)
    ids = section_ids(head_dim, sections, device=positions.device)
    ids = ids.expand(angles.shape[:-1])[..., None]
    return torch.gather(angles, -1, ids)[..., 0]


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


def mrope_positions(batch: int, seq: int, n_patches: int, start,
                    device=None) -> torch.Tensor:
    """(B, 3, S) int32 positions: a √n_patches grid for the patch prefix
    (t = 0, h = row, w = column), then t = h = w text positions.  ``start``
    is an int or a (B,) tensor (a decode tick's slots sit at their own
    positions); it offsets the text positions only."""
    side = max(int(round(n_patches ** 0.5)), 1)
    idx = torch.arange(seq, dtype=torch.int32, device=device)
    is_text = idx >= n_patches
    start = torch.as_tensor(start, dtype=torch.int32, device=device)
    text = start.reshape(-1, 1) + idx                     # (B or 1, S)
    t = torch.where(is_text, text, torch.zeros_like(text))
    h = torch.where(is_text, text, idx // side)
    w = torch.where(is_text, text, idx % side)
    return torch.stack([t, h, w], dim=1).expand(batch, 3, seq)
