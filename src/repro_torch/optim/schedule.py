"""Learning-rate schedules as callables of the step (``repro.optim.
schedule``).

Each returns a float32 0-d tensor on the CPU, computed in float32 as the
reference's ``jnp`` arithmetic is: a float32 tensor times a tensor on the
card is allowed, so the same schedule serves either device.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant_schedule(lr: float):
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def cosine_schedule(peak_lr: float, total_steps: int, *,
                    final_frac: float = 0.1):
    def sched(step):
        t = torch.clamp(_f32(step) / max(total_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1 + torch.cos(math.pi * t))
        return peak_lr * (final_frac + (1 - final_frac) * cos)

    return sched


def linear_warmup_cosine(peak_lr: float, warmup_steps: int, total_steps: int,
                         *, final_frac: float = 0.1):
    def sched(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        t = torch.clamp((step - warmup_steps)
                        / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac) * 0.5
                         * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup_steps, warm, cos)

    return sched


def wsd_schedule(peak_lr: float, warmup_steps: int, total_steps: int, *,
                 decay_frac: float = 0.1):
    """Warmup-stable-decay (used by several of the assigned archs'
    recipes)."""
    decay_steps = int(total_steps * decay_frac)
    stable_end = total_steps - decay_steps

    def sched(step):
        step = _f32(step)
        warm = peak_lr * step / max(warmup_steps, 1)
        decay = peak_lr * torch.clamp((total_steps - step)
                                      / max(decay_steps, 1), 0.0, 1.0)
        stable = torch.tensor(peak_lr, dtype=torch.float32)
        return torch.where(step < warmup_steps, warm,
                           torch.where(step < stable_end, stable, decay))

    return sched
