"""Parameter initializers: ``init(shape, *, generator, device, dtype)``.

The distributions of ``repro.nn.init``; torch generators draw other numbers
than JAX keys, so weights shared with the reference go through
``repro_torch.models.bridge`` instead.
"""
from __future__ import annotations

import math

import torch


def _truncated_standard(shape, lower, upper, generator, device):
    """Standard normal truncated to [lower, upper] by inverse CDF."""
    if device is not None and torch.device(device).type == "meta":
        return torch.empty(shape, device=device)      # shapes only
    cdf = lambda x: 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))
    lo, hi = cdf(lower), cdf(upper)
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = (2.0 * (lo + u * (hi - lo)) - 1.0).clamp_(-1 + 1e-7, 1 - 1e-7)
    return (math.sqrt(2.0) * torch.erfinv(u)).clamp_(lower, upper)


def normal_init(stddev: float = 0.02):
    def init(shape, *, generator=None, device=None, dtype=torch.float32):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (stddev * x).to(dtype)

    return init


def truncated_normal(stddev: float = 0.02, lower: float = -2.0,
                     upper: float = 2.0):
    def init(shape, *, generator=None, device=None, dtype=torch.float32):
        u = _truncated_standard(shape, lower, upper, generator, device)
        return (stddev * u).to(dtype)

    return init


def lecun_normal(in_axis: int = 0):
    """Fan-in scaled normal — the default for projection weights."""

    def init(shape, *, generator=None, device=None, dtype=torch.float32):
        std = (1.0 / max(shape[in_axis], 1)) ** 0.5
        u = _truncated_standard(shape, -2.0, 2.0, generator, device)
        # correct the truncated normal's variance shrinkage (~0.87962)
        return (std / 0.87962566103423978 * u).to(dtype)

    return init


def zeros_init():
    def init(shape, *, generator=None, device=None, dtype=torch.float32):
        return torch.zeros(shape, device=device, dtype=dtype)

    return init


def ones_init():
    def init(shape, *, generator=None, device=None, dtype=torch.float32):
        return torch.ones(shape, device=device, dtype=dtype)

    return init
