"""SwiGLU feed-forward block."""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.nn import Linear


class SwiGLU(nn.Module):
    def __init__(self, d_model: int, d_ff: int, *, dtype: torch.dtype,
                 param_dtype=torch.float32, d_out: int | None = None,
                 generator=None, device=None):
        super().__init__()
        d_out = d_out or d_model
        kw = dict(dtype=dtype, use_bias=False, param_dtype=param_dtype,
                  generator=generator, device=device)
        self.gate = Linear(d_model, d_ff, **kw)
        self.up = Linear(d_model, d_ff, **kw)
        self.down = Linear(d_ff, d_out, **kw)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        return self.down(F.silu(self.gate(x, train=train))
                         * self.up(x, train=train), train=train)
