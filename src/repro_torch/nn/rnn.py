"""GRU recurrence for the performance-indicator stream (``repro.nn.rnn``).

Not ``nn.GRU``: the weights are laid out ``(in, 3H)`` and ``(H, 3H)``, the
bias sits on the input side only, and the candidate ``n = tanh(i_n + r ·
(h @ W_hn))`` has no hidden bias.  The cell is written out and stepped over
the time axis in a Python loop.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.nn.init import lecun_normal
from repro_torch.nn.layers import _param


class GRU(nn.Module):
    def __init__(self, in_dim: int, hidden: int, *, param_dtype=torch.float32,
                 generator=None, device=None):
        super().__init__()
        init = lecun_normal(in_axis=0)
        kw = dict(generator=generator, device=device, dtype=param_dtype)
        self.wi = _param(init((in_dim, 3 * hidden), **kw))   # input → r,z,n
        self.wh = _param(init((hidden, 3 * hidden), **kw))   # hidden → r,z,n
        self.b = _param(torch.zeros(3 * hidden, device=device,
                                    dtype=param_dtype))

    def cell(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        gi = x @ self.wi + self.b
        gh = h @ self.wh
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h

    def forward(self, xs: torch.Tensor, h0: torch.Tensor | None = None):
        """xs: (batch, time, in_dim) → (hidden_final, all_hidden (B,T,H))."""
        if h0 is None:
            h0 = xs.new_zeros(xs.shape[0], self.wh.shape[0])
        h, hs = h0, []
        for t in range(xs.shape[1]):
            h = self.cell(h, xs[:, t])
            hs.append(h)
        return h, torch.stack(hs, dim=1)
