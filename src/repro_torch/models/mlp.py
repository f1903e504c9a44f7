"""SwiGLU feed-forward block.  Over a mesh (``forward_mesh``, the train and
the serve routes) each "model" rank runs its columns of ``gate``/``up`` and
its rows of ``down``, and a ``psum`` over "model" sums the ranks."""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from repro_torch.nn import Linear
from repro_torch.sharding import shard_map as sm


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

    def forward_mesh(self, w, xs):
        """The train route over a mesh: ``w`` the block's parameters as
        ``steps.MeshParams`` gives them, ``xs`` {position: (B_loc, S, d)}
        replicated over "model" → {position: (B_loc, S, d_out)}.  Where
        d_ff does not split over "model" every rank runs the whole block
        and nothing is summed."""
        ws = {n: w(n) for n in ("gate.w", "up.w", "down.w")}
        part = {p: torch.func.functional_call(
                    self, {n: t[p] for n, t in ws.items()}, (x,),
                    {"train": True}) for p, x in xs.items()}
        if "model" in w.axes("down.w", 0):
            return sm.psum(part, "model", w.mesh)
        return part
