"""Mixture-of-Experts layer (``repro.models.moe.MoE``): a top-k router and
the sort-based capacity dispatch of its global path.

Every token's K assignments are sorted by expert (a stable sort, as
``jnp.argsort``), each expert takes the first C of its assignments into a
fixed ``(E, C, d)`` slab, C = min(max(8, round(N·K·cf/E)), N·K), and the
expert products are three batched matmuls over the slabs.  Assignments past
an expert's capacity are dropped: they add nothing to their token.  The
reference runs these products outside any Pallas kernel, and here they are
``torch.bmm`` in the compute dtype.

Two departures:
- The combine undoes the sort by index (each assignment gathers its
  expert's output row) and sums each token's K rows in float32 in a fixed
  order, where the reference scatter-adds into ``(N, d)`` in the compute
  dtype: on CUDA a floating-point ``index_add_`` uses atomics, and two
  identical calls could then differ.  In float32 the two agree to
  rounding; in bf16 the port rounds once where the reference rounds after
  every add.
- The expert stacks are float32 parameters; their compute-dtype copies are
  kept (``recast``), as ``Linear`` keeps ``w_c``, so a tick does not re-read
  and re-cast every expert's weights.  The train route (``train=True``)
  casts the stacks on the call instead, inside the autograd graph.

The expert-parallel path (``MoE._apply_ep``) needs a device mesh, which the
port does not have yet; this module is the single-device path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import MoECfg
from repro_torch.nn import Linear
from repro_torch.nn.init import _truncated_standard
from repro_torch.nn.layers import _param


def capacity(n_tokens: int, mcfg: MoECfg) -> int:
    """Slots per expert for ``n_tokens`` tokens (reference ``moe.py:174``)."""
    nk = n_tokens * mcfg.top_k
    c = int(max(8, round(nk * mcfg.capacity_factor / mcfg.n_experts)))
    return min(c, nk)


def expert_counts(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Assignments per expert, (E,) int64.  A scatter-add of ones, not
    ``torch.bincount``, which reads the largest id back to the host on
    CUDA."""
    return torch.zeros(n_experts, dtype=torch.int64,
                       device=flat_e.device).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))


def top_k_first(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, ties to the lower
    index (``torch.topk`` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class MoE(nn.Module):
    def __init__(self, d_model: int, mcfg: MoECfg, *, dtype: torch.dtype,
                 param_dtype=torch.float32, generator=None, device=None):
        super().__init__()
        self.mcfg = mcfg
        self.dtype = dtype
        E, dff = mcfg.n_experts, mcfg.d_ff_expert
        std = (1.0 / d_model) ** 0.5

        def w(shape, scale):
            u = _truncated_standard(shape, -2.0, 2.0, generator, device)
            return _param((scale * u).to(param_dtype))

        # the router multiplies in float32 (the reference casts x to f32)
        self.router = Linear(d_model, E, dtype=torch.float32, use_bias=False,
                             param_dtype=param_dtype, generator=generator,
                             device=device)
        self.gate = w((E, d_model, dff), std)
        self.up = w((E, d_model, dff), std)
        self.down = w((E, dff, d_model), std * (dff / d_model) ** -0.5)
        for name in ("gate_c", "up_c", "down_c"):
            self.register_buffer(name, None, persistent=False)
        self.recast()

    def recast(self):
        """Refresh the compute-dtype copies of the expert stacks."""
        self.gate_c = self.gate.detach().to(self.dtype)
        self.up_c = self.up.detach().to(self.dtype)
        self.down_c = self.down.detach().to(self.dtype)

    def route(self, xf: torch.Tensor, *, train: bool = False):
        """xf: (N, d) → (top_p (N, K), top_e (N, K) int64, lb_loss,
        z_loss), the reference's ``_router``."""
        E, K = self.mcfg.n_experts, self.mcfg.top_k
        logits = self.router(xf.float(), train=train)              # (N, E)
        probs = torch.softmax(logits, dim=-1)
        top_p, top_e = top_k_first(probs, K)
        if self.mcfg.norm_topk:
            top_p = top_p / top_p.sum(dim=-1, keepdim=True)
        me = probs.mean(dim=0)
        # the mean over tokens of each token's one-hot expert count
        ce = expert_counts(top_e.reshape(-1), E).float() / xf.shape[0]
        lb_loss = E * (me * ce).sum() / K
        z_loss = torch.logsumexp(logits, dim=-1).square().mean()
        return top_p, top_e, lb_loss, z_loss

    def experts(self, train: bool = False):
        """The (gate, up, down) stacks in the compute dtype: the kept copies
        to serve, cast on the call (inside the graph) to train."""
        if train:
            return tuple(w.to(self.dtype) for w in
                         (self.gate, self.up, self.down))
        return self.gate_c, self.up_c, self.down_c

    def dispatch_compute_combine(self, xf, top_e, top_p, C: int, *,
                                 train: bool = False):
        """xf (N, d); top_e/top_p (N, K) → (y (N, d) in the compute dtype,
        dropped (N·K,) bool in assignment order, counts (E,))."""
        N, d = xf.shape
        E, K = self.mcfg.n_experts, self.mcfg.top_k
        NK = N * K
        flat_e = top_e.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        counts = expert_counts(flat_e, E)
        offsets = torch.cumsum(counts, dim=0) - counts             # (E,)
        ar = torch.arange(NK, device=xf.device)
        # slab: expert e's first C assignments, in sorted order
        slots = torch.arange(C, device=xf.device)
        slab_idx = (offsets[:, None] + slots[None, :]).clamp_(max=NK - 1)
        slab_valid = slots[None, :] < counts[:, None]               # (E, C)
        slab_tok = order[slab_idx] // K
        x_e = xf[slab_tok.reshape(-1)].reshape(E, C, d).to(self.dtype)
        x_e = x_e * slab_valid[..., None].to(x_e.dtype)
        gate, up, down = self.experts(train)
        h = F.silu(torch.bmm(x_e, gate)) * torch.bmm(x_e, up)
        y_e = torch.bmm(h, down).reshape(E * C, d)
        # each assignment's rank within its expert: its sorted position less
        # the expert's offset (the sort is undone by the inverse permutation)
        pos = torch.empty_like(order).scatter_(0, order, ar)
        rank = pos - offsets[flat_e]
        dropped = rank >= C
        src = flat_e * C + rank.clamp(max=C - 1)
        y = y_e[src] * (~dropped)[:, None].to(y_e.dtype)
        y = y * top_p.reshape(-1)[:, None].to(y.dtype)
        # each token's K rows summed in float32 in a fixed order: no atomics
        y = y.reshape(N, K, d).float().sum(dim=1).to(y.dtype)
        return y, dropped, counts

    def forward(self, x: torch.Tensor, *, train: bool = False):
        """x: (B, S, d) → (y (B, S, d) in x's dtype, aux) with aux =
        {"lb_loss", "z_loss", "expert_load" (E,), "drop_frac"}."""
        B, S, d = x.shape
        N, K = B * S, self.mcfg.top_k
        xf = x.reshape(N, d)
        top_p, top_e, lb_loss, z_loss = self.route(xf, train=train)
        y, dropped, counts = self.dispatch_compute_combine(
            xf, top_e, top_p, capacity(N, self.mcfg), train=train)
        nk = max(N * K, 1)
        aux = {"lb_loss": lb_loss, "z_loss": z_loss,
               "expert_load": counts.float() / nk,
               "drop_frac": dropped.float().sum() / nk}
        return y.reshape(B, S, d).to(x.dtype), aux
