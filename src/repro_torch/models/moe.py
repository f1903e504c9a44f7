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
  and re-cast every expert's weights (built under
  ``nn.layers.cast_on_call``, none is kept and each call casts).  The train
  route (``train=True``) casts the stacks on the call instead, inside the
  autograd graph.

Under a shard context whose mesh has a "model" axis that the experts divide
(and whose batch axes divide the batch), ``forward`` takes the reference's
expert-parallel path (``_apply_ep``): tokens split over the batch axes and
repeated over "model", each model rank routing its tokens and keeping the
assignments to its own contiguous experts (the rest go to a foreign
bucket), the same dispatch over its expert slab with the capacity of one
data shard's tokens, then one ``psum`` over "model".  It runs shard by
shard on the host thread (``sharding.shard_map``), in the train route too.
``forward_mesh`` is the train route over a mesh: the same EP body on the
positions' own activations and weight blocks, or, where the reference
takes the global path, the global path at every position over the batch
gathered whole.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.config import MoECfg
from repro_torch.nn import Linear
from repro_torch.nn.init import _truncated_standard
from repro_torch.nn.layers import _param, keeps_copy
from repro_torch.sharding import current_ctx, no_shard_ctx
from repro_torch.sharding import shard_map as sm


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
        self.keep_copy = keeps_copy(self.gate, self.dtype)
        self.recast()

    def recast(self):
        """Refresh the compute-dtype copies of the expert stacks (none under
        ``nn.layers.cast_on_call``)."""
        if self.keep_copy:
            self.gate_c = self.gate.detach().to(self.dtype)
            self.up_c = self.up.detach().to(self.dtype)
            self.down_c = self.down.detach().to(self.dtype)

    def route(self, xf: torch.Tensor, *, train: bool = False,
              router_w=None):
        """xf: (N, d) → (top_p (N, K), top_e (N, K) int64, lb_loss,
        z_loss), the reference's ``_router``.  ``router_w``: the router's
        weight placed on xf's device (a shard's copy), else the module's."""
        E, K = self.mcfg.n_experts, self.mcfg.top_k
        logits = (self.router(xf.float(), train=train) if router_w is None
                  else xf.float() @ router_w.float())               # (N, E)
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
        if train or self.gate_c is None:
            return tuple(w.to(self.dtype) for w in
                         (self.gate, self.up, self.down))
        return self.gate_c, self.up_c, self.down_c

    def dispatch_compute_combine(self, xf, top_e, top_p, C: int, *,
                                 train: bool = False, experts=None):
        """xf (N, d); top_e/top_p (N, K) → (y (N, d) in the compute dtype,
        dropped (N·K,) bool in assignment order, counts (n,)).  ``experts``:
        an (n, ·, ·) slab of the (gate, up, down) stacks (one model rank's),
        default all E; a bucket id of n in ``top_e`` is foreign: it takes no
        slot, adds nothing and is not counted as dropped."""
        N, d = xf.shape
        K = self.mcfg.top_k
        gate, up, down = experts if experts is not None else \
            self.experts(train)
        E = gate.shape[0]
        NK = N * K
        flat_e = top_e.reshape(-1)
        order = torch.argsort(flat_e, stable=True)
        counts_all = expert_counts(flat_e, E + 1)
        counts = counts_all[:E]
        offsets = torch.cumsum(counts_all, dim=0) - counts_all     # (E+1,)
        ar = torch.arange(NK, device=xf.device)
        # slab: expert e's first C assignments, in sorted order
        slots = torch.arange(C, device=xf.device)
        slab_idx = (offsets[:E, None] + slots[None, :]).clamp_(max=NK - 1)
        slab_valid = slots[None, :] < counts[:, None]               # (E, C)
        slab_tok = order[slab_idx] // K
        x_e = xf[slab_tok.reshape(-1)].reshape(E, C, d).to(self.dtype)
        x_e = x_e * slab_valid[..., None].to(x_e.dtype)
        h = F.silu(torch.bmm(x_e, gate)) * torch.bmm(x_e, up)
        y_e = torch.bmm(h, down).reshape(E * C, d)
        # each assignment's rank within its expert: its sorted position less
        # the expert's offset (the sort is undone by the inverse permutation)
        pos = torch.empty_like(order).scatter_(0, order, ar)
        rank = pos - offsets[flat_e]
        foreign = flat_e >= E
        dropped = (rank >= C) & ~foreign
        src = torch.where(foreign, 0, flat_e * C + rank.clamp(max=C - 1))
        y = y_e[src] * (~(dropped | foreign))[:, None].to(y_e.dtype)
        y = y * top_p.reshape(-1)[:, None].to(y.dtype)
        # each token's K rows summed in float32 in a fixed order: no atomics
        y = y.reshape(N, K, d).float().sum(dim=1).to(y.dtype)
        return y, dropped, counts

    def forward(self, x: torch.Tensor, *, train: bool = False):
        """x: (B, S, d) → (y (B, S, d) in x's dtype, aux) with aux =
        {"lb_loss", "z_loss", "expert_load" (E,), "drop_frac"}.  The
        expert-parallel path where the reference takes it, else the global
        one."""
        ep = self._ep_ctx(x.shape[0])
        if ep is not None:
            return self._apply_ep(x, *ep, train=train)
        return self._apply_global(x, train=train)

    def _apply_global(self, x: torch.Tensor, *, train: bool = False,
                      router_w=None, experts=None):
        """The reference's global path: one dispatch over every token.
        ``router_w``/``experts``: given weights (a mesh position's) in place
        of the module's."""
        B, S, d = x.shape
        N, K = B * S, self.mcfg.top_k
        xf = x.reshape(N, d)
        top_p, top_e, lb_loss, z_loss = self.route(xf, train=train,
                                                   router_w=router_w)
        y, dropped, counts = self.dispatch_compute_combine(
            xf, top_e, top_p, capacity(N, self.mcfg), train=train,
            experts=experts)
        nk = max(N * K, 1)
        aux = {"lb_loss": lb_loss, "z_loss": z_loss,
               "expert_load": counts.float() / nk,
               "drop_frac": dropped.float().sum() / nk}
        return y.reshape(B, S, d).to(x.dtype), aux

    # ------------------------------------------------------------------
    # expert-parallel path (the reference's ``_apply_ep``)
    # ------------------------------------------------------------------

    def _ep_ctx(self, B: int):
        """→ (mesh, batch_axes) when the EP path applies (a shard context,
        "model" > 1 dividing the experts, the batch axes dividing B), else
        None (the reference's test, ``moe.py:81-91``)."""
        ctx = current_ctx()
        if ctx is None:
            return None
        _, mesh = ctx
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        m = sizes.get("model", 1)
        batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
        if (m > 1 and self.mcfg.n_experts % m == 0
                and B % max(sm.axis_size(mesh, batch_axes), 1) == 0):
            return mesh, batch_axes
        return None

    def _apply_ep(self, x, mesh, batch_axes, *, train: bool = False):
        """Experts split over "model", tokens over the batch axes and
        repeated over "model": each rank's dispatch is local, and one psum
        over "model" combines the experts' outputs.  Capacity is per (data
        shard × expert): C from one data shard's N_loc tokens."""
        row = sm.canonical((batch_axes,))
        router_w = sm.split(self.router.w if train else self.router.w_c, (),
                            mesh)
        slabs = [sm.split(w, ("model",), mesh) for w in self.experts(train)]
        y, aux = self._ep_body(sm.split(x, row, mesh), router_w, slabs, mesh,
                               batch_axes, train=train)
        return (sm.join(y, row, mesh, x.device).to(x.dtype),
                {k: v.to(x.device) for k, v in aux.items()})

    def _ep_body(self, xs, router_w, slabs, mesh, batch_axes, *,
                 train: bool = False):
        """The EP body over per-position tokens ``xs`` {position: (B_loc, S,
        d)}, the whole router at each position and each position's expert
        slabs → ({position: y (B_loc, S, d)}, the first position's aux)."""
        mcfg = self.mcfg
        K = mcfg.top_k
        B_loc, S, d = next(iter(xs.values())).shape
        E_loc = mcfg.n_experts // sm.axis_size(mesh, "model")
        bsh = max(sm.axis_size(mesh, batch_axes), 1)
        N_loc = B_loc * S
        C = capacity(N_loc, mcfg)
        y, lb, z, load, n_drop = {}, {}, {}, {}, {}
        with no_shard_ctx():
            for pos in sm.positions(mesh):
                xf = xs[pos].reshape(-1, d)
                top_p, top_e, lb[pos], z[pos] = self.route(
                    xf, train=train, router_w=router_w[pos])
                first = sm.axis_index(mesh, pos, "model") * E_loc
                mine = (top_e >= first) & (top_e < first + E_loc)
                local = torch.where(mine, top_e - first, E_loc)
                y[pos], dropped, counts = self.dispatch_compute_combine(
                    xf, local, top_p, C, train=train,
                    experts=tuple(w[pos] for w in slabs))
                load[pos], n_drop[pos] = counts.float(), dropped.float().sum()
            y = sm.psum(y, "model", mesh)
            if batch_axes:
                lb = sm.pmean(lb, batch_axes, mesh)
                z = sm.pmean(z, batch_axes, mesh)
                load = sm.psum(load, batch_axes, mesh)
                n_drop = sm.psum(n_drop, batch_axes, mesh)
            load = sm.all_gather(load, "model", mesh)
            n_drop = sm.psum(n_drop, "model", mesh)
        nk = N_loc * K * bsh
        first = sm.positions(mesh)[0]
        aux = {"lb_loss": lb[first], "z_loss": z[first],
               "expert_load": load[first] / nk,
               "drop_frac": n_drop[first] / nk}
        return {p: t.reshape(B_loc, S, d) for p, t in y.items()}, aux

    def forward_mesh(self, w, xs, batch_axes):
        """The layer over the shard context's mesh, the train route's and
        the serve route's: ``w`` the layer's parameters as
        ``steps.MeshParams`` gives them, ``xs`` {position: (B_loc, S, d)}
        split over ``batch_axes`` → ({position: y}, the first position's
        aux).  The EP body where the reference takes it (``_ep_ctx``); else
        every position runs the global path over the batch gathered whole
        and keeps its own rows.  The expert stacks are read in the compute
        dtype."""
        mesh = w.mesh
        router = w("router.w", ())
        B_loc = next(iter(xs.values())).shape[0]
        ep = self._ep_ctx(B_loc * sm.axis_size(mesh, batch_axes))
        cast = lambda vals: {p: t.to(self.dtype) for p, t in vals.items()}
        if ep is not None:
            slabs = [cast(w(n)) for n in ("gate", "up", "down")]
            y, aux = self._ep_body(xs, router, slabs, mesh, ep[1],
                                   train=True)
            return {p: t.to(xs[p].dtype) for p, t in y.items()}, aux
        stacks = [cast(w(n, ())) for n in ("gate", "up", "down")]
        whole = sm.all_gather(xs, batch_axes, mesh) if batch_axes else xs
        y, aux = {}, {}
        with no_shard_ctx():
            for pos, x in whole.items():
                out, aux[pos] = self._apply_global(
                    x, train=True, router_w=router[pos],
                    experts=tuple(t[pos] for t in stacks))
                r = sm.axis_index(mesh, pos, batch_axes)
                y[pos] = out[r * B_loc:(r + 1) * B_loc]
        return y, aux[sm.positions(mesh)[0]]
