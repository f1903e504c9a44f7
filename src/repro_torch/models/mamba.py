"""State-space blocks: Mamba1 (falcon-mamba) and Mamba2 / SSD (the zamba2
backbone), the port of ``repro.models.mamba``.

``Mamba2.forward`` runs the full sequence through ``kops.ssm_scan``: K7 on
the card, the sequential recurrence on the CPU (the tensor's device
decides, not ``cfg.use_pallas``).  With ``return_state`` it also returns the
decode state after the last token — the scan's carried ``h`` and the last
``d_conv - 1`` conv inputs — where the reference recomputes ``h`` with a
second sequential scan (``LM._mamba2_final_state``).

``Mamba1.forward`` runs ``selective_scan``, the reference's ``lax.scan``
over the tokens (the JAX package has no kernel for it), and returns ``y``
and the final state from one pass where the reference scans twice
(``Mamba1.apply``, ``LM._mamba1_final_state``).

``decode`` is the one-token recurrence of either and writes the new state
into the cache leaves it is given, in place.

``forward(..., train=True)`` is the train route, which autograd can
differentiate: Mamba2 takes the plain sequential scan
(``kernels.ref.ssm_scan_ref``) on either device, Mamba1 the out-of-place
recurrence ``selective_scan_train`` (the serve scan writes its states in
place), and the projections cast their weights inside the graph.

``forward_mesh`` is the train route over a mesh, shard by shard, where the
rules split "d_inner" over "model".  The fused ``in_proj`` columns (and
Mamba2's conv channels) lie over "model" in contiguous blocks that do not
line up with the channels a rank scans, so each rank gathers those two
leaves whole and takes its own columns: Mamba1 is channel-parallel (rank r
scans channels [r·di/m, (r+1)·di/m); ``x_proj`` contracts over them, so a
``psum`` over "model" gives dt, B and C), Mamba2 head-parallel (rank r
scans heads [r·H/m, (r+1)·H/m) and reads every B/C group they use; the
gated norm runs over the whole ``d_inner``, its sum of squares psummed
over "model").  ``out_proj`` rows end in a ``psum`` in both.  Where the
layout does not split the channels (or the heads) over "model", each
position runs the whole block.

``prefill_mesh`` and ``decode_mesh`` are the serve route over a mesh (the
serve steps over laid-out weights), with the same ranks.  There the fused
``in_proj`` moves whichever is fewer bytes (``project_columns``): the
weight gathered whole, as the train route does, or each rank's product
with the columns it holds, gathered — a decode step's few rows, where the
weight would cost d_model x its width every token.  Mamba1's states split
"d_inner" as its ranks do.  Mamba2's do not follow the heads: ``h`` is
replicated over "model" and ``conv`` splits its ``di + 2·G·N`` channels in
blocks that cross the heads' and the x|B|C boundaries.  Its prefill runs
K7 on the rank's heads and all-gathers their final states; its decode
convolves the rank's block of the conv channels, all-gathers the outputs,
updates the rank's heads and all-gathers the new heads into the
replicated ``h`` (the reference's per-device program does the same), each
rank multiplying its rows of ``out_proj``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.nn import Conv1D, Linear, RMSNorm
from repro_torch.nn.layers import _param, conv1d_nlc
from repro_torch.sharding import shard_map as sm


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0) everywhere (``F.softplus``
    switches to the identity above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def selective_scan(x, dt, A, Bm, C):
    """Mamba1's selective scan: h_t = exp(dt_t ⊗ A) · h_{t-1} + (dt_t · x_t)
    ⊗ B_t from h = 0, y_t = h_t · C_t, all float32.  x, dt: (B, L, di);
    A: (di, N); Bm, C: (B, L, N) → (y (B, L, di), h_L (B, di, N)).

    Only the recurrence is a loop: the decays and input terms of every step
    are computed at once, ``(B, L, di, N)`` each, and step t is one
    multiply-add that writes h_t over its input term; y is one batched
    product over all the states afterwards."""
    L = x.shape[1]
    decay = torch.exp(dt[..., None] * A)
    hs = (dt * x)[..., None] * Bm[:, :, None, :]
    for t in range(1, L):
        hs[:, t].addcmul_(decay[:, t], hs[:, t - 1])
    y = torch.einsum("bldn,bln->bld", hs, C)
    # a copy: a view would keep every layer's (B, L, di, N) buffer alive
    # until the prefill's states are stacked
    return y, hs[:, -1].clone()


def selective_scan_train(x, dt, A, Bm, C):
    """``selective_scan``'s recurrence out of place, step by step as the
    reference's ``lax.scan`` body writes it, so that autograd can
    differentiate it → (y (B, L, di), h_L (B, di, N))."""
    Bsz, L, di = x.shape
    h = torch.zeros(Bsz, di, A.shape[-1], dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(L):
        decay = torch.exp(dt[:, t, :, None] * A[None])
        h = decay * h + (dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C[:, t]))
    return torch.stack(ys, dim=1), h


def _model_ranks(mesh, split: bool) -> dict:
    """{position: its rank over "model"} when ``split``, else every
    position rank 0 of 1: the whole block on each."""
    return {p: sm.axis_index(mesh, p, "model") if split else 0
            for p in sm.positions(mesh)}


ALL = slice(None)


def project_columns(w, name, xs, picks, dtype):
    """{position: [x[:, rows] @ W[:, cols] for (rows, cols) in
    picks[position]]} in ``dtype``, for the (d, width) leaf ``name`` whose
    columns lie over "model" in blocks that are not the columns a rank
    reads (the fused ``in_proj``).  It moves the fewer bytes of two: the
    weight all-gathered whole, each rank then multiplying its columns
    alone, or each rank's product with the block of columns it holds,
    all-gathered over their axes, each rank then slicing the product."""
    mesh = w.mesh
    axes = w.axes(name, 1)
    weight = w.struct(name)
    x0 = next(iter(xs.values()))
    gather_weight = (x0.shape[0] * x0.shape[1] * dtype.itemsize
                     >= weight.shape[0] * weight.dtype.itemsize)
    if gather_weight or sm.axis_size(mesh, axes) == 1:
        whole = w(name, keep=())
        return {p: [x[:, rows].to(dtype) @ whole[p][:, cols].to(dtype)
                    for rows, cols in picks[p]] for p, x in xs.items()}
    own = w(name, keep=axes)
    full = sm.all_gather({p: x.to(dtype) @ own[p].to(dtype)
                          for p, x in xs.items()}, axes, mesh, dim=2)
    return {p: [full[p][:, rows, cols] for rows, cols in picks[p]]
            for p in xs}


def _write_states(state: dict, new: dict):
    """Each position's new state blocks into the cache's, in place, after
    every position has read the old ones (positions may share a block)."""
    for pos, blocks in new.items():
        for n, t in blocks.items():
            state[n].blocks[pos].copy_(t)


class Mamba1(nn.Module):
    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        di, N, R = cfg.d_inner, cfg.ssm.d_state, cfg.dt_rank
        pd, cd = cfg.pdtype, cfg.cdtype
        kw = dict(param_dtype=pd, generator=generator, device=device)
        self.in_proj = Linear(cfg.d_model, 2 * di, dtype=cd, use_bias=False,
                              **kw)
        self.conv = Conv1D(di, di, cfg.ssm.d_conv, groups=di, **kw)
        self.x_proj = Linear(di, R + 2 * N, dtype=cd, use_bias=False, **kw)
        # the reference hands dt_proj float32 inputs and no dtype: float32
        self.dt_proj = Linear(R, di, dtype=torch.float32, **kw)
        self.A_log = _param(torch.log(torch.arange(
            1, N + 1, dtype=torch.float32, device=device)).expand(
            di, N).to(pd).contiguous())
        self.D = _param(torch.ones(di, device=device, dtype=pd))
        self.out_proj = Linear(di, cfg.d_model, dtype=cd, use_bias=False,
                               **kw)

    def _dbc(self, x_conv, train: bool = False):
        """x_conv (..., di) → dt (..., di), B, C (..., N), all float32."""
        N, R = self.cfg.ssm.d_state, self.cfg.dt_rank
        dt_r, Bc, Cc = torch.split(self.x_proj(x_conv, train=train).float(),
                                   [R, N, N], dim=-1)
        return softplus(self.dt_proj(dt_r, train=train)), Bc, Cc

    def _out(self, y, xf, z, train: bool = False):
        """y (..., di) float32 → out_proj((y + x·D) * silu(z))."""
        y = y + xf * self.D.float()
        return self.out_proj(y.to(self.cfg.cdtype) * F.silu(z), train=train)

    def forward(self, x, *, return_state: bool = False, train: bool = False):
        """x: (B, L, d) → (B, L, d) [, {"h": (B, di, N) float32, "conv":
        (B, min(L, k-1), di)}]."""
        cfg = self.cfg
        x_in, z = self.in_proj(x, train=train).chunk(2, dim=-1)
        x_conv = F.silu(self.conv(x_in, causal=True, dtype=cfg.cdtype))
        dt, Bc, Cc = self._dbc(x_conv, train)
        A = -torch.exp(self.A_log.float())                       # (di, N)
        xf = x_conv.float()
        scan = selective_scan_train if train else selective_scan
        y, h_last = scan(xf, dt, A, Bc, Cc)
        out = self._out(y, xf, z, train)
        if return_state:
            # the conv inputs' tail as the reference slices it: shorter
            # than k-1 rows after a shorter prompt (ROADMAP §3)
            return out, {"h": h_last,
                         "conv": x_in[:, -(cfg.ssm.d_conv - 1):].clone()}
        return out

    @staticmethod
    def _dbc_part(x_conv, x_w):
        """A rank's partial of ``x_proj`` (dt, B and C before the psum over
        "model"), in float32: the psum's sum is rounded to the compute
        dtype once, as one device's ``x_proj`` rounds it, where rounding
        each rank's partial first would carry through exp(dt·A) into every
        later token's state."""
        return x_conv.float() @ x_w.float()

    def forward_mesh(self, w, xs):
        """The train route over a mesh, channel-parallel over "model" where
        the layout splits "d_inner" (module docstring).  ``w``: the block's
        parameters as ``steps.MeshParams`` gives them; ``xs`` {position:
        (B_loc, L, d)}, replicated over "model" → {position: (B_loc, L,
        d)}."""
        return self._channels_mesh(w, xs, train=True)[0]

    def _layout(self, w):
        """(split, {position: its rank}, c channels a rank): channel-
        parallel over "model" where the layout splits "d_inner"."""
        split = "model" in w.axes("out_proj.w", 0)
        return split, _model_ranks(w.mesh, split), self.cfg.d_inner // (
            sm.axis_size(w.mesh, "model") if split else 1)

    def _channels_mesh(self, w, xs, *, train: bool):
        """The channel-parallel body over a prompt: ``forward_mesh`` (the
        train route) or, with ``train`` False, the serve scan → ({position:
        (B_loc, L, d)}, {position: (h_L (B_loc, c, N), the conv inputs'
        tail (B_loc, min(L, k-1), c))} or None)."""
        cfg = self.cfg
        cd, di, k = cfg.cdtype, cfg.d_inner, cfg.ssm.d_conv
        N, R = cfg.ssm.d_state, cfg.dt_rank
        split, rank, c = self._layout(w)
        xz = project_columns(w, "in_proj.w", xs, {
            p: [(ALL, slice(r * c, (r + 1) * c)),
                (ALL, slice(di + r * c, di + (r + 1) * c))]
            for p, r in rank.items()}, cd)
        conv_w, conv_b, x_w = w("conv.w"), w("conv.b"), w("x_proj.w")
        dbc, kept = {}, {}
        for pos in xs:
            x_in, z = xz[pos]
            x_conv = F.silu(conv1d_nlc(x_in, conv_w[pos].to(cd),
                                       conv_b[pos], groups=c, causal=True))
            dbc[pos] = self._dbc_part(x_conv, x_w[pos])
            kept[pos] = (x_in, x_conv, z)
        if split:
            dbc = sm.psum(dbc, "model", w.mesh)
        dt_w, dt_b, A_log, D = (w(n) for n in ("dt_proj.w", "dt_proj.b",
                                               "A_log", "D"))
        out_w = w("out_proj.w")
        part, states = {}, {}
        for pos, (x_in, x_conv, z) in kept.items():
            dt_r, Bc, Cc = torch.split(dbc[pos].to(cd).float(), [R, N, N],
                                       dim=-1)
            dt = softplus(dt_r @ dt_w[pos].float() + dt_b[pos].float())
            A = -torch.exp(A_log[pos].float())                  # (c, N)
            xf = x_conv.float()
            scan = selective_scan_train if train else selective_scan
            y, h_last = scan(xf, dt, A, Bc, Cc)
            y = y + xf * D[pos].float()
            part[pos] = (y.to(cd) * F.silu(z)) @ out_w[pos].to(cd)
            if not train:
                states[pos] = (h_last, x_in[:, -(k - 1):].clone())
        part = sm.psum(part, "model", w.mesh) if split else part
        return part, (None if train else states)

    def prefill_mesh(self, w, xs, batch_axes, specs):
        """A prompt over a mesh on the serve route, channel-parallel as
        ``forward_mesh`` (``selective_scan``): ``xs`` {position: (B_loc,
        L, d)}, the batch split over ``batch_axes`` → ({position: (B_loc,
        L, d)}, {"h", "conv"}: {position: its block of the layer's state
        under ``specs``}).  A rank's final state and conv tail are its
        channels', the blocks "d_inner" gives it over "model"."""
        split = self._layout(w)[0]
        part, states = self._channels_mesh(w, xs, train=False)
        ch = "model" if split else None
        return part, {
            "h": sm.relayout({p: s[0] for p, s in states.items()},
                             (batch_axes, ch), specs["h"], w.mesh),
            "conv": sm.relayout({p: s[1] for p, s in states.items()},
                                (batch_axes, None, ch), specs["conv"],
                                w.mesh)}

    def decode(self, x, state):
        """x: (B, 1, d); state {"h": (B, di, N) float32, "conv": (B, k-1,
        di)}, both written in place → (y, state)."""
        x_in, z = self.in_proj(x).chunk(2, dim=-1)               # (B, 1, di)
        window = torch.cat([state["conv"], x_in], dim=1)         # (B, k, di)
        w = self.conv.w.to(x_in.dtype)                           # (k, 1, di)
        xc = (window * w.transpose(0, 1)).sum(dim=1, keepdim=True)
        if self.conv.b is not None:
            xc = xc + self.conv.b.to(xc.dtype)
        x_conv = F.silu(xc)
        dt, Bc, Cc = self._dbc(x_conv)
        A = -torch.exp(self.A_log.float())
        dt_t, x_t = dt[:, 0], x_conv[:, 0].float()
        h = (torch.exp(dt_t[..., None] * A[None]) * state["h"]
             + (dt_t * x_t)[..., None] * Bc[:, 0][:, None, :])
        y = torch.einsum("bdn,bn->bd", h, Cc[:, 0])
        out = self._out(y[:, None], x_t[:, None], z)
        # the new state is complete before the old one is overwritten
        state["h"].copy_(h)
        state["conv"].copy_(window[:, 1:])
        return out, state

    def decode_mesh(self, w, xs, state):
        """One token over a mesh, channel-parallel: ``xs`` {position:
        (B_loc, 1, d)}; ``state`` {"h", "conv"}: ``ShardedArray`` laid out
        by ``cache_axes`` (each position's block its rank's channels),
        written in place → {position: (B_loc, 1, d)}."""
        cfg = self.cfg
        cd, di = cfg.cdtype, cfg.d_inner
        N, R = cfg.ssm.d_state, cfg.dt_rank
        mesh = w.mesh
        split, rank, c = self._layout(w)
        xz = project_columns(w, "in_proj.w", xs, {
            p: [(ALL, slice(r * c, (r + 1) * c)),
                (ALL, slice(di + r * c, di + (r + 1) * c))]
            for p, r in rank.items()}, cd)
        conv_w, conv_b, x_w = w("conv.w"), w("conv.b"), w("x_proj.w")
        dbc, kept = {}, {}
        for pos in xs:
            x_in, z = xz[pos]
            window = torch.cat([state["conv"].blocks[pos], x_in], dim=1)
            cw = conv_w[pos].to(x_in.dtype)                  # (k, 1, c)
            xc = (window * cw.transpose(0, 1)).sum(dim=1, keepdim=True)
            x_conv = F.silu(xc + conv_b[pos].to(xc.dtype))
            dbc[pos] = self._dbc_part(x_conv, x_w[pos])
            kept[pos] = (window, x_conv, z)
        if split:
            dbc = sm.psum(dbc, "model", mesh)
        dt_w, dt_b, A_log, D = (w(n) for n in ("dt_proj.w", "dt_proj.b",
                                               "A_log", "D"))
        out_w = w("out_proj.w")
        part, new = {}, {}
        for pos, (window, x_conv, z) in kept.items():
            dt_r, Bc, Cc = torch.split(dbc[pos][:, 0].to(cd).float(),
                                       [R, N, N], dim=-1)
            dt = softplus(dt_r @ dt_w[pos].float() + dt_b[pos].float())
            A = -torch.exp(A_log[pos].float())
            x_t = x_conv[:, 0].float()
            h = (torch.exp(dt[..., None] * A[None]) * state["h"].blocks[pos]
                 + (dt * x_t)[..., None] * Bc[:, None, :])
            y = torch.einsum("bdn,bn->bd", h, Cc) + x_t * D[pos].float()
            part[pos] = ((y[:, None].to(cd) * F.silu(z))
                         @ out_w[pos].to(cd))
            new[pos] = {"h": h, "conv": window[:, 1:]}
        _write_states(state, new)
        return sm.psum(part, "model", mesh) if split else part

    @staticmethod
    def state_shape(cfg, batch: int):
        di, N, k = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
        return {
            "h": ((batch, di, N), torch.float32, ("batch", "d_inner", None)),
            "conv": ((batch, k - 1, di), cfg.cdtype,
                     ("batch", None, "d_inner")),
        }


class Mamba2(nn.Module):
    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        di, N = cfg.d_inner, cfg.ssm.d_state
        H, G, k = cfg.ssm_heads, cfg.ssm.n_groups, cfg.ssm.d_conv
        conv_ch = di + 2 * G * N
        pd = cfg.pdtype
        kw = dict(generator=generator, device=device)
        self.in_proj = Linear(cfg.d_model, 2 * di + 2 * G * N + H,
                              dtype=cfg.cdtype, use_bias=False,
                              param_dtype=pd, **kw)
        self.conv = Conv1D(conv_ch, conv_ch, k, param_dtype=pd,
                           groups=conv_ch, **kw)
        self.A_log = _param(torch.log(torch.linspace(
            1.0, 16.0, H, device=device)).to(pd))
        self.dt_bias = _param(torch.zeros(H, device=device, dtype=pd))
        self.D = _param(torch.ones(H, device=device, dtype=pd))
        # the reference applies this norm with RMSNorm's default eps
        self.norm = RMSNorm(di, param_dtype=pd, device=device)
        self.out_proj = Linear(di, cfg.d_model, dtype=cfg.cdtype,
                               use_bias=False, param_dtype=pd, **kw)

    def _split(self, zxbcdt):
        """→ z, x, B, C, dt along the last axis, in that order."""
        cfg = self.cfg
        di, GN = cfg.d_inner, cfg.ssm.n_groups * cfg.ssm.d_state
        return torch.split(zxbcdt, [di, di, GN, GN, cfg.ssm_heads], dim=-1)

    def _heads(self, t, n_lead):
        """(..., G*N) → (..., H, N) float32: each B/C group serves H/G
        consecutive heads (``jnp.repeat``, not a tile).  One group is a view
        with a head stride of 0, not a copy per head."""
        cfg = self.cfg
        G, N = cfg.ssm.n_groups, cfg.ssm.d_state
        g = t.reshape(*t.shape[:n_lead], G, N).float()
        if G == 1:
            return g.expand(*g.shape[:n_lead], cfg.ssm_heads, N)
        return g.repeat_interleave(cfg.ssm_heads // G, dim=n_lead)

    def _gate_out(self, y, z, train: bool = False):
        """y (..., di) float32 → out_proj(norm(y * silu(z)))."""
        y = y.to(self.cfg.cdtype)
        return self.out_proj(self.norm(y * F.silu(z)), train=train)

    def forward(self, x, *, return_state: bool = False, train: bool = False):
        """x: (B, L, d) → (B, L, d) [, {"h": (B, H, hd, N) float32,
        "conv": (B, min(L, k-1), conv_ch)}]."""
        cfg = self.cfg
        Bsz, L, _ = x.shape
        di, GN = cfg.d_inner, cfg.ssm.n_groups * cfg.ssm.d_state
        H, hd, k = cfg.ssm_heads, cfg.ssm.headdim, cfg.ssm.d_conv
        z, xs, Bc, Cc, dt = self._split(self.in_proj(x, train=train))
        conv_in = torch.cat([xs, Bc, Cc], dim=-1)
        conv_out = F.silu(self.conv(conv_in, causal=True, dtype=cfg.cdtype))
        xs, Bc, Cc = torch.split(conv_out, [di, GN, GN], dim=-1)
        dt = softplus(dt.float() + self.dt_bias.float())        # (B, L, H)
        A = -torch.exp(self.A_log.float())                       # (H,)
        xh = xs.reshape(Bsz, L, H, hd).float()
        Bh, Ch = self._heads(Bc, 2), self._heads(Cc, 2)
        if train:
            out = kref.ssm_scan_ref(xh, dt, A, Bh, Ch,
                                    return_state=return_state)
        else:
            out = kops.ssm_scan(xh, dt, A, Bh, Ch, chunk=cfg.ssm.chunk,
                                return_state=return_state)
        y, h_last = out if return_state else (out, None)
        y = y + xh * self.D.float()[None, None, :, None]
        y = self._gate_out(y.reshape(Bsz, L, di), z, train)
        if return_state:
            return y, {"h": h_last, "conv": conv_in[:, -(k - 1):]}
        return y

    def forward_mesh(self, w, xs):
        """The train route over a mesh, head-parallel over "model" where
        the heads divide it and the layout splits "d_inner" (module
        docstring).  ``w``: the block's parameters as ``steps.MeshParams``
        gives them; ``xs`` {position: (B_loc, L, d)}, replicated over
        "model" → {position: (B_loc, L, d)}."""
        return self._heads_mesh(w, xs, train=True)[0]

    def _layout(self, w):
        """(split, {position: its rank}, n heads a rank): head-parallel
        over "model" where the heads divide it and the layout splits
        "d_inner"."""
        H = self.cfg.ssm_heads
        split = ("model" in w.axes("out_proj.w", 0)
                 and "model" in w.axes("norm.scale", 0)
                 and H % sm.axis_size(w.mesh, "model") == 0)
        return split, _model_ranks(w.mesh, split), H // (
            sm.axis_size(w.mesh, "model") if split else 1)

    def _heads_mesh(self, w, xs, *, train: bool):
        """The head-parallel body over a prompt: ``forward_mesh`` (the
        train route, the plain scan) or, with ``train`` False, the serve
        route (K7 on the rank's heads) → ({position: (B_loc, L, d)},
        {position: (h_L (B_loc, n, hd, N), the conv inputs' tail (B_loc,
        min(L, k-1), conv_ch), every channel)} or None)."""
        cfg = self.cfg
        cd, di, N = cfg.cdtype, cfg.d_inner, cfg.ssm.d_state
        H, hd, G = cfg.ssm_heads, cfg.ssm.headdim, cfg.ssm.n_groups
        GN, per = G * N, H // G             # heads a B/C group serves
        k = cfg.ssm.d_conv
        split, rank, n = self._layout(w)
        c = n * hd
        keep = ("model",) if split else ()
        picks, groups = {}, {}
        for pos, r in rank.items():
            h0 = r * n
            g0, g1 = h0 // per, (h0 + n - 1) // per + 1   # groups read
            groups[pos] = (h0, g0, g1)
            # the rank's channels of x and z, its groups of B and C, its
            # heads of dt, in in_proj's columns [z | x | B | C | dt]
            picks[pos] = [
                (ALL, slice(r * c, (r + 1) * c)),
                (ALL, slice(di + r * c, di + (r + 1) * c)),
                (ALL, slice(2 * di + g0 * N, 2 * di + g1 * N)),
                (ALL, slice(2 * di + GN + g0 * N, 2 * di + GN + g1 * N)),
                (ALL, slice(2 * di + 2 * GN + h0, 2 * di + 2 * GN + h0 + n))]
            if not train:       # the conv inputs' tail, every channel
                picks[pos].append((slice(-(k - 1), None),
                                   slice(di, 2 * di + 2 * GN)))
        proj = project_columns(w, "in_proj.w", xs, picks, cd)
        conv_w, conv_b = (w(k_, keep=()) for k_ in ("conv.w", "conv.b"))
        A_log, dt_bias, D = w("A_log"), w("dt_bias"), w("D")
        ss, kept, states = {}, {}, {}
        for pos, x in xs.items():
            h0, g0, g1 = groups[pos]
            z, xs_, Bc, Cc, dt, *tail = proj[pos]
            # the conv's channels are [x | B | C]: in_proj's less di
            ch = [slice(s_.start - di, s_.stop - di)
                  for _, s_ in picks[pos][1:4]]
            cw = torch.cat([conv_w[pos][..., s_] for s_ in ch], dim=-1)
            cb = torch.cat([conv_b[pos][s_] for s_ in ch])
            conv_out = F.silu(conv1d_nlc(torch.cat([xs_, Bc, Cc], dim=-1),
                                         cw.to(cd), cb, groups=cw.shape[-1],
                                         causal=True))
            gn = (g1 - g0) * N
            xs_, Bc, Cc = torch.split(conv_out, [c, gn, gn], dim=-1)
            heads = slice(h0, h0 + n)
            dt = softplus(dt.float() + dt_bias[pos][heads].float())
            A = -torch.exp(A_log[pos][heads].float())
            Bsz, L = x.shape[:2]
            xh = xs_.reshape(Bsz, L, n, hd).float()
            Bh, Ch = (self._rank_heads(t, h0, n, g0) for t in (Bc, Cc))
            if train:
                y = kref.ssm_scan_ref(xh, dt, A, Bh, Ch)
            else:
                y, h_last = kops.ssm_scan(xh, dt, A, Bh, Ch,
                                          chunk=cfg.ssm.chunk,
                                          return_state=True)
                states[pos] = (h_last, tail[0])
            y = y + xh * D[pos][heads].float()[None, None, :, None]
            # the gated norm, in RMSNorm's dtype order, over all of d_inner
            u = y.reshape(Bsz, L, c).to(cd) * F.silu(z)
            uf = u.float()
            ss[pos] = uf.square().sum(dim=-1, keepdim=True)
            kept[pos] = uf
        if split:
            ss = sm.psum(ss, "model", w.mesh)
        scale, out_w = w("norm.scale", keep), w("out_proj.w", keep)
        part = {}
        for pos, uf in kept.items():
            y = uf * torch.rsqrt(ss[pos] / di + self.norm.eps)
            part[pos] = (y * scale[pos].float()).to(cd) @ out_w[pos].to(cd)
        part = sm.psum(part, "model", w.mesh) if split else part
        return part, (None if train else states)

    def prefill_mesh(self, w, xs, batch_axes, specs):
        """A prompt over a mesh on the serve route, head-parallel as
        ``forward_mesh`` with K7 (``kops.ssm_scan``) on each rank's heads:
        ``xs`` {position: (B_loc, L, d)}, the batch split over
        ``batch_axes`` → ({position: (B_loc, L, d)}, {"h", "conv"}:
        {position: its block of the layer's state under ``specs``}).  The
        ranks' final states are all-gathered over "model" (``h`` is
        replicated there); every rank holds every channel of the conv
        inputs' tail and keeps its block."""
        split = self._layout(w)[0]
        part, states = self._heads_mesh(w, xs, train=False)
        return part, {
            "h": sm.relayout({p: s[0] for p, s in states.items()},
                             (batch_axes, "model" if split else None),
                             specs["h"], w.mesh),
            "conv": sm.relayout({p: s[1] for p, s in states.items()},
                                (batch_axes,), specs["conv"], w.mesh)}

    def decode_mesh(self, w, xs, state):
        """One token over a mesh (module docstring): ``xs`` {position:
        (B_loc, 1, d)}; ``state`` {"h", "conv"}: ``ShardedArray`` laid out
        by ``cache_axes`` (``h`` split over the batch alone, ``conv`` its
        channels over "d_inner"'s axes too), written in place → {position:
        (B_loc, 1, d)}.  Each rank holds the whole ``in_proj`` product
        (``project_columns``), convolves its block of the conv channels and
        all-gathers the outputs.  Head-parallel (``_layout``), each rank
        updates its own heads of ``h``, runs the gated norm over all of
        ``d_inner`` (its sum of squares psummed over "model") and
        multiplies its rows of ``out_proj``; the new heads are all-gathered
        over "model" into the replicated ``h``, as the reference's
        per-device program gathers them.  Otherwise every position updates
        every head."""
        cfg = self.cfg
        cd, di = cfg.cdtype, cfg.d_inner
        GN = cfg.ssm.n_groups * cfg.ssm.d_state
        hd = cfg.ssm.headdim
        mesh = w.mesh
        split, rank, n = self._layout(w)
        c = n * hd
        cspec = state["conv"].spec
        ch_axes = sm.axes_of(cspec[2] if len(cspec) > 2 else None)
        cb = (di + 2 * GN) // sm.axis_size(mesh, ch_axes)
        proj = project_columns(w, "in_proj.w", xs,
                               {p: [(ALL, ALL)] for p in xs}, cd)
        conv_w, conv_b = (w(k_, keep=()) for k_ in ("conv.w", "conv.b"))
        outs, kept, new = {}, {}, {}
        for pos in xs:
            z, xs_, Bc, Cc, dt = self._split(proj[pos][0])
            blk = slice(sm.axis_index(mesh, pos, ch_axes) * cb,
                        (sm.axis_index(mesh, pos, ch_axes) + 1) * cb)
            conv_in = torch.cat([xs_, Bc, Cc], dim=-1)[..., blk]
            window = torch.cat([state["conv"].blocks[pos], conv_in], dim=1)
            outs[pos] = self._conv_step(window, conv_w[pos][..., blk].to(cd),
                                        conv_b[pos][blk])
            kept[pos] = (z, dt)
            new[pos] = {"conv": window[:, 1:]}
        if sm.axis_size(mesh, ch_axes) > 1:
            outs = sm.all_gather(outs, ch_axes, mesh, dim=2)
        A_log, dt_bias, D = w("A_log"), w("dt_bias"), w("D")
        keep = ("model",) if split else ()
        scale, out_w = w("norm.scale", keep), w("out_proj.w", keep)
        hs, kept_u, ss = {}, {}, {}
        for pos, (z, dt) in kept.items():
            Bsz = z.shape[0]
            h0 = rank[pos] * n
            heads = slice(h0, h0 + n)
            xs_, Bc, Cc = torch.split(outs[pos], [di, GN, GN], dim=-1)
            x_t = xs_[:, 0, h0 * hd:h0 * hd + c].reshape(Bsz, n, hd).float()
            B_t, C_t = (self._rank_heads(t[:, 0], h0, n, 0)
                        for t in (Bc, Cc))
            h, y = self._ssd_step(
                state["h"].blocks[pos][:, heads], dt[:, 0, heads],
                dt_bias[pos][heads], A_log[pos][heads], D[pos][heads],
                x_t, B_t, C_t)
            kept_u[pos], ss[pos] = self._gate(
                y.reshape(Bsz, 1, c), z[..., h0 * hd:h0 * hd + c])
            hs[pos] = h
        if split:
            ss = sm.psum(ss, "model", mesh)
            hs = sm.all_gather(hs, "model", mesh, dim=1)
        part = {}
        for pos, uf in kept_u.items():
            part[pos] = self._norm_out(uf, ss[pos], scale[pos], out_w[pos])
            new[pos]["h"] = hs[pos]
        _write_states(state, new)
        return sm.psum(part, "model", mesh) if split else part

    @staticmethod
    def _conv_step(window, cw, cb):
        """The causal conv of one token: ``window`` (B, k, ch) the last k
        conv inputs, ``cw`` (k, 1, ch), ``cb`` (ch,) → silu (B, 1, ch)."""
        co = (window * cw.transpose(0, 1)).sum(dim=1, keepdim=True)
        return F.silu(co + cb.to(co.dtype))

    @staticmethod
    def _ssd_step(h, dt, dt_bias, A_log, D, x_t, B_t, C_t):
        """One token's state update of n heads: ``h`` (B, n, hd, N) float32,
        ``dt`` (B, n) before its bias and softplus, ``x_t`` (B, n, hd),
        ``B_t``/``C_t`` (B, n, N) float32 → (the new ``h``, y (B, n, hd)
        with the D skip)."""
        dt = softplus(dt.float() + dt_bias.float())
        a = torch.exp(dt * -torch.exp(A_log.float())[None])
        h = (a[..., None, None] * h
             + (dt[..., None] * x_t)[..., None] * B_t[:, :, None, :])
        y = torch.einsum("bhdn,bhn->bhd", h, C_t)
        return h, y + x_t * D.float()[None, :, None]

    def _gate(self, y, z):
        """The gated norm's first half, in RMSNorm's dtype order: y (B, 1,
        c) float32 gated by silu(z) → (the gated rows in float32, their sum
        of squares (B, 1, 1))."""
        uf = (y.to(self.cfg.cdtype) * F.silu(z)).float()
        return uf, uf.square().sum(dim=-1, keepdim=True)

    def _norm_out(self, uf, ss, scale, out_w):
        """The gated norm's scaling of ``uf`` (B, 1, c) by the sum of
        squares over all of d_inner ``ss`` (B, 1, 1), then the rows
        ``out_w`` (c, d) of ``out_proj``."""
        uf = uf * torch.rsqrt(ss / self.cfg.d_inner + self.norm.eps)
        cd = self.cfg.cdtype
        return (uf * scale.float()).to(cd) @ out_w.to(cd)

    def _rank_heads(self, t, h0: int, n: int, g0: int):
        """(..., g·N) of the B/C groups g0 .. g0+g-1 → (..., n, N) float32
        for heads h0 .. h0+n-1, each reading its group as ``_heads`` maps
        them: a stride-0 view of one group, else the rank's heads alone."""
        cfg = self.cfg
        N = cfg.ssm.d_state
        g = t.reshape(*t.shape[:-1], -1, N).float()
        if g.shape[-2] == 1:
            return g.expand(*g.shape[:-2], n, N)
        per = cfg.ssm_heads // cfg.ssm.n_groups
        idx = torch.div(h0 + torch.arange(n, device=t.device), per,
                        rounding_mode="floor") - g0
        return g.index_select(-2, idx)

    def decode(self, x, state):
        """x: (B, 1, d); state {"h": (B, H, hd, N) float32, "conv":
        (B, k-1, conv_ch)}, both written in place → (y, state)."""
        cfg = self.cfg
        Bsz = x.shape[0]
        di, GN = cfg.d_inner, cfg.ssm.n_groups * cfg.ssm.d_state
        H, hd = cfg.ssm_heads, cfg.ssm.headdim
        z, xs, Bc, Cc, dt = self._split(self.in_proj(x))
        conv_in = torch.cat([xs, Bc, Cc], dim=-1)                # (B, 1, ch)
        window = torch.cat([state["conv"], conv_in], dim=1)      # (B, k, ch)
        co = self._conv_step(window, self.conv.w.to(conv_in.dtype),
                             self.conv.b)
        xs, Bc, Cc = torch.split(co, [di, GN, GN], dim=-1)
        x_t = xs[:, 0].reshape(Bsz, H, hd).float()
        B_t, C_t = self._heads(Bc[:, 0], 1), self._heads(Cc[:, 0], 1)
        h, y = self._ssd_step(state["h"], dt[:, 0], self.dt_bias, self.A_log,
                              self.D, x_t, B_t, C_t)
        out = self._gate_out(y.reshape(Bsz, 1, di), z)
        # the new state is complete before the old one is overwritten
        state["h"].copy_(h)
        state["conv"].copy_(window[:, 1:])
        return out, state

    @staticmethod
    def state_shape(cfg, batch: int):
        di, N, k = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
        H, hd, G = cfg.ssm_heads, cfg.ssm.headdim, cfg.ssm.n_groups
        conv_ch = di + 2 * G * N
        return {
            "h": ((batch, H, hd, N), torch.float32,
                  ("batch", None, None, None)),
            "conv": ((batch, k - 1, conv_ch), cfg.cdtype,
                     ("batch", None, "d_inner")),
        }
