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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.nn import Conv1D, Linear, RMSNorm
from repro_torch.nn.layers import _param


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
        w = self.conv.w.to(conv_in.dtype)                        # (k, 1, ch)
        co = (window * w.transpose(0, 1)).sum(dim=1, keepdim=True)
        if self.conv.b is not None:
            co = co + self.conv.b.to(co.dtype)
        xs, Bc, Cc = torch.split(F.silu(co), [di, GN, GN], dim=-1)
        dt = softplus(dt.float() + self.dt_bias.float())[:, 0]   # (B, H)
        A = -torch.exp(self.A_log.float())
        x_t = xs[:, 0].reshape(Bsz, H, hd).float()
        B_t, C_t = self._heads(Bc[:, 0], 1), self._heads(Cc[:, 0], 1)
        a = torch.exp(dt * A[None])
        h = (a[..., None, None] * state["h"]
             + (dt[..., None] * x_t)[..., None] * B_t[:, :, None, :])
        y = torch.einsum("bhdn,bhn->bhd", h, C_t)
        y = y + x_t * self.D.float()[None, :, None]
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
