"""Core layers as ``nn.Module``s, with the parameter names and layouts of
``repro.nn.layers`` (a Linear weight is ``(in_dim, out_dim)``), so the weight
bridge maps the reference's parameter tree one to one.

Parameters stay in the config's ``param_dtype`` and take no gradients by
default: the models serve.  The control plane's DNN (``core/dnn/model.py``)
turns them on for its own training step; the language model's train step
(``models/steps.py``) differentiates through the train route instead.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.nn.init import lecun_normal, normal_init


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Linear(nn.Module):
    """``y = x @ w + b`` in the compute dtype.

    The reference casts ``w`` from the param dtype to the compute dtype on
    every call; in eager PyTorch that would re-read every float32 weight each
    tick.  The cast is done once (``recast``, run at construction and after
    the weights are loaded) and the compute-dtype copy ``w_c`` is kept — the
    same arithmetic.  When the two dtypes agree, ``w_c`` is ``w`` itself.
    ``dtype=None`` casts nothing and reads ``w`` on every call, as the
    reference's ``Linear.apply`` without a dtype does; the control plane's
    DNN trains through it.

    ``train=True`` is the train route: ``w`` is cast on the call, inside
    the autograd graph, so its gradient reaches the parameter; ``w_c`` is
    a detached copy and would carry none."""

    def __init__(self, in_dim: int, out_dim: int, *,
                 dtype: torch.dtype | None,
                 use_bias: bool = True, param_dtype=torch.float32,
                 w_init=None, generator=None, device=None):
        super().__init__()
        w_init = w_init or lecun_normal(in_axis=0)
        self.dtype = dtype
        self.w = _param(w_init((in_dim, out_dim), generator=generator,
                               device=device, dtype=param_dtype))
        self.b = (_param(torch.zeros(out_dim, device=device, dtype=param_dtype))
                  if use_bias else None)
        self.register_buffer("w_c", None, persistent=False)
        self.recast()

    def recast(self):
        if self.dtype is not None:
            self.w_c = self.w.detach().to(self.dtype)

    def forward(self, x: torch.Tensor, *, train: bool = False) -> torch.Tensor:
        if self.dtype is None:
            y = x @ self.w
        else:
            w = self.w.to(self.dtype) if train else self.w_c
            y = x.to(self.dtype) @ w
        if self.b is not None:
            y = y + self.b.to(y.dtype)
        return y


class Embedding(nn.Module):
    def __init__(self, vocab: int, dim: int, *, param_dtype=torch.float32,
                 scale: float = 1.0, generator=None, device=None):
        super().__init__()
        self.table = _param(normal_init(0.02 * scale)(
            (vocab, dim), generator=generator, device=device,
            dtype=param_dtype))

    def forward(self, ids: torch.Tensor, *, dtype=None) -> torch.Tensor:
        out = self.table[ids]
        return out if dtype is None else out.to(dtype)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied readout: logits = x @ table.T in float32.  The reference's
        einsum promotes the compute-dtype hidden state against the float32
        table, so the table is read in float32 here too."""
        return x.float() @ self.table.float().t()


class RMSNorm(nn.Module):
    def __init__(self, dim: int, *, eps: float = 1e-6,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param(torch.ones(dim, device=device, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(x.dtype)


class Conv1D(nn.Module):
    """NLC 1-D convolution (``repro.nn.layers.Conv1D``), the Mamba short
    conv.  The weight keeps the reference's ``(k, in/groups, out)`` layout,
    so the bridge copies it as is; ``forward`` hands ``F.conv1d`` its
    ``(out, in/groups, k)`` view.  The output is as long as the input:
    ``causal=True`` pads k-1 steps on the left, otherwise the padding is
    split as XLA's "SAME" splits it.  The reference runs this
    outside any Pallas kernel (``lax.conv_general_dilated``)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int, *,
                 use_bias: bool = True, param_dtype=torch.float32,
                 groups: int = 1, generator=None, device=None):
        super().__init__()
        self.groups = groups
        fan_in = in_ch // groups * kernel
        std = (1.0 / max(fan_in, 1)) ** 0.5
        self.w = _param(normal_init(std)(
            (kernel, in_ch // groups, out_ch), generator=generator,
            device=device, dtype=param_dtype))
        self.b = (_param(torch.zeros(out_ch, device=device, dtype=param_dtype))
                  if use_bias else None)

    def forward(self, x: torch.Tensor, *, causal: bool = False,
                dtype=None) -> torch.Tensor:
        """x: (B, L, C) → (B, L, out) in ``dtype`` (default x's), laid out
        NLC (channels last and contiguous, as the reference's)."""
        w = self.w if dtype is None else self.w.to(dtype)
        x = x if dtype is None else x.to(dtype)
        return conv1d_nlc(x, w, self.b, groups=self.groups, causal=causal)


def conv1d_nlc(x, w, b=None, *, groups: int, causal: bool = False):
    """``Conv1D.forward``'s arithmetic on given weights: x (B, L, C), w
    (k, C/groups, out), b (out,) or None → (B, L, out) in x's dtype.  The
    Mamba blocks' mesh route runs a rank's channels of the depthwise conv
    through it."""
    k = w.shape[0]
    # causal: k-1 steps on the left; "SAME": the reference's split
    left = k - 1 if causal else (k - 1) // 2
    xt = F.pad(x.transpose(1, 2), (left, k - 1 - left))   # (B, C, L+k-1)
    y = F.conv1d(xt, w.permute(2, 1, 0),
                 groups=groups).transpose(1, 2).contiguous()
    if b is not None:
        y = y + b.to(y.dtype)
    return y


class LayerNorm(nn.Module):
    def __init__(self, dim: int, *, eps: float = 1e-5,
                 param_dtype=torch.float32, device=None):
        super().__init__()
        self.eps = eps
        self.scale = _param(torch.ones(dim, device=device, dtype=param_dtype))
        self.bias = _param(torch.zeros(dim, device=device, dtype=param_dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        y = y * self.scale.float() + self.bias.float()
        return y.to(x.dtype)


class BatchNorm(nn.Module):
    """Batch norm with its running statistics threaded through the caller
    (``repro.nn.layers.BatchNorm``; the MLOps DNN's deployment stream).

    Not ``nn.BatchNorm1d``: training normalises with the *biased* batch
    variance and keeps that same biased variance in the running state as
    ``momentum·old + (1 − momentum)·batch``, beside a ``count``.  The state
    is a dict ``{"mean", "var", "count"}`` of float32 tensors; ``forward``
    returns the new one and never changes the one it was given."""

    def __init__(self, dim: int, *, param_dtype=torch.float32, device=None):
        super().__init__()
        self.dim = dim
        self.scale = _param(torch.ones(dim, device=device, dtype=param_dtype))
        self.bias = _param(torch.zeros(dim, device=device, dtype=param_dtype))

    def init_state(self) -> dict:
        dev = self.scale.device
        return {"mean": torch.zeros(self.dim, device=dev),
                "var": torch.ones(self.dim, device=dev),
                "count": torch.zeros((), device=dev)}

    def forward(self, state: dict, x: torch.Tensor, *, training: bool,
                momentum: float = 0.9, eps: float = 1e-5):
        if training:
            dims = tuple(range(x.ndim - 1))
            mean = x.mean(dim=dims)
            var = x.var(dim=dims, correction=0)
            new_state = {
                "mean": (momentum * state["mean"]
                         + (1 - momentum) * mean).detach(),
                "var": (momentum * state["var"]
                        + (1 - momentum) * var).detach(),
                "count": state["count"] + 1.0,
            }
        else:
            mean, var = state["mean"], state["var"]
            new_state = state
        y = (x - mean) * torch.rsqrt(var + eps)
        return y * self.scale + self.bias, new_state


class MLP(nn.Module):
    """Plain dense stack with an activation between layers
    (``repro.nn.layers.MLP``): its Linears are ``layers.<i>``, uncast."""

    def __init__(self, dims, *, use_bias: bool = True,
                 param_dtype=torch.float32, generator=None, device=None):
        super().__init__()
        self.layers = nn.ModuleList(
            Linear(dims[i], dims[i + 1], dtype=None, use_bias=use_bias,
                   param_dtype=param_dtype, generator=generator,
                   device=device)
            for i in range(len(dims) - 1))

    def forward(self, x: torch.Tensor, *, act=F.relu,
                final_act=None) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1:
                x = act(x)
            elif final_act is not None:
                x = final_act(x)
        return x
