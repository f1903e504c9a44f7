"""Layer blocks: the dense decoder block (pre-norm attention + SwiGLU), the
pre-norm Mamba2 block and zamba2's shared attention block.  The MoE and
encoder-decoder blocks of ``repro.models.blocks`` and Mamba1 are not ported
yet."""
from __future__ import annotations

from torch import nn

from repro_torch.models.attention import Attention
from repro_torch.models.mamba import Mamba2
from repro_torch.models.mlp import SwiGLU
from repro_torch.nn import LayerNorm, RMSNorm


def norm_cls(cfg):
    return LayerNorm if cfg.family == "audio" else RMSNorm


class DecoderBlock(nn.Module):
    """Pre-norm attention + SwiGLU — the dense family."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        if cfg.moe is not None:
            raise NotImplementedError("MoE blocks wait for slice C1 of the "
                                      "port")
        self.cfg = cfg
        norm = norm_cls(cfg)
        nkw = dict(eps=cfg.norm_eps, param_dtype=cfg.pdtype, device=device)
        self.ln1 = norm(cfg.d_model, **nkw)
        self.attn = Attention(cfg, generator=generator, device=device)
        self.ln2 = norm(cfg.d_model, **nkw)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dtype=cfg.cdtype,
                          param_dtype=cfg.pdtype, generator=generator,
                          device=device)

    def forward(self, x, *, angles=None, causal=True, return_kv=False):
        h, kv = self.attn(self.ln1(x), angles=angles, causal=causal,
                          window=self.cfg.sliding_window, return_kv=True)
        x = x + h
        x = x + self.mlp(self.ln2(x))
        return (x, kv) if return_kv else x

    def decode(self, x, cache, index, *, angles=None, block_tbl=None):
        h, cache = self.attn.decode(self.ln1(x), cache, index, angles=angles,
                                    block_tbl=block_tbl)
        x = x + h
        return x + self.mlp(self.ln2(x)), cache


class SSMBlock(nn.Module):
    """Pre-norm Mamba2 block — the ssm family and the zamba2 backbone."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        if cfg.ssm.version != 2:
            raise NotImplementedError("Mamba1 (falcon-mamba) waits for "
                                      "slice C3 of the port")
        self.ln = RMSNorm(cfg.d_model, eps=cfg.norm_eps,
                          param_dtype=cfg.pdtype, device=device)
        self.mamba = Mamba2(cfg, generator=generator, device=device)

    def forward(self, x, *, return_state: bool = False):
        """x: (B, L, d) → x + mamba(ln(x)) [, the decode state]."""
        if return_state:
            y, state = self.mamba(self.ln(x), return_state=True)
            return x + y, state
        return x + self.mamba(self.ln(x))

    def decode(self, x, state):
        y, state = self.mamba.decode(self.ln(x), state)
        return x + y, state


class SharedAttnBlock(nn.Module):
    """Zamba2's shared transformer block over concat(hidden, embed0), at
    2*d_model: attention + SwiGLU.  Its weights are shared round-robin
    across the groups; the per-group down projection lives in the LM."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        d2 = 2 * cfg.d_model
        nkw = dict(eps=cfg.norm_eps, param_dtype=cfg.pdtype, device=device)
        self.ln1 = RMSNorm(d2, **nkw)
        self.attn = Attention(cfg, d_in=d2, d_out=d2, generator=generator,
                              device=device)
        self.ln2 = RMSNorm(d2, **nkw)
        self.mlp = SwiGLU(d2, cfg.d_ff, dtype=cfg.cdtype,
                          param_dtype=cfg.pdtype, d_out=d2,
                          generator=generator, device=device)

    def forward(self, x2, *, angles=None, return_kv=False):
        """x2: (B, S, 2d) → (B, S, 2d) [, (k, v) for the cache]."""
        h, kv = self.attn(self.ln1(x2), angles=angles, causal=True,
                          return_kv=True)
        x2 = x2 + h
        x2 = x2 + self.mlp(self.ln2(x2))
        return (x2, kv) if return_kv else x2

    def decode(self, x2, cache, index, *, angles=None, block_tbl=None):
        h, cache = self.attn.decode(self.ln1(x2), cache, index, angles=angles,
                                    block_tbl=block_tbl)
        x2 = x2 + h
        return x2 + self.mlp(self.ln2(x2)), cache
