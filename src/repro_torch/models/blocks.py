"""Layer blocks: the dense decoder block (pre-norm attention + SwiGLU).
The MoE, SSM, hybrid and encoder-decoder blocks of ``repro.models.blocks``
are not ported yet."""
from __future__ import annotations

from torch import nn

from repro_torch.models.attention import Attention
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
