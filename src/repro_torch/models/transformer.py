"""The language model of the dense family (``repro.models.transformer.LM``).

The reference stacks the layers' parameters on a leading axis and runs them
under ``lax.scan``; here every layer is its own ``DecoderBlock`` in an
``nn.ModuleList`` and a Python loop walks them.  The decode cache keeps the
reference's tree — ``{"index", "layers": {"k", "v"}}`` with ``(L, B, Smax,
KV, hd)`` leaves — and decode writes it in place through per-layer views,
where the reference donates the buffers to ``jit``.

Entry points:
  LM(cfg, device=..., seed=...)            seeded init, the reference's
                                           distributions; on cuda unless
                                           device="cpu" is asked for
  model(inputs)                            -> (logits, aux)   # LM.apply
  model.prefill(inputs, max_seq)           -> (last-position logits, cache)
  model.decode(tokens, cache)              -> (logits, cache)
  LM.cache_spec(cfg, batch, max_seq)       -> tree of (shape, dtype, axes)
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.blocks import DecoderBlock, norm_cls
from repro_torch.models.config import ModelConfig
from repro_torch.models.rotary import rope_angles, text_positions
from repro_torch.nn import Embedding, Linear


def _check_family(cfg: ModelConfig):
    if cfg.enc_dec:
        raise NotImplementedError("enc-dec models wait for slice C5")
    if cfg.hybrid is not None:
        raise NotImplementedError("hybrid models wait for slice C4")
    if cfg.ssm is not None:
        raise NotImplementedError("SSM models wait for slice C3")
    if cfg.m_rope or cfg.family == "vlm":
        raise NotImplementedError("VLM models wait for slice C2")
    if cfg.moe is not None:
        raise NotImplementedError("MoE models wait for slice C1")


def _angles(cfg: ModelConfig, batch: int, seq: int, start=0, device=None):
    pos = text_positions(batch, seq, start, device=device)
    return rope_angles(pos, cfg.hd, cfg.rope_theta)


def zero_aux(device=None) -> dict:
    z = lambda: torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z(), "z_loss": z(), "drop_frac": z()}


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        _check_family(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        gen = torch.Generator(device=device).manual_seed(seed)
        kw = dict(generator=gen, device=device)
        self.embed = Embedding(cfg.vocab, cfg.d_model, param_dtype=cfg.pdtype,
                               **kw)
        self.blocks = nn.ModuleList(DecoderBlock(cfg, **kw)
                                    for _ in range(cfg.n_layers))
        self.ln_f = norm_cls(cfg)(cfg.d_model, eps=cfg.norm_eps,
                                  param_dtype=cfg.pdtype, device=device)
        # the untied readout multiplies in float32, as the reference's einsum
        # with preferred_element_type=float32 does
        self.lm_head = (None if cfg.tie_embeddings else
                        Linear(cfg.d_model, cfg.vocab, dtype=torch.float32,
                               use_bias=False, param_dtype=cfg.pdtype, **kw))

    @property
    def device(self) -> torch.device:
        return self.embed.table.device

    def recast(self):
        """Refresh every Linear's compute-dtype weight copy (after loading)."""
        for m in self.modules():
            if isinstance(m, Linear):
                m.recast()

    # ------------------------------------------------------------- shared

    def _embed(self, tokens):
        return self.embed(tokens, dtype=self.cfg.cdtype)

    def _logits(self, h):
        if self.lm_head is None:
            return self.embed.attend(h)
        return self.lm_head(h.float())

    # ------------------------------------------------------------- forward

    def forward(self, inputs):
        """Full-sequence forward (the reference's ``LM.apply``).  inputs:
        {"tokens": (B, S)} → (logits (B, S, V) float32, aux)."""
        tokens = inputs["tokens"]
        B, S = tokens.shape
        h = self._embed(tokens)
        angles = _angles(self.cfg, B, S, device=h.device)
        for blk in self.blocks:
            h = blk(h, angles=angles)
        return self._logits(self.ln_f(h)), zero_aux(h.device)

    # ------------------------------------------------------------- cache

    @staticmethod
    def cache_spec(cfg: ModelConfig, batch: int, max_seq: int):
        """Tree of (shape, dtype, logical_axes) describing the decode state."""
        _check_family(cfg)
        L = cfg.n_layers
        kv = Attention.cache_shape(cfg, batch, max_seq)
        return {"index": ((), torch.int32, ()),
                "layers": {n: ((L,) + s, cfg.cdtype, ("layers",) + ax)
                           for n, (s, ax) in kv.items()}}

    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   device="cuda"):
        spec = LM.cache_spec(cfg, batch, max_seq)
        device = resolve_device(device)
        zeros = lambda s: torch.zeros(s[0], dtype=s[1], device=device)
        return {"index": zeros(spec["index"]),
                "layers": {n: zeros(s) for n, s in spec["layers"].items()}}

    # ------------------------------------------------------------- prefill

    def prefill(self, inputs, max_seq: int):
        """Forward over the prompt, building the decode cache.  Returns
        (last-position logits (B, 1, V), cache)."""
        cfg = self.cfg
        tokens = inputs["tokens"]
        B, S = tokens.shape
        h = self._embed(tokens)
        angles = _angles(cfg, B, S, device=h.device)
        ks, vs = [], []
        for blk in self.blocks:
            h, kv = self._decoder_prefill_block(blk, h, angles, max_seq)
            ks.append(kv["k"])
            vs.append(kv["v"])
        logits = self._logits(self.ln_f(h[:, -1:]))
        cache = {"index": torch.tensor(S, dtype=torch.int32, device=h.device),
                 "layers": {"k": torch.stack(ks), "v": torch.stack(vs)}}
        return logits, cache

    def _decoder_prefill_block(self, blk, x, angles, max_seq):
        x, (k, v) = blk(x, angles=angles, return_kv=True)
        return x, self._kv_to_ring(k, v, max_seq)

    def _kv_to_ring(self, k, v, max_seq):
        """Lay full-sequence K/V out as the ring cache sized for ``max_seq``
        (position p lives at slot p % W)."""
        S = k.shape[1]
        W = Attention.cache_len(self.cfg, max_seq)
        if W < S:
            shift = (S - W) % W
            k = torch.roll(k[:, S - W:], shift, dims=1)
            v = torch.roll(v[:, S - W:], shift, dims=1)
        elif W > S:
            pad = (0, 0, 0, 0, 0, W - S)
            k, v = F.pad(k, pad), F.pad(v, pad)
        return {"k": k, "v": v}

    # ------------------------------------------------------------- decode

    def decode(self, tokens, cache):
        """tokens: (B, 1) → (logits (B, 1, V), cache).  cache["index"] is
        the absolute position of this token: an int32 scalar or a (B,)
        vector.  A "block_tbl" entry ((B, nk) int32, shared by every layer)
        switches the K/V leaves to the paged (L, NB, bk, KV, hd) block
        pools.  The K/V leaves are written in place; the returned cache
        shares them and every other entry, and carries index + 1."""
        index = cache["index"]
        tbl = cache.get("block_tbl")
        B = tokens.shape[0]
        h = self._embed(tokens)
        angles = _angles(self.cfg, B, 1, start=index, device=h.device)
        layers = cache["layers"]
        for i, blk in enumerate(self.blocks):
            h, _ = blk.decode(h, {"k": layers["k"][i], "v": layers["v"][i]},
                              index, angles=angles, block_tbl=tbl)
        logits = self._logits(self.ln_f(h))
        return logits, {**cache, "index": index + 1}

