"""Layer blocks: the decoder block (pre-norm attention + SwiGLU or MoE),
the pre-norm Mamba block (Mamba1 or Mamba2), zamba2's shared attention
block, and seamless's encoder block and cross-attending decoder block
(``repro.models.blocks``).  ``train=True`` on a forward takes the train
route down to every layer (``Attention.forward``); each block's
``forward_mesh`` is its train route over a mesh, shard by shard, and its
``prefill_mesh`` and ``decode_mesh`` the serve route over one (the
encoder's serve route over a mesh is its ``forward_mesh``: plain,
bidirectional, as on one device)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.attention import Attention
from repro_torch.models.mamba import Mamba1, Mamba2
from repro_torch.models.mlp import SwiGLU
from repro_torch.models.moe import MoE
from repro_torch.nn import LayerNorm, RMSNorm


def norm_cls(cfg):
    return LayerNorm if cfg.family == "audio" else RMSNorm


def norm_mesh(norm, w, xs):
    """A norm over a mesh: replicated ("embed_act"), each position runs it
    on its own copy of the parameters.  ``w`` the norm's parameters as
    ``steps.MeshParams`` gives them, ``xs`` {position: activation}."""
    ps = {n: w(n, ()) for n, _ in norm.named_parameters()}
    return {p: torch.func.functional_call(norm, {n: t[p] for n, t in
                                                 ps.items()}, (x,))
            for p, x in xs.items()}


class DecoderBlock(nn.Module):
    """Pre-norm attention + (SwiGLU | MoE) — the dense and MoE families."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        norm = norm_cls(cfg)
        nkw = dict(eps=cfg.norm_eps, param_dtype=cfg.pdtype, device=device)
        self.ln1 = norm(cfg.d_model, **nkw)
        self.attn = Attention(cfg, generator=generator, device=device)
        self.ln2 = norm(cfg.d_model, **nkw)
        fkw = dict(dtype=cfg.cdtype, param_dtype=cfg.pdtype,
                   generator=generator, device=device)
        if cfg.moe is not None:
            self.moe = MoE(cfg.d_model, cfg.moe, **fkw)
        else:
            self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, **fkw)

    def _ffn(self, x, train: bool = False):
        """→ (y, the MoE aux or None), as the reference's ``_ffn``."""
        if self.cfg.moe is not None:
            return self.moe(x, train=train)
        return self.mlp(x, train=train), None

    def forward(self, x, *, angles=None, causal=True, return_kv=False,
                return_aux=False, train: bool = False):
        """x → x, or (x[, (k, v)][, aux]) as ``return_kv`` and
        ``return_aux`` ask."""
        h, kv = self.attn(self.ln1(x), angles=angles, causal=causal,
                          window=self.cfg.sliding_window, return_kv=True,
                          train=train)
        x = x + h
        h, aux = self._ffn(self.ln2(x), train)
        x = x + h
        out = (x,) + ((kv,) if return_kv else ()) + (
            (aux,) if return_aux else ())
        return out if len(out) > 1 else x

    def forward_mesh(self, w, xs, angles, batch_axes):
        """The train route over a mesh: {position: (B_loc, S, d)}, the batch
        split over ``batch_axes`` → ({position: (B_loc, S, d)}, the MoE aux
        or None)."""
        h = self.attn.forward_mesh(w.sub("attn"), norm_mesh(
            self.ln1, w.sub("ln1"), xs), angles,
            window=self.cfg.sliding_window)
        xs = {p: x + h[p] for p, x in xs.items()}
        h = norm_mesh(self.ln2, w.sub("ln2"), xs)
        if self.cfg.moe is not None:
            h, aux = self.moe.forward_mesh(w.sub("moe"), h, batch_axes)
        else:
            h, aux = self.mlp.forward_mesh(w.sub("mlp"), h), None
        return {p: x + h[p] for p, x in xs.items()}, aux

    def decode(self, x, cache, index, *, angles=None, block_tbl=None):
        h, cache = self.attn.decode(self.ln1(x), cache, index, angles=angles,
                                    block_tbl=block_tbl)
        x = x + h
        return x + self._ffn(self.ln2(x))[0], cache

    def _ffn_mesh(self, w, xs, batch_axes):
        """The serve route's feed-forward over a mesh: the column- and
        row-parallel SwiGLU, or the MoE's expert-parallel body (or its
        global path where the reference takes it)."""
        h = norm_mesh(self.ln2, w.sub("ln2"), xs)
        if self.cfg.moe is not None:
            h = self.moe.forward_mesh(w.sub("moe"), h, batch_axes)[0]
        else:
            h = self.mlp.forward_mesh(w.sub("mlp"), h)
        return {p: x + h[p] for p, x in xs.items()}

    def prefill_mesh(self, w, xs, angles, batch_axes, *, max_seq, kv_spec):
        """A prompt over a mesh (``Attention.prefill_mesh``, then the
        feed-forward) → ({position: (B_loc, S, d)}, {"k", "v"}: this
        layer's cache blocks under ``kv_spec``)."""
        h, kv = self.attn.prefill_mesh(
            w.sub("attn"), norm_mesh(self.ln1, w.sub("ln1"), xs), angles,
            window=self.cfg.sliding_window, max_seq=max_seq,
            kv_spec=kv_spec, batch_axes=batch_axes)
        xs = {p: x + h[p] for p, x in xs.items()}
        return self._ffn_mesh(w, xs, batch_axes), kv

    def decode_mesh(self, w, xs, angles, batch_axes, cache, index, kv_spec,
                    block_tbl=None):
        """One token over a mesh: {position: (B_loc, 1, d)} → the same;
        ``cache`` this layer's {"k", "v"} ``ShardedArray`` (a ring, or the
        pool ``block_tbl`` pages), written in place."""
        h = self.attn.decode_mesh(
            w.sub("attn"), norm_mesh(self.ln1, w.sub("ln1"), xs), angles,
            cache, index, kv_spec, batch_axes, block_tbl)
        xs = {p: x + h[p] for p, x in xs.items()}
        return self._ffn_mesh(w, xs, batch_axes)


class SSMBlock(nn.Module):
    """Pre-norm Mamba block — the ssm family (Mamba1 for ``ssm.version``
    1) and the zamba2 backbone (Mamba2)."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        self.ln = RMSNorm(cfg.d_model, eps=cfg.norm_eps,
                          param_dtype=cfg.pdtype, device=device)
        self.mamba = self.impl(cfg)(cfg, generator=generator, device=device)

    @staticmethod
    def impl(cfg):
        return Mamba1 if cfg.ssm.version == 1 else Mamba2

    @staticmethod
    def state_shape(cfg, batch: int):
        return SSMBlock.impl(cfg).state_shape(cfg, batch)

    def forward(self, x, *, return_state: bool = False, train: bool = False):
        """x: (B, L, d) → x + mamba(ln(x)) [, the decode state]."""
        if return_state:
            y, state = self.mamba(self.ln(x), return_state=True)
            return x + y, state
        return x + self.mamba(self.ln(x), train=train)

    def forward_mesh(self, w, xs):
        """The train route over a mesh: {position: (B_loc, L, d)} →
        {position: x + mamba(ln(x))}."""
        y = self.mamba.forward_mesh(w.sub("mamba"),
                                    norm_mesh(self.ln, w.sub("ln"), xs))
        return {p: x + y[p] for p, x in xs.items()}

    def decode(self, x, state):
        y, state = self.mamba.decode(self.ln(x), state)
        return x + y, state

    def prefill_mesh(self, w, xs, batch_axes, specs):
        """A prompt over a mesh on the serve route → ({position: x +
        mamba(ln(x))}, {"h", "conv"}: this layer's state blocks under
        ``specs``)."""
        y, state = self.mamba.prefill_mesh(
            w.sub("mamba"), norm_mesh(self.ln, w.sub("ln"), xs), batch_axes,
            specs)
        return {p: x + y[p] for p, x in xs.items()}, state

    def decode_mesh(self, w, xs, state):
        """One token over a mesh: ``state`` this layer's {"h", "conv"}
        ``ShardedArray``, written in place."""
        y = self.mamba.decode_mesh(w.sub("mamba"),
                                   norm_mesh(self.ln, w.sub("ln"), xs), state)
        return {p: x + y[p] for p, x in xs.items()}


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

    def forward(self, x2, *, angles=None, return_kv=False,
                train: bool = False):
        """x2: (B, S, 2d) → (B, S, 2d) [, (k, v) for the cache]."""
        h, kv = self.attn(self.ln1(x2), angles=angles, causal=True,
                          return_kv=True, train=train)
        x2 = x2 + h
        x2 = x2 + self.mlp(self.ln2(x2), train=train)
        return (x2, kv) if return_kv else x2

    def forward_mesh(self, w, xs, angles):
        """The train route over a mesh: {position: (B_loc, S, 2d)} → the
        same.  A block shared by several groups is read through one
        ``MeshParams``, which gathers each weight once a step; autograd
        adds the groups' gradients."""
        h = self.attn.forward_mesh(w.sub("attn"), norm_mesh(
            self.ln1, w.sub("ln1"), xs), angles)
        xs = {p: x + h[p] for p, x in xs.items()}
        h = self.mlp.forward_mesh(w.sub("mlp"), norm_mesh(
            self.ln2, w.sub("ln2"), xs))
        return {p: x + h[p] for p, x in xs.items()}

    def decode(self, x2, cache, index, *, angles=None, block_tbl=None):
        h, cache = self.attn.decode(self.ln1(x2), cache, index, angles=angles,
                                    block_tbl=block_tbl)
        x2 = x2 + h
        return x2 + self.mlp(self.ln2(x2)), cache

    def _mlp_mesh(self, w, xs, h):
        xs = {p: x + h[p] for p, x in xs.items()}
        h = self.mlp.forward_mesh(w.sub("mlp"), norm_mesh(
            self.ln2, w.sub("ln2"), xs))
        return {p: x + h[p] for p, x in xs.items()}

    def prefill_mesh(self, w, xs, angles, batch_axes, *, max_seq, kv_spec):
        """A prompt over a mesh (``Attention.prefill_mesh``: K4 on each
        rank's heads) → ({position: (B_loc, S, 2d)}, {"k", "v"}: this
        application's ring blocks under ``kv_spec``)."""
        h, kv = self.attn.prefill_mesh(
            w.sub("attn"), norm_mesh(self.ln1, w.sub("ln1"), xs), angles,
            window=None, max_seq=max_seq, kv_spec=kv_spec,
            batch_axes=batch_axes)
        return self._mlp_mesh(w, xs, h), kv

    def decode_mesh(self, w, xs, angles, cache, index, kv_spec, batch_axes,
                    block_tbl=None):
        """One token over a mesh (``Attention.decode_mesh`` over ``cache``,
        written in place) → {position: (B_loc, 1, 2d)}."""
        h = self.attn.decode_mesh(w.sub("attn"), norm_mesh(
            self.ln1, w.sub("ln1"), xs), angles, cache, index, kv_spec,
            batch_axes, block_tbl)
        return self._mlp_mesh(w, xs, h)


class EncoderBlock(nn.Module):
    """Bidirectional attention + SwiGLU, LayerNorm (the seamless encoder)."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        nkw = dict(eps=cfg.norm_eps, param_dtype=cfg.pdtype, device=device)
        self.ln1 = LayerNorm(cfg.d_model, **nkw)
        self.attn = Attention(cfg, generator=generator, device=device)
        self.ln2 = LayerNorm(cfg.d_model, **nkw)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dtype=cfg.cdtype,
                          param_dtype=cfg.pdtype, generator=generator,
                          device=device)

    def forward(self, x, *, angles=None, train: bool = False):
        x = x + self.attn(self.ln1(x), angles=angles, causal=False,
                          train=train)
        return x + self.mlp(self.ln2(x), train=train)

    def forward_mesh(self, w, xs, angles):
        """The train route over a mesh: {position: (B_loc, S_enc, d)} →
        the same."""
        h = self.attn.forward_mesh(w.sub("attn"), norm_mesh(
            self.ln1, w.sub("ln1"), xs), angles, causal=False)
        xs = {p: x + h[p] for p, x in xs.items()}
        h = self.mlp.forward_mesh(w.sub("mlp"), norm_mesh(
            self.ln2, w.sub("ln2"), xs))
        return {p: x + h[p] for p, x in xs.items()}


class CrossDecoderBlock(nn.Module):
    """Causal self-attention + cross attention + SwiGLU, LayerNorm (the
    seamless decoder)."""

    def __init__(self, cfg, *, generator=None, device=None):
        super().__init__()
        self.cfg = cfg
        nkw = dict(eps=cfg.norm_eps, param_dtype=cfg.pdtype, device=device)
        self.ln1 = LayerNorm(cfg.d_model, **nkw)
        self.self_attn = Attention(cfg, generator=generator, device=device)
        self.ln2 = LayerNorm(cfg.d_model, **nkw)
        self.cross_attn = Attention(cfg, generator=generator, device=device)
        self.ln3 = LayerNorm(cfg.d_model, **nkw)
        self.mlp = SwiGLU(cfg.d_model, cfg.d_ff, dtype=cfg.cdtype,
                          param_dtype=cfg.pdtype, generator=generator,
                          device=device)

    def cross_kv(self, enc_out, *, train: bool = False):
        """Cross K/V of the encoder output: (B, S_enc, KV, hd) each."""
        cfg = self.cfg
        B, Se = enc_out.shape[:2]
        k = self.cross_attn.wk(enc_out, train=train).reshape(
            B, Se, cfg.n_kv_heads, cfg.hd)
        v = self.cross_attn.wv(enc_out, train=train).reshape(
            B, Se, cfg.n_kv_heads, cfg.hd)
        return k, v

    def forward(self, x, *, enc_out, angles=None, return_kv=False,
                train: bool = False):
        """x: (B, S, d) over the encoder output → x [, the self-attention's
        (k, v) and the cross (k, v), for the cache]."""
        h, kv = self.self_attn(self.ln1(x), angles=angles, causal=True,
                               return_kv=True, train=train)
        x = x + h
        ckv = self.cross_kv(enc_out, train=train)
        x = x + self.cross_attn(self.ln2(x), cross_kv=ckv, causal=False,
                                train=train)
        x = x + self.mlp(self.ln3(x), train=train)
        return (x, kv, ckv) if return_kv else x

    def forward_mesh(self, w, xs, enc_out, angles):
        """The train route over a mesh: {position: (B_loc, S, d)} over
        {position: the batch shard's encoder output (B_loc, S_enc, d)} →
        {position: (B_loc, S, d)}.  The cross attention projects each
        rank's K/V heads of the encoder output, with no RoPE."""
        h = self.self_attn.forward_mesh(w.sub("self_attn"), norm_mesh(
            self.ln1, w.sub("ln1"), xs), angles)
        xs = {p: x + h[p] for p, x in xs.items()}
        h = self.cross_attn.forward_mesh(w.sub("cross_attn"), norm_mesh(
            self.ln2, w.sub("ln2"), xs), None, causal=False, x_kv=enc_out)
        xs = {p: x + h[p] for p, x in xs.items()}
        h = self.mlp.forward_mesh(w.sub("mlp"), norm_mesh(
            self.ln3, w.sub("ln3"), xs))
        return {p: x + h[p] for p, x in xs.items()}

    def _cross_mlp_mesh(self, w, xs, h, cross):
        """The residual after self attention, then cross attention
        (``cross``: the ln2 output → its psummed output) and the MLP."""
        xs = {p: x + h[p] for p, x in xs.items()}
        h = cross(norm_mesh(self.ln2, w.sub("ln2"), xs))
        xs = {p: x + h[p] for p, x in xs.items()}
        h = self.mlp.forward_mesh(w.sub("mlp"), norm_mesh(
            self.ln3, w.sub("ln3"), xs))
        return {p: x + h[p] for p, x in xs.items()}

    def prefill_mesh(self, w, xs, enc_out, angles, batch_axes, *, max_seq,
                     specs):
        """A prompt over a mesh on the serve route: {position: (B_loc, S,
        d)} over {position: the batch shard's encoder output} →
        ({position: (B_loc, S, d)}, {"self": the ring blocks, "cross": the
        cross K/V blocks at the encoder's length}, laid out by ``specs``'
        "self" and "cross" layer specs)."""
        h, kv = self.self_attn.prefill_mesh(
            w.sub("self_attn"), norm_mesh(self.ln1, w.sub("ln1"), xs), angles,
            window=None, max_seq=max_seq, kv_spec=specs["self"],
            batch_axes=batch_axes)
        got = {}

        def cross(x):
            out, got["kv"] = self.cross_attn.prefill_cross_mesh(
                w.sub("cross_attn"), x, enc_out, specs["cross"], batch_axes)
            return out
        xs = self._cross_mlp_mesh(w, xs, h, cross)
        return xs, {"self": kv, "cross": got["kv"]}

    def decode_mesh(self, w, xs, angles, state, index, specs, cross_len,
                    batch_axes, block_tbl=None):
        """One token over a mesh: ``state`` {"self", "cross"}: this
        layer's ``ShardedArray`` K/V (the self ring, or the pool
        ``block_tbl`` pages, written in place; the cross K/V read,
        head-parallel, masked past ``cross_len``'s rows)."""
        h = self.self_attn.decode_mesh(
            w.sub("self_attn"), norm_mesh(self.ln1, w.sub("ln1"), xs), angles,
            state["self"], index, specs["self"], batch_axes, block_tbl)
        return self._cross_mlp_mesh(w, xs, h, lambda x: (
            self.cross_attn.decode_cross_mesh(w.sub("cross_attn"), x,
                                              state["cross"], cross_len)))

    def decode(self, x, state, index, *, angles=None, cross_len=None,
               block_tbl=None):
        """state = {"self": the self-attention's cache, "cross": {"k", "v"}
        written at admission}.  ``cross_len``: an int or a (B,) tensor;
        cross keys at positions >= it are masked.  ``block_tbl`` pages the
        self cache only: the cross K/V stay dense."""
        h, _ = self.self_attn.decode(self.ln1(x), state["self"], index,
                                     angles=angles, block_tbl=block_tbl)
        x = x + h
        cross = state["cross"]
        h, _ = self.cross_attn.decode(self.ln2(x), None, index,
                                      cross_kv=(cross["k"], cross["v"]),
                                      cross_len=cross_len)
        x = x + h
        return x + self.mlp(self.ln3(x)), state
