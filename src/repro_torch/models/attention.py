"""GQA attention with RoPE: causal / sliding-window / bidirectional
self-attention over a sequence, cross attention over precomputed K/V, and
one-token decode over a preallocated ring KV cache, a shared block pool or
a cross K/V pool.

``repro.models.attention`` without its mesh paths.  Serving, causal
self-attention goes through ``kops.flash_attention``; bidirectional and
cross attention run the plain ``sdpa_ref``, as the reference routes them.
The train route (``train=True``) runs every attention through the
reference's plain ``_sdpa_masked``, which chunks the queries of a long
sequence (``_sdpa_chunked``) on either device: the kernels have no
backward, and the reference trains with ``use_pallas`` off.  Decode writes the
token's K/V and attends in one call, ``kops.decode_attention_write`` over
the ring or ``kops.decode_attention_paged_write`` through the block table,
where the reference calls ``cache_ring_update`` (``cache_paged_update``)
twice and then ``decode_attention`` (``decode_attention_paged``): one
kernel launch a layer on the card, bitwise equal to the three, and the
same three plain versions in turn on the CPU.  The kernel finds the written slot or block
from the index and the table itself.  Split-K over a mesh and padded
heads wait for the multi-device slice.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models.rotary import apply_rope
from repro_torch.nn import Linear

NEG_INF = -1e9


def _mask_bias(q_pos, k_pos, *, causal: bool, window=None, valid_upto=None):
    """Additive (B, S_q, S_k) float32 bias from position comparisons.

    q_pos: (B, S_q) int; k_pos: (S_k,) int broadcast over batch.
    valid_upto: (B,) or scalar — keys at positions > valid_upto are masked."""
    q = q_pos[:, :, None].to(torch.int32)
    k = k_pos[None, None, :].to(torch.int32)
    ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                    device=q.device)
    if causal:
        ok &= k <= q
    if window is not None:
        ok &= k > q - window
    if valid_upto is not None:
        v = torch.as_tensor(valid_upto, dtype=torch.int32, device=q.device)
        ok &= k <= v.reshape(-1, 1, 1)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def sdpa_ref(q, k, v, bias=None):
    """q: (B, Sq, H, hd), k/v: (B, Sk, KV, hd) — grouped-query attention,
    float32 softmax.  bias: (B, Sq, Sk) additive or None."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())
    scores = scores * (hd ** -0.5)
    if bias is not None:
        scores = scores + bias[:, None, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bkgst,btkh->bskgh", probs, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)


class Attention(nn.Module):
    def __init__(self, cfg, *, d_in=None, d_out=None, generator=None,
                 device=None):
        super().__init__()
        self.cfg = cfg
        d_in = d_in or cfg.d_model
        d_out = d_out or cfg.d_model
        hd, H, KV = cfg.hd, cfg.n_heads, cfg.n_kv_heads
        kw = dict(dtype=cfg.cdtype, param_dtype=cfg.pdtype,
                  generator=generator, device=device)
        self.wq = Linear(d_in, H * hd, use_bias=cfg.qkv_bias, **kw)
        self.wk = Linear(d_in, KV * hd, use_bias=cfg.qkv_bias, **kw)
        self.wv = Linear(d_in, KV * hd, use_bias=cfg.qkv_bias, **kw)
        self.wo = Linear(H * hd, d_out, use_bias=False, **kw)

    def qkv(self, x, x_kv, *, train: bool = False):
        cfg = self.cfg
        B, S = x.shape[:2]
        Skv = x_kv.shape[1]
        q = self.wq(x, train=train).reshape(B, S, cfg.n_heads, cfg.hd)
        k = self.wk(x_kv, train=train).reshape(B, Skv, cfg.n_kv_heads, cfg.hd)
        v = self.wv(x_kv, train=train).reshape(B, Skv, cfg.n_kv_heads, cfg.hd)
        return q, k, v

    # ---------------- full-sequence (prefill / train) ----------------

    def forward(self, x, *, angles=None, causal=True, window=None,
                cross_kv=None, return_kv=False, train: bool = False):
        """x: (B, S, d_in) → (B, S, d_out) [, (k, v) for the cache].
        ``cross_kv``: precomputed (k, v) (B, S_enc, KV, hd) to attend over,
        not causally and with no RoPE on them (q takes ``angles`` if
        given); then only y is returned.  ``train`` takes the train route:
        ``_sdpa_masked`` for every attention, the weights cast in the
        graph."""
        B, S = x.shape[:2]
        if cross_kv is not None:
            q = self.wq(x, train=train).reshape(B, S, self.cfg.n_heads,
                                                self.cfg.hd)
            if angles is not None:
                q = apply_rope(q, angles)
            # plain, as the reference's cross attention is
            # (src/repro/models/attention.py:128-134): its flash kernel is
            # causal self-attention only
            out = (self._sdpa_masked(q, *cross_kv, causal=False, window=None)
                   if train else sdpa_ref(q, *cross_kv))
            return self.wo(out.reshape(B, S, -1), train=train)
        q, k, v = self.qkv(x, x, train=train)
        if angles is not None:
            q = apply_rope(q, angles)
            k = apply_rope(k, angles)
        if train:
            out = self._sdpa_masked(q, k, v, causal=causal, window=window)
        elif causal:
            out = kops.flash_attention(q, k, v, causal=True, window=window)
        else:
            # bidirectional (the encoder): plain, as the reference routes
            # it (src/repro/models/attention.py:147-151)
            bias = None
            if window is not None:
                pos = torch.arange(S, dtype=torch.int32, device=x.device)
                bias = _mask_bias(pos[None].expand(B, S), pos, causal=False,
                                  window=window)
            out = sdpa_ref(q, k, v, bias)
        y = self.wo(out.reshape(B, S, -1), train=train)
        return (y, (k, v)) if return_kv else y

    # ---------------- chunked masked attention (the train route) ----------
    #
    # The plain path materialises the (B, H, S, S) scores.  Chunking the
    # queries keeps a (B, H, chunk, S_k) working set live; each chunk takes
    # its full softmax, so the numerics equal the unchunked path's.

    CHUNK_Q = 1024

    @staticmethod
    def _sdpa_masked(q, k, v, *, causal, window):
        """The reference's plain attention: chunked queries when S is a
        multiple of ``CHUNK_Q`` above it, else one masked ``sdpa_ref``."""
        B, S = q.shape[:2]
        chunk = Attention.CHUNK_Q
        if S > chunk and S % chunk == 0:
            return Attention._sdpa_chunked(q, k, v, causal=causal,
                                           window=window, chunk=chunk)
        bias = None
        if causal or window is not None:
            q_pos = torch.arange(S, dtype=torch.int32,
                                 device=q.device)[None].expand(B, S)
            k_pos = torch.arange(k.shape[1], dtype=torch.int32,
                                 device=q.device)
            bias = _mask_bias(q_pos, k_pos, causal=causal, window=window)
        return sdpa_ref(q, k, v, bias)

    @staticmethod
    def _sdpa_chunked(q, k, v, *, causal, window, chunk):
        """``sdpa_ref`` over query chunks of ``chunk`` rows, each masked at
        its own positions, concatenated along the sequence."""
        B, S = q.shape[:2]
        k_pos = torch.arange(k.shape[1], dtype=torch.int32, device=q.device)
        outs = []
        for i in range(S // chunk):
            bias = None
            if causal or window is not None:
                q_pos = i * chunk + torch.arange(chunk, dtype=torch.int32,
                                                 device=q.device)
                bias = _mask_bias(q_pos[None].expand(B, chunk), k_pos,
                                  causal=causal, window=window)
            outs.append(sdpa_ref(q[:, i * chunk:(i + 1) * chunk], k, v,
                                 bias))
        return torch.cat(outs, dim=1)

    # ---------------- single-token decode over a ring KV cache ---------------
    #
    # The cache is a ring of Smax slots: for full attention Smax = max_seq
    # and slot = position; for a sliding window Smax = window.  Keys carry
    # RoPE at their absolute position, so slot order does not matter and
    # the only mask is slot validity (slot <= index, every slot once the
    # ring has wrapped).

    def decode(self, x, cache, index, *, angles=None, cross_kv=None,
               cross_len=None, block_tbl=None):
        """x: (B, 1, d_in); cache: {"k", "v"}: (B, Smax, KV, hd) rings, or
        (NB, bk, KV, hd) block pools when ``block_tbl`` (B, nk) is given;
        updated in place.  index: the absolute position being written — an
        int or a (B,) tensor (every row at its own position).  An int
        broadcasts to every row and takes the same kernels.  ``cross_kv``
        (k, v) (B, S_enc, KV, hd) attends over them instead and leaves the
        cache untouched; keys at positions >= ``cross_len`` (an int or a
        (B,) tensor) are masked, so a max_seq-long cross pool holds each
        row's own encoder length.  Returns (y, cache)."""
        B = x.shape[0]
        if cross_kv is not None:
            return self._decode_cross(x, cross_kv, cross_len, angles), cache
        q, k, v = self.qkv(x, x)
        if angles is not None:
            q = apply_rope(q, angles)
            k = apply_rope(k, angles)
        index = torch.as_tensor(index, dtype=torch.int32, device=x.device)
        index = index.reshape(-1).expand(B)
        if block_tbl is not None:
            out = self._decode_paged(q, k, v, cache, index, block_tbl)
        else:       # slot index % Smax of each row's ring
            out = kops.decode_attention_write(q, k[:, 0], v[:, 0], cache["k"],
                                              cache["v"], index)
        return self.wo(out.reshape(B, 1, -1)), cache

    def _decode_cross(self, x, cross_kv, cross_len, angles):
        """One query token over cross K/V, masked past ``cross_len``.  Plain,
        as the reference's (src/repro/models/attention.py:280-296); q takes
        RoPE only if ``angles`` are given, and the decoder block gives
        none."""
        cfg = self.cfg
        B = x.shape[0]
        q = self.wq(x).reshape(B, 1, cfg.n_heads, cfg.hd)
        if angles is not None:
            q = apply_rope(q, angles)
        bias = None
        if cross_len is not None:
            Se = cross_kv[0].shape[1]
            cl = torch.as_tensor(cross_len, dtype=torch.int32,
                                 device=x.device).reshape(-1, 1, 1)
            k_pos = torch.arange(Se, dtype=torch.int32, device=x.device)
            bias = torch.where(k_pos < cl, 0.0, NEG_INF).to(
                torch.float32).expand(B, 1, Se)
        out = sdpa_ref(q, cross_kv[0], cross_kv[1], bias)
        return self.wo(out.reshape(B, 1, -1))

    # ---------------- paged decode (block-table KV pool) ------------------
    #
    # The cache leaves are a pool of NB blocks of bk positions shared by
    # every slot; row b's (nk,) table row names the physical blocks of its
    # logical sequence.  Shared prefix blocks appear in several rows at
    # once and are only read: the engine's allocator makes the write target
    # (pos // bk) a private block.

    @staticmethod
    def _decode_paged(q, k_new, v_new, cache, index, block_tbl):
        """q/k_new/v_new: (B, 1, ·, hd); cache leaves (NB, bk, KV, hd);
        block_tbl (B, nk); index (B,) int32 → (B, 1, H, hd).  The token's
        K/V land at logical key index % (nk·bk) of the row, in the block
        the table names for it."""
        # a sharded pool hands out global block ids that rem() folds into
        # the shard's local pool; unsharded, ids are < NB and it is the
        # identity.  The kernel takes ids in [0, NB) only.
        tbl = torch.remainder(block_tbl, cache["k"].shape[0])
        return kops.decode_attention_paged_write(
            q, k_new[:, 0], v_new[:, 0], cache["k"], cache["v"], tbl, index)

    @staticmethod
    def cache_len(cfg, max_seq: int) -> int:
        if cfg.sliding_window is not None:
            return min(max_seq, cfg.sliding_window)
        return max_seq

    @staticmethod
    def cache_shape(cfg, batch: int, max_seq: int):
        Smax = Attention.cache_len(cfg, max_seq)
        kv_shape = (batch, Smax, cfg.n_kv_heads, cfg.hd)
        axes = ("batch", "cache_seq", "kv_heads", None)
        return {"k": (kv_shape, axes), "v": (kv_shape, axes)}
