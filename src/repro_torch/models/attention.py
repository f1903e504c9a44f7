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
from the index and the table itself.

Decode reads no shard context: over a mesh the serve steps run the
partition (``decode_mesh`` below).  ``_decode_splitk`` is the reference's
flash-decoding over the model axis with the mesh passed explicitly (each
model rank writes its own slot of its own block and attends over its
block; the partials combine by ``pmax`` and ``psum``), and the partition
runs its body.

Training over a mesh (``forward_mesh``, the train route shard by shard):
each "model" rank projects its own q heads and the K/V heads they read,
attends, multiplies by its rows of ``wo`` and a ``psum`` over "model"
sums the ranks.  When the heads do not divide "model", q is padded per KV
group to ``Hp`` heads (the reference's ``_padded_heads``): zero ``wq``
columns, and zero ``wo`` rows (``_wo_padded``), so the pad heads add
exactly 0.  The stored leaves keep their unpadded shapes and layout; the
padding exists only in the computation.

Serving over a mesh (``prefill_mesh``, ``decode_mesh``) takes the same
rank's weights: prefill runs K4 on the rank's heads and hands its K/V to
the cache's layout; decode takes every layout ``serve_rules`` gives — the
sequence over "model" (the split-K body, ``_splitk_body``, over each
position's sequence block), the KV heads over "model" (K1's or, through a
block table, K5's write instance on the rank's heads), or neither (every
head on each rank's whole copy) — with one index for every row or one a
row.  Cross attention (``prefill_cross_mesh``, ``decode_cross_mesh``) is
head-parallel over the encoder output's K/V, plain.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models.rotary import apply_rope
from repro_torch.nn import Linear
from repro_torch.sharding import current_ctx, no_shard_ctx
from repro_torch.sharding import shard_map as sm

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
        int or a (B,) tensor (every row at its own position); an int
        broadcasts to every row and takes the same kernels.  ``cross_kv``
        (k, v) (B, S_enc, KV, hd) attends over them instead and leaves the
        cache untouched; keys at positions >= ``cross_len`` (an int or a
        (B,) tensor) are masked, so a max_seq-long cross pool holds each
        row's own encoder length.  Returns (y, cache)."""
        B = x.shape[0]
        if cross_kv is not None:
            return self._decode_cross(x, cross_kv, cross_len, angles), cache
        if isinstance(cache["k"], sm.ShardedArray):
            raise TypeError("a split cache decodes through the serve steps "
                            "over the mesh it is laid out on")
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

    # ---------------- split-K decode (flash-decoding over the model axis) --
    #
    # With the cache's sequence split over "model" (SERVE_RULES), each model
    # rank writes ITS slot in place and attends over its block; the partials
    # combine by the log-sum-exp trick — pmax(m), psum(l), psum(o), a few
    # hundred KB a layer — and the cache is never gathered.

    @staticmethod
    def _splitk_ctx(Smax: int):
        """→ (mesh, batch_axes, m) when the reference's split-K path applies
        under the current shard context, else None (its test,
        ``attention.py:418-431``; ``spec_for`` splits a ring's sequence over
        "model" exactly then)."""
        ctx = current_ctx()
        if ctx is None:
            return None
        rules, mesh = ctx
        sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
        m = sizes.get("model", 1)
        if m <= 1 or "model" not in rules.get("cache_seq"):
            return None
        if Smax % m != 0:
            return None
        batch_axes = tuple(a for a in ("pod", "data") if a in sizes)
        return mesh, batch_axes, m

    @staticmethod
    def splitk_spec(B: int, mesh, batch_axes) -> tuple:
        """The (B, Smax, KV, hd) cache's spec in the split-K body: the batch
        over ``batch_axes`` when B divides their product (else replicated,
        as the reference falls back), the sequence over "model"."""
        if B % max(sm.axis_size(mesh, batch_axes), 1) != 0:
            batch_axes = ()
        return sm.canonical((batch_axes, "model"))

    @staticmethod
    def _decode_splitk(q, k_new, v_new, cache, index, mesh, batch_axes, m):
        """The reference's ``_decode_splitk`` body over an explicit mesh,
        shard by shard: q/k_new/v_new (B, 1, ·, hd) whole, cache leaves
        whole or split, index 0-d → (out (B, 1, H, hd) whole, {"k", "v"} as
        ``ShardedArray``)."""
        kv_spec = Attention.splitk_spec(q.shape[0], mesh, batch_axes)
        row_spec = kv_spec[:1]
        kc = sm.place(cache["k"], kv_spec, mesh)
        vc = sm.place(cache["v"], kv_spec, mesh)
        out = Attention._splitk_body(
            sm.split(q[:, 0], row_spec, mesh),
            sm.split(k_new[:, 0], row_spec, mesh),
            sm.split(v_new[:, 0], row_spec, mesh), kc, vc,
            sm.split(index, (), mesh), mesh, ("model",))
        return sm.join(out, row_spec, mesh, q.device), {"k": kc, "v": vc}

    @staticmethod
    def _splitk_body(qs, ks, vs, kc, vc, idx, mesh, seq_axes):
        """Split-K over per-position values: qs {position: (B_loc, H, hd)},
        ks/vs {position: (B_loc, KV, hd)} the new rows, kc/vc the cache
        (``ShardedArray`` (B, Smax, KV, hd), its sequence split over
        ``seq_axes``), idx {position: the 0-d index, or the (B_loc,)
        indices of its rows} → {position: (B_loc, 1, H, hd)}.  Each
        position writes row b's new K/V where its block holds slot
        index[b] % Smax and attends over its block under row b's horizon
        (slots <= index[b]: every slot once row b's ring has wrapped); the
        partials combine by ``pmax`` and ``psum`` over ``seq_axes``."""
        Smax, KV = kc.shape[1], kc.shape[2]
        m = sm.axis_size(mesh, seq_axes)
        S_loc = Smax // m
        scores, m_loc = {}, {}
        with no_shard_ctx():
            for pos in sm.positions(mesh):
                k_blk, v_blk = kc.blocks[pos], vc.blocks[pos]
                qb = qs[pos]
                B, H, hd = qb.shape
                G = H // KV
                rank = sm.axis_index(mesh, pos, seq_axes)
                i = idx[pos].reshape(-1, 1)             # (1 or B, 1)
                ls = torch.remainder(i, Smax) - rank * S_loc
                in_rng = (ls >= 0) & (ls < S_loc)
                lsc = ls.clamp(0, S_loc - 1).reshape(-1).expand(B).long()
                rows = torch.arange(B, device=lsc.device)
                # the owner writes row b's new row; the others rewrite the
                # row that is there (a (B, KV, hd) temp, not a block copy)
                for blk, new in ((k_blk, ks[pos]), (v_blk, vs[pos])):
                    old = blk[rows, lsc]
                    blk[rows, lsc] = torch.where(in_rng[:, :, None],
                                                 new.to(blk.dtype), old)
                qg = qb.reshape(B, KV, G, hd)
                s = torch.einsum("bkgh,btkh->bkgt", qg.float(),
                                 k_blk.to(qb.dtype).float()) * (hd ** -0.5)
                kpos = rank * S_loc + torch.arange(S_loc, dtype=torch.int32,
                                                   device=s.device)
                s = s + torch.where(kpos <= i, 0.0, NEG_INF)[:, None, None]
                scores[pos] = s
                m_loc[pos] = s.amax(dim=-1)                   # (B, KV, G)
            m_glob = sm.pmax(m_loc, seq_axes, mesh) if m > 1 else m_loc
            l_loc, o_loc = {}, {}
            for pos in sm.positions(mesh):
                p = torch.exp(scores.pop(pos) - m_glob[pos][..., None])
                l_loc[pos] = p.sum(dim=-1)
                v_blk = vc.blocks[pos]
                o_loc[pos] = torch.einsum("bkgt,btkh->bkgh",
                                          p.to(v_blk.dtype).float(),
                                          v_blk.float())
            if m > 1:
                l_loc = sm.psum(l_loc, seq_axes, mesh)
                o_loc = sm.psum(o_loc, seq_axes, mesh)
            return sm.per_shard(mesh, lambda pos: (
                o_loc[pos] / l_loc[pos].clamp(min=1e-30)[..., None]
            ).reshape(-1, 1, qs[pos].shape[1], qs[pos].shape[2]).to(
                qs[pos].dtype))

    # ---------------- training over a mesh ---------------------------------
    #
    # When n_heads does not divide the "model" axis (qwen2.5-14b: 40 heads on
    # 16), q is padded per KV group up to the smallest head count that both
    # "model" and n_kv_heads divide, and each rank runs Hp / m heads: 48 / 16
    # = 3 there, a fifth of them pad, where replicating the attention would
    # run all 40 on every rank.

    @staticmethod
    def _padded_heads(q_shape, kv_heads):
        """→ (Hp, G, Gp) when padding applies under the current shard
        context, else None (the reference's rule).  Hp is the smallest head
        count >= H that both the "model" axis and ``kv_heads`` divide."""
        ctx = current_ctx()
        if ctx is None:
            return None
        _, mesh = ctx
        m = dict(zip(mesh.axis_names, mesh.devices.shape)).get("model", 1)
        H = q_shape[2]
        if m <= 1 or H % m == 0 or kv_heads <= 0 or H % kv_heads != 0:
            return None
        Hp = H
        while Hp % m or Hp % kv_heads:
            Hp += kv_heads
        return Hp, H // kv_heads, Hp // kv_heads

    @staticmethod
    def _wq_padded(w, b, kv_heads, G, Gp, hd):
        """wq (d, H·hd) and its bias (or None) with zero columns for the pad
        heads of each KV group: (d, KV·Gp·hd), the reference's ``qkv`` with
        ``pad_hp``."""
        w = F.pad(w.reshape(-1, kv_heads, G, hd), (0, 0, 0, Gp - G))
        if b is not None:
            b = F.pad(b.reshape(kv_heads, G, hd),
                      (0, 0, 0, Gp - G)).reshape(-1)
        return w.reshape(w.shape[0], -1), b

    @staticmethod
    def _wo_padded(w, kv_heads, G, Gp, hd):
        """wo (H·hd, d) re-laid for Hp padded heads: (KV·Gp·hd, d) with zero
        rows at the pad positions, so the pad heads contribute exactly 0."""
        d_out = w.shape[-1]
        w4 = F.pad(w.reshape(kv_heads, G, hd, d_out),
                   (0, 0, 0, 0, 0, Gp - G))
        return w4.reshape(kv_heads * Gp * hd, d_out)

    def _mesh_weights(self, w):
        """The layer's weights as each "model" rank reads them → (m, the
        padding ``(Hp, G, Gp)`` or None, n heads a rank, Gc q heads a KV
        head, kv_keep: ("model",) where the KV heads split over it, else
        (), and per-position ``weights(pos)`` → (wq, bq, wo, wk, bk, wv,
        bv) of the rank: its q columns and ``wo`` rows, padded where
        padding applies (re-laid from the whole leaves), and its KV
        heads' or every KV head's columns; ``weights(pos, kv=False)`` →
        (wq, bq, wo), reading no K/V leaf)."""
        cfg = self.cfg
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        mesh = w.mesh
        m = sm.axis_size(mesh, "model") if "model" in mesh.axis_names else 1
        pad = self._padded_heads((0, 0, H, hd), KV)
        Hc = pad[0] if pad else H           # heads computed, pad included
        n, Gc = Hc // m, Hc // KV           # heads a rank, q heads a KV head
        bias = cfg.qkv_bias
        if pad is None:                     # a rank's heads are its columns
            wq, wo = w("wq.w"), w("wo.w")
            bq = w("wq.b") if bias else None
        else:                               # re-laid from the whole leaves
            wq, wo = w("wq.w", keep=()), w("wo.w", keep=())
            bq = w("wq.b", keep=()) if bias else None
        kv_keep = ("model",) if KV % m == 0 else ()

        def weights(pos, kv=True):
            r = sm.axis_index(mesh, pos, "model") if m > 1 else 0
            wq_r, wo_r = wq[pos], wo[pos]
            bq_r = None if bq is None else bq[pos]
            if pad is not None:
                wq_r, bq_r = self._wq_padded(wq_r, bq_r, KV, *pad[1:], hd)
                cols = slice(r * n * hd, (r + 1) * n * hd)
                wq_r, wo_r = wq_r[:, cols], self._wo_padded(
                    wo_r, KV, *pad[1:], hd)[cols]
                bq_r = None if bq_r is None else bq_r[cols]
            if not kv:          # cross attention over cached K/V
                return wq_r, bq_r, wo_r
            # read (and gathered, once a step) when a position first asks
            wk_r, wv_r = (w(f"w{n}.w", kv_keep)[pos] for n in "kv")
            bk_r, bv_r = ((w(f"w{n}.b", kv_keep)[pos] for n in "kv")
                          if bias else (None, None))
            return wq_r, bq_r, wo_r, wk_r, bk_r, wv_r, bv_r
        return m, pad, n, Gc, kv_keep, weights

    def forward_mesh(self, w, xs, angles, *, causal=True, window=None,
                     x_kv=None):
        """The train route over the shard context's mesh, shard by shard.
        ``w``: the layer's parameters as ``steps.MeshParams`` gives them;
        ``xs``: {position: (B_loc, S, d_in)}, replicated over "model";
        ``angles``: {position: RoPE angles}, or None for no RoPE → {position:
        (B_loc, S, d_out)} after one ``psum`` over "model".  ``x_kv``
        {position: (B_loc, S_kv, d_in)} is cross attention: K/V are
        projected from it (the rank's KV heads, as for self attention) and
        take no RoPE, as ``forward(cross_kv=...)``'s train route."""
        hd = self.cfg.hd
        mesh = w.mesh
        m, _, n, Gc, kv_keep, weights = self._mesh_weights(w)
        part = {}
        with no_shard_ctx():
            for pos, x in xs.items():
                B, S = x.shape[:2]
                r = sm.axis_index(mesh, pos, "model") if m > 1 else 0
                wq_r, bq_r, wo_r, wk_r, bk_r, wv_r, bv_r = weights(pos)
                q = self._project(x, wq_r, bq_r).reshape(B, S, n, hd)
                src = x if x_kv is None else x_kv[pos]
                k, v = (self._project(src, w_, b_).reshape(
                    B, src.shape[1], -1, hd)
                        for w_, b_ in ((wk_r, bk_r), (wv_r, bv_r)))
                if not kv_keep:             # the KV heads this rank reads
                    k, v = self._rank_kv(k, v, r * n, n, Gc)
                if angles is not None:
                    q = apply_rope(q, angles[pos])
                    if x_kv is None:
                        k = apply_rope(k, angles[pos])
                out = self._sdpa_masked(q, k, v, causal=causal, window=window)
                part[pos] = out.reshape(B, S, n * hd) @ wo_r
        return sm.psum(part, "model", mesh) if m > 1 else part

    # ---------------- serving over a mesh ----------------------------------
    #
    # The partition ``SERVE_RULES`` lays out (``steps``' serve steps): each
    # "model" rank projects its q heads (padded where they do not divide)
    # and its KV heads (every KV head where they do not), multiplies by its
    # rows of ``wo``, and a psum over "model" sums the ranks.  Prefill
    # attends through K4 on the rank's heads and hands its K/V to the
    # cache's layout; decode attends as the cache is laid out
    # (``decode_mesh``).

    def prefill_mesh(self, w, xs, angles, *, window, max_seq, kv_spec,
                     batch_axes):
        """Causal self-attention over a prompt, shard by shard: ``xs``
        {position: (B_loc, S, d)} replicated over "model" → ({position:
        (B_loc, S, d)} after a psum over "model", {"k", "v"}: {position:
        the block of this layer's ring cache (B, Smax, KV, hd) under
        ``kv_spec``}).  Each rank attends over its heads through K4
        (``kops.flash_attention``); its K/V (the rank's KV heads, or every
        KV head) are laid out as the ring (``to_ring``) and moved to the
        cache's layout (``shard_map.relayout``: gathers over the axes that
        split them, then a local slice)."""
        cfg = self.cfg
        hd = cfg.hd
        mesh = w.mesh
        m, _, n, Gc, kv_keep, weights = self._mesh_weights(w)
        part, ring = {}, {"k": {}, "v": {}}
        with no_shard_ctx():
            for pos, x in xs.items():
                B, S = x.shape[:2]
                r = sm.axis_index(mesh, pos, "model") if m > 1 else 0
                wq_r, bq_r, wo_r, wk_r, bk_r, wv_r, bv_r = weights(pos)
                q = self._project(x, wq_r, bq_r).reshape(B, S, n, hd)
                k, v = (self._project(x, w_, b_).reshape(B, S, -1, hd)
                        for w_, b_ in ((wk_r, bk_r), (wv_r, bv_r)))
                if angles is not None:
                    q = apply_rope(q, angles[pos])
                    k = apply_rope(k, angles[pos])
                ks, vs = (k, v) if kv_keep else self._rank_kv(
                    k, v, r * n, n, Gc)
                out = kops.flash_attention(q, ks, vs, causal=True,
                                           window=window)
                part[pos] = out.reshape(B, S, n * hd) @ wo_r.to(cfg.cdtype)
                rk, rv = self.to_ring(cfg, k, v, max_seq)
                ring["k"][pos], ring["v"][pos] = rk, rv
        # the ring's layout as computed: rows over ``batch_axes``, the
        # rank's KV heads (or all of them)
        src = sm.canonical((batch_axes, None, kv_keep if m > 1 else ()))
        kv = {name: sm.relayout(vals, src, kv_spec, mesh)
              for name, vals in ring.items()}
        return (sm.psum(part, "model", mesh) if m > 1 else part), kv

    def decode_mesh(self, w, xs, angles, cache, index, kv_spec, batch_axes,
                    block_tbl=None):
        """One token over this layer's cache, shard by shard: ``xs``
        {position: (B_loc, 1, d)} split over ``batch_axes``; ``cache`` {"k",
        "v"}: ``ShardedArray`` under ``kv_spec``, the ring (B, Smax, KV,
        hd), or with ``block_tbl`` (B, nk) the block pool (NB, bk, KV, hd);
        ``index`` the 0-d index or the (B,) indices, each row's own
        (``index`` and ``block_tbl`` whole, on any device) → {position:
        (B_loc, 1, d)} after a psum over "model"; the cache written in place.
        Each rank projects its q heads and KV heads, then attends as the
        cache is laid out:

        * the sequence over "model" (the split-K layout): q (and K/V where
          the heads split) all-gathered over "model", the split-K body over
          each position's sequence block;
        * the KV heads over "model": each rank's own heads through K1's write
          instance (K5's through the block table) on its block;
        * neither: the cache is replicated over "model", so each rank writes
          all of it: q is all-gathered and each rank runs every head through
          K1's (K5's) write instance on its whole copy.

        Each rank multiplies its heads' rows of ``wo``.  A block pool lies
        whole at each position (its blocks map to no mesh axis), while the
        rows split over ``batch_axes``: each position writes the other
        batch shards' new rows too (all-gathered, a plain write), so that
        every copy stays whole, as the reference's replicated pool does; the
        table's ids are folded by ``rem(block_tbl, NB)``, as the reference
        folds them."""
        cfg = self.cfg
        H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        mesh = w.mesh
        m, pad, n, _, kv_keep, weights = self._mesh_weights(w)
        spec = sm.canonical(kv_spec)
        at = lambda d: sm.axes_of(spec[d] if len(spec) > d else None)
        paged = block_tbl is not None
        seq, heads = (() if paged else at(1)), at(2)
        if (at(0) != (() if paged else sm.axes_of(batch_axes))
                or len(spec) > 4 or (paged and at(1))
                or {a for d in (1, 2) for a in at(d)} - {"model"}):
            raise ValueError(f"{'a pool' if paged else 'a ring'} under "
                             f"{spec} is no layout serve_rules gives "
                             f"(batch over {batch_axes})")
        split_k = m > 1 and seq == ("model",)
        own = m > 1 and heads == ("model",)
        row_spec = sm.canonical((batch_axes,))
        idx = torch.as_tensor(index, dtype=torch.int32)
        if paged:                   # every row's, to write every row
            idx = idx.reshape(-1).expand(block_tbl.shape[0])
        rows_idx = sm.split(idx, row_spec if idx.ndim else (), mesh)
        qs, ks, vs, wos = {}, {}, {}, {}
        with no_shard_ctx():
            for pos, x in xs.items():
                B = x.shape[0]
                wq_r, bq_r, wo_r, wk_r, bk_r, wv_r, bv_r = weights(pos)
                q = self._project(x, wq_r, bq_r).reshape(B, 1, n, hd)
                k, v = (self._project(x, w_, b_).reshape(B, 1, -1, hd)
                        for w_, b_ in ((wk_r, bk_r), (wv_r, bv_r)))
                if angles is not None:
                    q = apply_rope(q, angles[pos])
                    k = apply_rope(k, angles[pos])
                qs[pos], ks[pos], vs[pos], wos[pos] = q, k, v, wo_r
        if m > 1 and not own:       # every head at every rank
            qs = sm.all_gather(qs, "model", mesh, dim=2)
            if kv_keep:
                ks = sm.all_gather(ks, "model", mesh, dim=2)
                vs = sm.all_gather(vs, "model", mesh, dim=2)
            if pad is not None:             # drop the pad heads
                G, Gp = pad[1:]
                qs = {p: q.reshape(q.shape[0], 1, KV, Gp, hd)[:, :, :, :G]
                      .reshape(q.shape[0], 1, H, hd) for p, q in qs.items()}
        if paged:
            tbl = sm.split(torch.remainder(block_tbl.to(torch.int32),
                                           cache["k"].shape[0]), row_spec,
                           mesh)
            if sm.axis_size(mesh, batch_axes) > 1:
                self._write_other_rows(cache, ks, vs, idx, block_tbl,
                                       batch_axes, mesh)
        if split_k:
            out = self._splitk_body(
                {p: q[:, 0] for p, q in qs.items()},
                {p: k[:, 0] for p, k in ks.items()},
                {p: v[:, 0] for p, v in vs.items()},
                cache["k"], cache["v"], rows_idx, mesh, seq)
        else:
            out = {}
            with no_shard_ctx():
                for pos, q in qs.items():
                    kc, vc = cache["k"].blocks[pos], cache["v"].blocks[pos]
                    k, v = ks[pos][:, 0], vs[pos][:, 0]
                    i = rows_idx[pos].reshape(-1).expand(q.shape[0])
                    out[pos] = (kops.decode_attention_paged_write(
                        q, k, v, kc, vc, tbl[pos], i) if paged
                        else kops.decode_attention_write(q, k, v, kc, vc, i))
        part = {}
        with no_shard_ctx():
            for pos, o in out.items():
                B = o.shape[0]
                if m > 1 and not own:       # the rank's heads of every head
                    r = sm.axis_index(mesh, pos, "model")
                    if pad is not None:     # re-pad, as the q heads were
                        o = F.pad(o.reshape(B, 1, KV, pad[1], hd),
                                  (0, 0, 0, pad[2] - pad[1]))
                    o = o.reshape(B, 1, -1, hd)[:, :, r * n:(r + 1) * n]
                part[pos] = o.reshape(B, 1, n * hd) @ wos[pos].to(cfg.cdtype)
        return sm.psum(part, "model", mesh) if m > 1 else part

    @staticmethod
    def _write_other_rows(cache, ks, vs, index, block_tbl, batch_axes, mesh):
        """A pool at each position, its rows split over ``batch_axes``: each
        position writes the new K/V rows of the other batch shards
        (all-gathered over them) into its copy, at row b's target
        ``pool[tbl[b, rpos // bk], rpos % bk]``, rpos = index[b] % (nk·bk)
        (its own rows its write instance writes)."""
        NB, bk = cache["k"].shape[:2]
        nk = block_tbl.shape[1]
        every = {n: sm.all_gather({p: t[:, 0] for p, t in vals.items()},
                                  batch_axes, mesh, dim=0)
                 for n, vals in (("k", ks), ("v", vs))}
        memo: dict = {}
        with no_shard_ctx():
            for pos in every["k"]:
                k_all, v_all = every["k"][pos], every["v"][pos]
                dev = k_all.device
                if dev not in memo:
                    i = index.to(dev).long()
                    t = torch.remainder(block_tbl.to(dev).long(), NB)
                    rpos = torch.remainder(i, nk * bk)
                    blk = t[torch.arange(t.shape[0], device=dev), rpos // bk]
                    memo[dev] = blk, rpos % bk
                blk, off = memo[dev]
                B_loc = ks[pos].shape[0]
                r = sm.axis_index(mesh, pos, batch_axes)
                keep = torch.ones(k_all.shape[0], dtype=torch.bool,
                                  device=dev)
                keep[r * B_loc:(r + 1) * B_loc] = False
                for name, new in (("k", k_all), ("v", v_all)):
                    pool = cache[name].blocks[pos]
                    pool[blk[keep], off[keep]] = new[keep].to(pool.dtype)

    # Cross attention over a mesh (the encoder-decoder): each rank projects
    # its q heads and attends over its KV heads of the encoder output (every
    # KV head where they do not divide "model"), plain as on one device.
    # The prefill hands the K/V it projected to the cache's layout (the
    # encoder's length kept: "enc_seq" maps to no mesh axis); the decode
    # reads the rank's KV heads where the cache splits them over "model".

    def _cross_mesh(self, w, xs, kvs, bias=None):
        """The ranks' cross attention: ``xs`` {position: (B_loc, S, d)},
        ``kvs`` {position: (k, v)} (B_loc, S_kv, ·, hd), the rank's KV
        heads or every KV head, ``bias`` {position: (B_loc, S, S_kv)} or
        None → {position: (B_loc, S, d)} after a psum over "model"."""
        cfg = self.cfg
        hd, mesh = cfg.hd, w.mesh
        m, _, n, Gc, kv_keep, weights = self._mesh_weights(w)
        part = {}
        with no_shard_ctx():
            for pos, x in xs.items():
                B, S = x.shape[:2]
                r = sm.axis_index(mesh, pos, "model") if m > 1 else 0
                wq_r, bq_r, wo_r = weights(pos, kv=False)
                q = self._project(x, wq_r, bq_r).reshape(B, S, n, hd)
                k, v = kvs[pos]
                if not kv_keep:             # the KV heads this rank reads
                    k, v = self._rank_kv(k, v, r * n, n, Gc)
                out = (self._sdpa_masked(q, k, v, causal=False, window=None)
                       if bias is None else sdpa_ref(q, k, v, bias[pos]))
                part[pos] = out.reshape(B, S, n * hd) @ wo_r.to(cfg.cdtype)
        return sm.psum(part, "model", mesh) if m > 1 else part

    def prefill_cross_mesh(self, w, xs, enc_out, kv_spec, batch_axes):
        """Cross attention over a prompt, shard by shard: ``xs`` {position:
        (B_loc, S, d)} over ``enc_out`` {position: (B_loc, S_enc, d)} →
        ({position: (B_loc, S, d)}, {"k", "v"}: {position: the block of
        this layer's cross K/V (B, S_enc, KV, hd) under ``kv_spec``})."""
        hd, mesh = self.cfg.hd, w.mesh
        m, _, _, _, kv_keep, weights = self._mesh_weights(w)
        kvs = {}
        with no_shard_ctx():
            for pos, e in enc_out.items():
                _, _, _, wk_r, bk_r, wv_r, bv_r = weights(pos)
                kvs[pos] = tuple(self._project(e, w_, b_).reshape(
                    e.shape[0], e.shape[1], -1, hd)
                    for w_, b_ in ((wk_r, bk_r), (wv_r, bv_r)))
        src = sm.canonical((batch_axes, None, kv_keep if m > 1 else ()))
        kv = {name: sm.relayout({p: t[i] for p, t in kvs.items()}, src,
                                kv_spec, mesh)
              for i, name in enumerate(("k", "v"))}
        return self._cross_mesh(w, xs, kvs), kv

    def decode_cross_mesh(self, w, xs, cache, cross_len):
        """One token over this layer's cross K/V, shard by shard: ``xs``
        {position: (B_loc, 1, d)}; ``cache`` {"k", "v"}: ``ShardedArray``
        (B, S_enc, KV, hd), the batch over the batch axes and the KV heads
        over "model" where they divide it; ``cross_len`` (B,) ``ShardedArray``
        → {position: (B_loc, 1, d)}: keys at positions >= the row's
        ``cross_len`` are masked (``_decode_cross``)."""
        kvs, bias = {}, {}
        for pos in xs:
            k, v = cache["k"].blocks[pos], cache["v"].blocks[pos]
            kvs[pos] = (k, v)
            cl = cross_len.blocks[pos].reshape(-1, 1, 1)
            k_pos = torch.arange(k.shape[1], dtype=torch.int32,
                                 device=k.device)
            bias[pos] = torch.where(k_pos < cl, 0.0, NEG_INF).to(
                torch.float32).expand(k.shape[0], 1, k.shape[1])
        return self._cross_mesh(w, xs, kvs, bias)

    def _project(self, x, w, b):
        """A Linear's train-route product on given (cast) weights."""
        y = x.to(self.cfg.cdtype) @ w.to(self.cfg.cdtype)
        return y if b is None else y + b.to(y.dtype)

    @staticmethod
    def _rank_kv(k, v, h0, n, Gc):
        """Of every KV head (B, S, KV, hd), those that q heads h0 .. h0+n-1
        read, where q head h reads KV head h // Gc: whole groups, part of
        one group, or one KV head per q head when neither."""
        if n % Gc == 0 or Gc % n == 0:
            sel = slice(h0 // Gc, h0 // Gc + max(n // Gc, 1))
            return k[:, :, sel], v[:, :, sel]
        idx = torch.div(h0 + torch.arange(n, device=k.device), Gc,
                        rounding_mode="floor")
        return k[:, :, idx], v[:, :, idx]

    @staticmethod
    def to_ring(cfg, k, v, max_seq: int):
        """Full-sequence K/V (B, S, ·, hd) laid out as the ring cache sized
        for ``max_seq`` (position p lives at slot p % W) → (k, v)."""
        S = k.shape[1]
        W = Attention.cache_len(cfg, max_seq)
        if W < S:
            shift = (S - W) % W
            k = torch.roll(k[:, S - W:], shift, dims=1)
            v = torch.roll(v[:, S - W:], shift, dims=1)
        elif W > S:
            pad = (0, 0, 0, 0, 0, W - S)
            k, v = F.pad(k, pad), F.pad(v, pad)
        return k, v

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
