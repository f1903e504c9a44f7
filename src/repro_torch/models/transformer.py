"""The language model of every family (``repro.models.transformer.LM``):
dense, MoE, VLM (M-RoPE and a patch prefix), SSM (Mamba1 and Mamba2),
hybrid (zamba2) and encoder-decoder (seamless).

The reference stacks the layers' parameters on a leading axis and runs them
under ``lax.scan``; here every layer is its own module in an
``nn.ModuleList`` and a Python loop walks them.  A hybrid model holds its
Mamba2 layers as G groups of A (``blocks[g][i]``), the shared attention
blocks (``shared[s]``) and one down projection per group (``down[g]``); an
encoder-decoder model its ``enc_blocks`` and ``dec_blocks``.
The decode cache keeps the reference's tree — ``{"index", "layers": {"k",
"v"}}`` (dense, MoE, VLM), ``{"index", "layers": {"h", "conv"}}`` (SSM),
``{"index", "mamba": {"h", "conv"}, "attn": {"k", "v"}}`` (hybrid, mamba
leaves ``(G, A, B, …)``), ``{"index", "self": {"k", "v"}, "cross": {"k",
"v"}, "cross_len"}`` (enc-dec) — and decode writes it in place through
per-layer views, where the reference donates the buffers to ``jit``.

Entry points:
  LM(cfg, device=..., seed=...)            seeded init, the reference's
                                           distributions; on cuda unless
                                           device="cpu" is asked for
  model(inputs)                            -> (logits, aux)   # LM.apply;
                                           aux sums the MoE layers'
                                           lb_loss, z_loss, drop_frac
  model(inputs, train=True)                the train route (kernels off,
                                           weights cast in the graph)
  model(inputs, return_hidden=True)        -> (final-norm hidden, aux)
  model.forward_mesh(w, inputs, batch_axes) the train route over a mesh
                                           (every family), shard by shard
  model.logits_mesh(w, h)                  -> vocab-split logits
  model.prefill_mesh / decode_mesh         the serve steps over a mesh
                                           (every family, every cache
                                           layout), shard by shard
  model.prefill(inputs, max_seq)           -> (last-position logits, cache)
  model.decode(tokens, cache)              -> (logits, cache); both on one
                                           device: under a shard context
                                           they raise (the serve steps run
                                           the partition)
  LM.cache_spec(cfg, batch, max_seq)       -> tree of (shape, dtype, axes)

On the train route each layer (a hybrid's each group, an encoder-decoder's
each encoder and decoder layer) is one checkpoint under ``cfg.remat``
("full"): ``remat``, the reference's ``jax.checkpoint`` with
``nothing_saveable``.

``inputs`` is ``{"tokens": (B, S)}``, plus ``"patches"`` (B, P, d_model) for
the VLM (they replace the first P embeddings) and ``"frames"`` (B, S_enc,
d_model) for the encoder-decoder.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention
from repro_torch.models.blocks import (
    CrossDecoderBlock, DecoderBlock, EncoderBlock, SharedAttnBlock, SSMBlock,
    norm_cls, norm_mesh,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.moe import MoE
from repro_torch.models.rotary import (
    mrope_positions, rope_angles, text_positions,
)
from repro_torch.nn import Embedding, LayerNorm, Linear
from repro_torch.sharding import current_ctx, no_shard_ctx, shard_ctx
from repro_torch.sharding import shard_map as sm


def _angles(cfg: ModelConfig, batch: int, seq: int, start=0, device=None):
    if cfg.ssm is not None and cfg.hybrid is None:
        return None
    if cfg.m_rope:
        # a one-token step (decode tick, verify lane) is text: t = h = w
        pos = mrope_positions(batch, seq,
                              cfg.n_vision_patches if seq > 1 else 0, start,
                              device=device)
        return rope_angles(pos, cfg.hd, cfg.rope_theta, cfg.m_rope_sections)
    pos = text_positions(batch, seq, start, device=device)
    return rope_angles(pos, cfg.hd, cfg.rope_theta)


def _hybrid_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.hybrid.attn_every


def _stack_states(states: list[dict]) -> dict:
    return {n: torch.stack([s[n] for s in states]) for n in states[0]}


def remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, checkpointed when ``cfg.remat`` is not "none" and
    grad is on: the reference's ``jax.checkpoint(..., nothing_saveable)``
    around a layer or a hybrid group.  ``torch.utils.checkpoint`` without
    reentry keeps only what the block is given (its input and the tensors
    it closes over) and runs ``fn`` again in the backward, the shard map's
    collectives included, so a cost counter records them again, as the
    reference's recompute runs them again.  The recompute runs the whole
    block (no early stop), and under the shard context the forward ran in:
    the autograd engine runs a card's backward on a thread of its own,
    which does not see this thread's context."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    ctx = current_ctx()

    def run(*a):
        with shard_ctx(*ctx) if ctx else no_shard_ctx():
            return fn(*a)
    with set_checkpoint_early_stop(False):
        return checkpoint(run, *args, use_reentrant=False,
                          preserve_rng_state=False)


def run_block(cfg: ModelConfig, blk: nn.Module, *args, **kw):
    """``blk(*args, **kw)``; on the train route (``train=True``) one
    ``remat`` checkpoint over the parameters the block holds now (under the
    train step's ``functional_call``, the cast ones: the recompute runs
    after that call has put the masters back)."""
    if not kw.get("train"):
        return blk(*args, **kw)
    params = dict(blk.named_parameters())
    return remat(cfg, lambda *a: torch.func.functional_call(
        blk, params, a, kw), *args)


class _HybridGroup(nn.Module):
    """One zamba2 group as one module, so that ``run_block`` checkpoints it
    whole (the reference's ``group_body``): its SSM blocks, then the
    shared block over concat(h, emb0) and the group's down projection."""

    def __init__(self, blocks, shared, down):
        super().__init__()
        self.blocks, self.shared, self.down = blocks, shared, down

    def forward(self, h, emb0, *, angles=None, train: bool = False):
        for blk in self.blocks:
            h = blk(h, train=train)
        return h + self.down(self.shared(torch.cat([h, emb0], dim=-1),
                                         angles=angles, train=train),
                             train=train)


def _layer_specs(specs: dict, depth: int) -> dict:
    """{name: the spec of one layer's block}: each stacked leaf's spec less
    its ``depth`` leading (unsplit) layer dims."""
    return {n: sm.canonical(spec)[depth:] for n, spec in specs.items()}


def _stack_blocks(layers: list[dict]) -> dict:
    """[{name: {position: a layer's block}}] → {name: {position: the
    blocks stacked on a new leading dim}}; blocks that positions share
    stack once."""
    out: dict = {}
    for n in layers[0]:
        memo: dict = {}
        out[n] = {}
        for p in layers[0][n]:
            blocks = [layer[n][p] for layer in layers]
            key = tuple(id(b) for b in blocks)
            if key not in memo:
                memo[key] = torch.stack(blocks)
            out[n][p] = memo[key]
    return out


def _sharded(tree: dict, specs: dict, mesh) -> dict:
    """{name: {position: block}} → {name: ``ShardedArray``} under
    ``specs``, whole shapes from the blocks; one {position: block} alone
    where ``specs`` is a spec."""
    if not isinstance(specs, dict):
        blk = next(iter(tree.values()))
        shape = tuple(n * sm.axis_size(mesh, specs[d] if d < len(specs)
                                       else None)
                      for d, n in enumerate(blk.shape))
        return sm.ShardedArray(tree, specs, mesh, shape, blk.dtype)
    return {n: _sharded(tree[n], specs[n], mesh) for n in specs}


def map_spec(fn, spec):
    """fn over the leaves of a cache-spec tree (nested dicts)."""
    if isinstance(spec, dict):
        return {k: map_spec(fn, v) for k, v in spec.items()}
    return fn(spec)


def zero_aux(device=None) -> dict:
    z = lambda: torch.zeros((), dtype=torch.float32, device=device)
    return {"lb_loss": z(), "z_loss": z(), "drop_frac": z()}


def add_aux(total: dict, aux) -> dict:
    """``total`` plus a layer's aux, over ``total``'s keys (the
    reference's ``_aux_of`` and its sum over the layer scan)."""
    if not aux:
        return total
    return {k: v + aux[k].float() if k in aux else v
            for k, v in total.items()}


class LM(nn.Module):
    def __init__(self, cfg: ModelConfig, *, device="cuda", seed: int = 0):
        super().__init__()
        # "meta" builds the shapes and dtypes alone (``steps``' axes helpers)
        device = (torch.device(device) if torch.device(device).type == "meta"
                  else resolve_device(device))
        self.cfg = cfg
        gen = (None if device.type == "meta" else
               torch.Generator(device=device).manual_seed(seed))
        kw = dict(generator=gen, device=device)
        self.embed = Embedding(cfg.vocab, cfg.d_model, param_dtype=cfg.pdtype,
                               **kw)
        if cfg.enc_dec:
            self.enc_blocks = nn.ModuleList(EncoderBlock(cfg, **kw)
                                            for _ in range(cfg.n_enc_layers))
            self.dec_blocks = nn.ModuleList(CrossDecoderBlock(cfg, **kw)
                                            for _ in range(cfg.n_layers))
            self.ln_enc = LayerNorm(cfg.d_model, eps=cfg.norm_eps,
                                    param_dtype=cfg.pdtype, device=device)
        elif cfg.hybrid is not None:
            G, A = _hybrid_groups(cfg), cfg.hybrid.attn_every
            self.blocks = nn.ModuleList(
                nn.ModuleList(SSMBlock(cfg, **kw) for _ in range(A))
                for _ in range(G))
            self.shared = nn.ModuleList(
                SharedAttnBlock(cfg, **kw)
                for _ in range(cfg.hybrid.n_shared_blocks))
            self.down = nn.ModuleList(
                Linear(2 * cfg.d_model, cfg.d_model, dtype=cfg.cdtype,
                       use_bias=False, param_dtype=cfg.pdtype, **kw)
                for _ in range(G))
        elif cfg.ssm is not None:
            self.blocks = nn.ModuleList(SSMBlock(cfg, **kw)
                                        for _ in range(cfg.n_layers))
        else:
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
        """Refresh every compute-dtype weight copy, the Linears' and the
        expert stacks' (after loading)."""
        for m in self.modules():
            if isinstance(m, (Linear, MoE)):
                m.recast()

    # ------------------------------------------------------------- shared

    def _embed(self, tokens, inputs=None):
        """Token embeddings; a VLM's patches replace the first P rows."""
        h = self.embed(tokens, dtype=self.cfg.cdtype)
        if (self.cfg.family == "vlm" and inputs is not None
                and "patches" in inputs):
            patches = inputs["patches"]
            h = torch.cat([patches.to(h.dtype), h[:, patches.shape[1]:]],
                          dim=1)
        return h

    def _logits(self, h, train: bool = False):
        if self.lm_head is None:
            return self.embed.attend(h)
        return self.lm_head(h.float(), train=train)

    # ------------------------------------------------------------- forward

    def forward(self, inputs, *, train: bool = False,
                return_hidden: bool = False):
        """Full-sequence forward (the reference's ``LM.apply``).  inputs:
        {"tokens": (B, S)} plus the family's "patches" or "frames" →
        (logits (B, S, V) float32, aux), or with ``return_hidden`` the
        final-norm hidden states (B, S, d) in their place (chunked CE
        makes the logits itself).

        ``train=True`` is the train route, which the caller picks: no
        kernel runs (attention takes ``Attention._sdpa_masked``, Mamba2 the
        plain scan, Mamba1 an out-of-place recurrence), and every Linear
        and expert stack casts its weight inside the autograd graph.  The
        serve route (the default) runs the kernels and the kept casts."""
        tokens = inputs["tokens"]
        B, S = tokens.shape
        h = self._embed(tokens, inputs)
        angles = _angles(self.cfg, B, S, device=h.device)
        aux = zero_aux(h.device)
        cfg = self.cfg
        if cfg.enc_dec:
            enc_out = self._encode(inputs["frames"], train)
            for blk in self.dec_blocks:
                h = run_block(cfg, blk, h, enc_out=enc_out, angles=angles,
                              train=train)
        elif cfg.hybrid is not None:
            h = self._apply_hybrid(h, angles, train)
        elif cfg.ssm is not None:
            for blk in self.blocks:
                h = run_block(cfg, blk, h, train=train)
        else:
            for blk in self.blocks:
                h, a = run_block(cfg, blk, h, angles=angles,
                                 return_aux=True, train=train)
                aux = add_aux(aux, a)
        h = self.ln_f(h)
        if return_hidden:
            return h, aux
        return self._logits(h, train), aux

    # ------------------------------------------------------- over a mesh
    #
    # The embedding table ("vocab", "embed") and the untied readout
    # ("embed", "vocab") split the vocabulary over "model": each rank looks
    # up the tokens in its range and zeros the rest, a psum joins them, and
    # the logits stay split, each rank holding its range's columns.

    def forward_mesh(self, w, inputs, batch_axes):
        """The train route over the shard context's mesh, shard by shard.
        ``w``: the parameters as ``steps.MeshParams`` gives them;
        ``inputs`` {name: {position: its batch shard}}: "tokens" (B_loc,
        S), and the family's "patches" or "frames", the batch split over
        ``batch_axes`` → ({position: final-norm hidden (B_loc, S, d)},
        aux).  The SSM stack, the hybrid's groups, the VLM's patch prefix
        and the encoder-decoder follow ``forward``'s train route."""
        cfg = self.cfg
        h = self._prefix_mesh(self._embed_mesh(w, inputs["tokens"]), inputs)
        angles = self._angles_mesh(h)
        aux = zero_aux(h[sm.positions(w.mesh)[0]].device)
        if cfg.enc_dec:
            enc = self._encode_mesh(w, inputs["frames"])
            for i, blk in enumerate(self.dec_blocks):
                h = remat(cfg, lambda h, blk=blk, i=i: blk.forward_mesh(
                    w.scoped(f"dec_blocks.{i}"), h, enc, angles), h)
        elif cfg.hybrid is not None:
            h = self._hybrid_mesh(w, h, angles)
        elif cfg.ssm is not None:
            for i, blk in enumerate(self.blocks):
                h = remat(cfg, lambda h, blk=blk, i=i: blk.forward_mesh(
                    w.scoped(f"blocks.{i}"), h), h)
        else:
            for i, blk in enumerate(self.blocks):
                h, a = remat(cfg, lambda h, blk=blk, i=i: blk.forward_mesh(
                    w.scoped(f"blocks.{i}"), h, angles, batch_axes), h)
                aux = add_aux(aux, a)
        return norm_mesh(self.ln_f, w.sub("ln_f"), h), aux

    def _embed_mesh(self, w, tokens):
        """{position: (B_loc, S) ids} → {position: (B_loc, S, d)} in the
        compute dtype, the vocabulary split over "model" (above)."""
        table, vocab = w("embed.table"), w.axes("embed.table", 0)
        h = {}
        for pos, t in tokens.items():
            V_loc = table[pos].shape[0]
            idx = t.long() - self._vocab_start(w, pos, vocab, V_loc)
            mine = (idx >= 0) & (idx < V_loc)
            e = table[pos][idx.clamp(0, V_loc - 1)]
            h[pos] = torch.where(mine[..., None], e, 0).to(self.cfg.cdtype)
        return sm.psum(h, vocab, w.mesh) if vocab else h

    def _angles_mesh(self, xs, start=0):
        """{position: RoPE angles for its (B_loc, S, ·) shard from position
        ``start``: an int, or {position: its 0-d start or its rows'
        (B_loc,) starts}}, made once a device and start (None where the
        family has no RoPE)."""
        memo: dict = {}
        out = {}
        for p, x in xs.items():
            s = start[p] if isinstance(start, dict) else start
            key = (x.device, id(s))
            if key not in memo:
                memo[key] = _angles(self.cfg, x.shape[0], x.shape[1],
                                    start=s, device=x.device)
            out[p] = memo[key]
        return out

    # The serve steps over a mesh (``steps``' prefill and decode over
    # laid-out weights, every family): the embedding and the readout split
    # the vocabulary over "model", each layer's heads, MLP columns, experts
    # or SSM channels or heads split over it, and the logits come back
    # whole (an all-gather over the vocabulary's axes, then over the
    # batch's), as the reference's ``out_shardings`` replicate them.  The
    # cache comes back as the one-device tree less "index", its leaves
    # ``ShardedArray`` laid out by ``specs`` (``steps.cache_specs``).

    def prefill_mesh(self, w, inputs, batch_axes, max_seq, specs):
        """``inputs`` {name: {position: its batch shard}}: "tokens" (B_loc,
        S) and the family's "patches" or "frames", the batch split over
        ``batch_axes``; ``specs`` the cache's tree of specs → (the last
        position's logits (B, 1, V) float32, whole, on the first
        position's device; the cache tree, "index" aside)."""
        cfg = self.cfg
        mesh = w.mesh
        h = self._prefix_mesh(self._embed_mesh(w, inputs["tokens"]), inputs)
        angles = self._angles_mesh(h)
        if cfg.enc_dec:
            h, cache = self._prefill_encdec_mesh(
                w, h, inputs["frames"], angles, batch_axes, max_seq, specs)
        elif cfg.hybrid is not None:
            h, cache = self._prefill_hybrid_mesh(w, h, angles, batch_axes,
                                                 max_seq, specs)
        else:
            layer = _layer_specs(specs["layers"], 1)
            states = []
            for i, blk in enumerate(self.blocks):
                if cfg.ssm is not None:
                    h, st = blk.prefill_mesh(w.sub(f"blocks.{i}"), h,
                                             batch_axes, layer)
                else:
                    h, st = blk.prefill_mesh(w.sub(f"blocks.{i}"), h, angles,
                                             batch_axes, max_seq=max_seq,
                                             kv_spec=layer["k"])
                states.append(st)
            cache = {"layers": _sharded(_stack_blocks(states),
                                        specs["layers"], mesh)}
        last = {p: x[:, -1:] for p, x in h.items()}
        return self._whole_logits(w, last, batch_axes), cache

    def _prefix_mesh(self, h, inputs):
        """A VLM's patches over the first rows of each batch shard
        (``_embed``); ``h`` as it is otherwise."""
        patches = inputs.get("patches") if self.cfg.family == "vlm" else None
        if patches is None:
            return h
        return {p: torch.cat([patches[p].to(x.dtype),
                              x[:, patches[p].shape[1]:]], dim=1)
                for p, x in h.items()}

    def _prefill_hybrid_mesh(self, w, h, angles, batch_axes, max_seq,
                             specs):
        """``_prefill_hybrid`` over a mesh: each group's Mamba2 layers
        keep their state blocks, its shared block its ring blocks; the
        group's ``down`` as ``_hybrid_mesh``."""
        emb0 = h
        n = len(self.shared)
        m_spec = _layer_specs(specs["mamba"], 2)
        a_spec = _layer_specs(specs["attn"], 1)["k"]
        mamba, attn = [], []
        for g, group, shared, _ in self._groups():
            states = []
            for i, blk in enumerate(group):
                h, st = blk.prefill_mesh(w.sub(f"blocks.{g}.{i}"), h,
                                         batch_axes, m_spec)
                states.append(st)
            mamba.append(_stack_blocks(states))
            x2, kv = shared.prefill_mesh(
                w.sub(f"shared.{g % n}"),
                {p: torch.cat([x, emb0[p]], dim=-1) for p, x in h.items()},
                angles, batch_axes, max_seq=max_seq, kv_spec=a_spec)
            h = self._down_mesh(w, g, h, x2)
            attn.append(kv)
        return h, {"mamba": _sharded(_stack_blocks(mamba), specs["mamba"],
                                     w.mesh),
                   "attn": _sharded(_stack_blocks(attn), specs["attn"],
                                    w.mesh)}

    def _down_mesh(self, w, g, h, x2):
        """h + the group's down projection of the shared block's output
        (replicated over "model": every rank runs all of it)."""
        down = w(f"down.{g}.w")
        cd = self.cfg.cdtype
        return {p: x + x2[p].to(cd) @ down[p].to(cd) for p, x in h.items()}

    def _prefill_encdec_mesh(self, w, h, frames, angles, batch_axes,
                             max_seq, specs):
        """``_prefill_encdec`` over a mesh: the encoder over every frame
        (``_encode_mesh``), then the decoder over the prompt, keeping each
        layer's self ring and its cross K/V at the encoder's length;
        cross_len = S_enc for every row."""
        enc = self._encode_mesh(w, frames)
        layer = {"self": _layer_specs(specs["self"], 1)["k"],
                 "cross": _layer_specs(specs["cross"], 1)["k"]}
        selfs, crosses = [], []
        for i, blk in enumerate(self.dec_blocks):
            h, kv = blk.prefill_mesh(w.sub(f"dec_blocks.{i}"), h, enc, angles,
                                     batch_axes, max_seq=max_seq, specs=layer)
            selfs.append(kv["self"])
            crosses.append(kv["cross"])
        cross_len = {p: torch.full((f.shape[0],), f.shape[1],
                                   dtype=torch.int32, device=f.device)
                     for p, f in frames.items()}
        return h, {
            "self": _sharded(_stack_blocks(selfs), specs["self"], w.mesh),
            "cross": _sharded(_stack_blocks(crosses), specs["cross"],
                              w.mesh),
            "cross_len": _sharded(sm.relayout(cross_len, (batch_axes,),
                                              specs["cross_len"], w.mesh),
                                  specs["cross_len"], w.mesh)}

    def decode_mesh(self, w, tokens, cache, batch_axes, specs):
        """{position: (B_loc, 1) ids} → (logits (B, 1, V) float32, whole,
        on the first position's device; the cache, its ``ShardedArray``
        leaves laid out by ``specs`` and written in place, index + 1).
        ``cache["index"]`` is the 0-d index or the (B,) indices (each row
        at its own position: its RoPE angles and its horizon); a
        "block_tbl" (B, nk) pages the self-attention K/V (an
        encoder-decoder's cross K/V stay dense).  Both stay whole."""
        cfg = self.cfg
        index, tbl = cache["index"], cache.get("block_tbl")
        h = self._embed_mesh(w, tokens)
        index_t = torch.as_tensor(index, dtype=torch.int32)
        angles = self._angles_mesh(h, start=sm.split(
            index_t, (batch_axes,) if index_t.ndim else (), w.mesh))
        if cfg.enc_dec:
            layer = {"self": _layer_specs(specs["self"], 1)["k"]}
            for i, blk in enumerate(self.dec_blocks):
                state = {n: {k: leaf[i] for k, leaf in cache[n].items()}
                         for n in ("self", "cross")}
                h = blk.decode_mesh(w.sub(f"dec_blocks.{i}"), h, angles,
                                    state, index, layer, cache["cross_len"],
                                    batch_axes, tbl)
        elif cfg.hybrid is not None:
            emb0 = h
            n = len(self.shared)
            a_spec = _layer_specs(specs["attn"], 1)["k"]
            mamba, attn = cache["mamba"], cache["attn"]
            for g, group, shared, _ in self._groups():
                for i, blk in enumerate(group):
                    h = blk.decode_mesh(w.sub(f"blocks.{g}.{i}"), h, {
                        k: leaf[g, i] for k, leaf in mamba.items()})
                x2 = shared.decode_mesh(
                    w.sub(f"shared.{g % n}"),
                    {p: torch.cat([x, emb0[p]], dim=-1) for p, x in h.items()},
                    angles, {k: leaf[g] for k, leaf in attn.items()}, index,
                    a_spec, batch_axes, tbl)
                h = self._down_mesh(w, g, h, x2)
        else:
            layer_spec = _layer_specs(specs["layers"], 1)["k"] \
                if cfg.ssm is None else None
            layers = cache["layers"]
            for i, blk in enumerate(self.blocks):
                state = {k: leaf[i] for k, leaf in layers.items()}
                if cfg.ssm is not None:
                    h = blk.decode_mesh(w.sub(f"blocks.{i}"), h, state)
                else:
                    h = blk.decode_mesh(w.sub(f"blocks.{i}"), h, angles,
                                        batch_axes, state, index, layer_spec,
                                        tbl)
        return (self._whole_logits(w, h, batch_axes),
                {**cache, "index": index + 1})

    def _whole_logits(self, w, h, batch_axes):
        """{position: (B_loc, S, d) hidden} → the float32 logits (B, S, V)
        after the final norm, gathered whole: the first position's."""
        mesh = w.mesh
        logits, _, vocab = self.logits_mesh(
            w, norm_mesh(self.ln_f, w.sub("ln_f"), h))
        if vocab:
            logits = sm.all_gather(logits, vocab, mesh, dim=2)
        if batch_axes:
            logits = sm.all_gather(logits, batch_axes, mesh, dim=0)
        return logits[sm.positions(mesh)[0]]

    def _encode_mesh(self, w, frames):
        """``_encode`` over a mesh: {position: (B_loc, S_enc, d) frames} →
        {position: the normed encoder output}."""
        x = {p: f.to(self.cfg.cdtype) for p, f in frames.items()}
        angles = self._angles_mesh(x)
        for i, blk in enumerate(self.enc_blocks):
            x = remat(self.cfg, lambda x, blk=blk, i=i: blk.forward_mesh(
                w.scoped(f"enc_blocks.{i}"), x, angles), x)
        return norm_mesh(self.ln_enc, w.sub("ln_enc"), x)

    def _hybrid_mesh(self, w, h, angles):
        """``_apply_hybrid`` over a mesh: each group's SSM blocks, then its
        round-robin shared block over concat(h, emb0) and its ``down``
        (split over "data" alone: every "model" rank runs all of it)."""
        emb0 = h
        n = len(self.shared)

        def group_body(h, g, group, shared, w):
            for i, blk in enumerate(group):
                h = blk.forward_mesh(w.sub(f"blocks.{g}.{i}"), h)
            x2 = shared.forward_mesh(w.sub(f"shared.{g % n}"), {
                p: torch.cat([x, emb0[p]], dim=-1) for p, x in h.items()},
                angles)
            down = w(f"down.{g}.w")
            return {p: x + x2[p].to(self.cfg.cdtype) @ down[p]
                    for p, x in h.items()}
        for g, group, shared, _ in self._groups():
            h = remat(self.cfg, lambda h, g=g, group=group, shared=shared:
                      group_body(h, g, group, shared, w.scoped()), h)
        return h

    @staticmethod
    def _vocab_start(w, pos, vocab, V_loc) -> int:
        return sm.axis_index(w.mesh, pos, vocab) * V_loc if vocab else 0

    def logits_mesh(self, w, h):
        """{position: final-norm hidden} → ({position: float32 logits
        (B_loc, S, V_loc) of the position's vocabulary range}, {position:
        the range's first id}, the axes splitting the vocabulary)."""
        if self.lm_head is None:
            mat, vocab = w("embed.table"), w.axes("embed.table", 0)
            logits = {p: x.float() @ mat[p].float().t() for p, x in h.items()}
        else:
            mat, vocab = w("lm_head.w"), w.axes("lm_head.w", 1)
            logits = {p: x.float() @ mat[p].float() for p, x in h.items()}
        start = {p: self._vocab_start(w, p, vocab, t.shape[-1])
                 for p, t in logits.items()}
        return logits, start, vocab

    def _encode(self, frames, train: bool = False):
        """The encoder over every frame: (B, S_enc, d) → the normed encoder
        output (the reference's ``_apply_encdec`` first half)."""
        B, Se = frames.shape[:2]
        angles = _angles(self.cfg, B, Se, device=frames.device)
        x = frames.to(self.cfg.cdtype)
        for blk in self.enc_blocks:
            x = run_block(self.cfg, blk, x, angles=angles, train=train)
        return self.ln_enc(x)

    def _groups(self):
        """(g, the group's SSM blocks, its shared block, its down
        projection): shared blocks go round-robin over the groups."""
        n = len(self.shared)
        return ((g, group, self.shared[g % n], down) for g, (group, down)
                in enumerate(zip(self.blocks, self.down)))

    def _apply_hybrid(self, h, angles, train: bool = False):
        """Zamba2: groups of attn_every SSM layers, each followed by a
        shared attention block over concat(h, emb0) and the group's down
        projection."""
        emb0 = h
        for _, group, shared, down in self._groups():
            h = run_block(self.cfg, _HybridGroup(group, shared, down), h,
                          emb0, angles=angles, train=train)
        return h

    # ------------------------------------------------------------- cache

    @staticmethod
    def cache_spec(cfg: ModelConfig, batch: int, max_seq: int):
        """Tree of (shape, dtype, logical_axes) describing the decode state."""
        L = cfg.n_layers
        spec = {"index": ((), torch.int32, ())}
        kv = Attention.cache_shape(cfg, batch, max_seq)
        if cfg.enc_dec:
            spec["self"] = {n: ((L,) + s, cfg.cdtype, ("layers",) + ax)
                            for n, (s, ax) in kv.items()}
            # cross K/V sized max_seq on the "enc_seq" axis (they never
            # page); each row's encoder length masks the rest at decode
            ce = ((L, batch, max_seq, cfg.n_kv_heads, cfg.hd), cfg.cdtype,
                  ("layers", "batch", "enc_seq", "kv_heads", None))
            spec["cross"] = {"k": ce, "v": ce}
            spec["cross_len"] = ((batch,), torch.int32, ("batch",))
        elif cfg.hybrid is not None:
            G, A = _hybrid_groups(cfg), cfg.hybrid.attn_every
            ss = SSMBlock.state_shape(cfg, batch)
            spec["mamba"] = {n: ((G, A) + s, dt, ("layers", "layers") + ax)
                             for n, (s, dt, ax) in ss.items()}
            spec["attn"] = {n: ((G,) + s, cfg.cdtype, ("layers",) + ax)
                            for n, (s, ax) in kv.items()}
        elif cfg.ssm is not None:
            ss = SSMBlock.state_shape(cfg, batch)
            spec["layers"] = {n: ((L,) + s, dt, ("layers",) + ax)
                              for n, (s, dt, ax) in ss.items()}
        else:
            spec["layers"] = {n: ((L,) + s, cfg.cdtype, ("layers",) + ax)
                              for n, (s, ax) in kv.items()}
        return spec

    @staticmethod
    def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
                   device="cuda"):
        spec = LM.cache_spec(cfg, batch, max_seq)
        device = resolve_device(device)
        return map_spec(
            lambda s: torch.zeros(s[0], dtype=s[1], device=device), spec)

    # ------------------------------------------------------------- prefill

    def prefill(self, inputs, max_seq: int):
        """Forward over the prompt, building the decode cache.  Returns
        (last-position logits (B, 1, V), cache).  One device: under a shard
        context it raises (``_one_device``)."""
        self._one_device("prefill")
        cfg = self.cfg
        tokens = inputs["tokens"]
        B, S = tokens.shape
        h = self._embed(tokens, inputs)
        angles = _angles(cfg, B, S, device=h.device)
        cache = {"index": torch.tensor(S, dtype=torch.int32, device=h.device)}
        if cfg.enc_dec:
            h, states = self._prefill_encdec(h, inputs["frames"], angles,
                                             max_seq)
            cache.update(states)
        elif cfg.hybrid is not None:
            h, states = self._prefill_hybrid(h, angles, max_seq)
            cache.update(states)
        elif cfg.ssm is not None:
            states = []
            for blk in self.blocks:
                h, st = blk(h, return_state=True)
                states.append(st)
            cache["layers"] = _stack_states(states)
        else:
            kvs = []
            for blk in self.blocks:
                h, kv = self._decoder_prefill_block(blk, h, angles, max_seq)
                kvs.append(kv)
            cache["layers"] = _stack_states(kvs)
        return self._logits(self.ln_f(h[:, -1:])), cache

    def _prefill_hybrid(self, h, angles, max_seq):
        """The hybrid forward, keeping every Mamba2 layer's final state and
        every shared block's K/V laid out as its ring cache."""
        emb0 = h
        mamba, attn = [], []
        for _, group, shared, down in self._groups():
            states = []
            for blk in group:
                h, st = blk(h, return_state=True)
                states.append(st)
            mamba.append(_stack_states(states))
            x2, (k, v) = shared(torch.cat([h, emb0], dim=-1), angles=angles,
                                return_kv=True)
            h = h + down(x2)
            attn.append(self._kv_to_ring(k, v, max_seq))
        return h, {"mamba": _stack_states(mamba), "attn": _stack_states(attn)}

    def _prefill_encdec(self, h, frames, angles, max_seq):
        """The encoder once over every frame, then the decoder over the
        prompt, keeping each layer's self K/V as its ring and its cross
        K/V at the encoder's length S_enc (``write_slot`` pads them to the
        pool's max_seq); cross_len = S_enc for every row."""
        enc_out = self._encode(frames)
        selfs, crosses = [], []
        for blk in self.dec_blocks:
            h, (k, v), (ck, cv) = blk(h, enc_out=enc_out, angles=angles,
                                      return_kv=True)
            selfs.append(self._kv_to_ring(k, v, max_seq))
            crosses.append({"k": ck, "v": cv})
        B, Se = frames.shape[:2]
        return h, {"self": _stack_states(selfs),
                   "cross": _stack_states(crosses),
                   "cross_len": torch.full((B,), Se, dtype=torch.int32,
                                           device=h.device)}

    def _decoder_prefill_block(self, blk, x, angles, max_seq):
        x, (k, v) = blk(x, angles=angles, return_kv=True)
        return x, self._kv_to_ring(k, v, max_seq)

    def _kv_to_ring(self, k, v, max_seq):
        """Lay full-sequence K/V out as the ring cache sized for ``max_seq``
        (position p lives at slot p % W)."""
        k, v = Attention.to_ring(self.cfg, k, v, max_seq)
        return {"k": k, "v": v}

    # ------------------------------------------------------------- decode

    def decode(self, tokens, cache):
        """tokens: (B, 1) → (logits (B, 1, V), cache).  cache["index"] is
        the absolute position of this token: an int32 scalar or a (B,)
        vector.  A "block_tbl" entry ((B, nk) int32, shared by every layer)
        switches the K/V leaves to the paged (L, NB, bk, KV, hd) block
        pools (an encoder-decoder's self K/V; its cross K/V stay dense and
        are only read, masked past each row's "cross_len").  The K/V and
        SSM state leaves are written in place; the
        returned cache shares them and every other entry, and carries
        index + 1.  One device: under a shard context it raises
        (``_one_device``)."""
        self._one_device("decode")
        index = cache["index"]
        tbl = cache.get("block_tbl")
        B = tokens.shape[0]
        h = self._embed(tokens)
        angles = _angles(self.cfg, B, 1, start=index, device=h.device)
        if self.cfg.enc_dec:
            selfs, cross = cache["self"], cache["cross"]
            for i, blk in enumerate(self.dec_blocks):
                state = {"self": {n: leaf[i] for n, leaf in selfs.items()},
                         "cross": {n: leaf[i] for n, leaf in cross.items()}}
                h, _ = blk.decode(h, state, index, angles=angles,
                                  cross_len=cache.get("cross_len"),
                                  block_tbl=tbl)
        elif self.cfg.hybrid is not None:
            h = self._decode_hybrid(h, cache, index, angles, tbl)
        else:
            layers = cache["layers"]
            for i, blk in enumerate(self.blocks):
                layer = {n: leaf[i] for n, leaf in layers.items()}
                if self.cfg.ssm is not None:
                    h, _ = blk.decode(h, layer)
                else:
                    h, _ = blk.decode(h, layer, index, angles=angles,
                                      block_tbl=tbl)
        logits = self._logits(self.ln_f(h))
        return logits, {**cache, "index": index + 1}

    @staticmethod
    def _one_device(what: str):
        """Raise under a shard context: the one-device serve route would
        run whole at every position there, so a model under one prefills
        and decodes through ``steps.make_prefill_step``/
        ``make_decode_step``, which lay it out and run the partition."""
        if current_ctx() is not None:
            raise ValueError(
                f"LM.{what} runs on one device; under a shard context "
                f"prefill and decode through steps.make_prefill_step and "
                f"steps.make_decode_step, which run the partition")

    def _decode_hybrid(self, h, cache, index, angles, tbl):
        emb0 = h
        mamba, attn = cache["mamba"], cache["attn"]
        for g, group, shared, down in self._groups():
            for i, blk in enumerate(group):
                h, _ = blk.decode(h, {n: leaf[g, i]
                                      for n, leaf in mamba.items()})
            x2, _ = shared.decode(torch.cat([h, emb0], dim=-1),
                                  {n: leaf[g] for n, leaf in attn.items()},
                                  index, angles=angles, block_tbl=tbl)
            h = h + down(x2)
        return h

