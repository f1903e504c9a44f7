"""Serve step functions (the serve half of ``repro.models.steps``).

Each ``make_*`` returns a plain function of ``(params, ...)`` where
``params`` is the ``LM`` module.  Nothing is jitted: the functions run
eagerly under ``torch.no_grad`` and update the cache in place.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM, map_spec


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    @torch.no_grad()
    def prefill_step(params: LM, batch):
        return params.prefill(batch, max_seq)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    @torch.no_grad()
    def decode_step(params: LM, tokens, cache):
        return params.decode(tokens, cache)
    return decode_step


def make_verify_step(cfg: ModelConfig):
    """Speculative verify: feed a (B, W) window — per row, the committed
    next input token and up to W-1 draft tokens — through W chained
    ``params.decode`` calls, the same decode the plain tick runs, so the
    logits at lane j equal the plain path's given the same fed prefix.
    Returns the per-lane greedy tokens (B, W) int32, the logits (B, W, V)
    and the cache, advanced W positions for every row; the engine rewinds
    each row to its true position afterwards (``pool.set_index``)."""
    @torch.no_grad()
    def verify_step(params: LM, tokens, cache):
        lanes = []
        for j in range(tokens.shape[1]):
            logits, cache = params.decode(tokens[:, j:j + 1], cache)
            lanes.append(logits[:, 0])
        logits = torch.stack(lanes, dim=1)                  # (B, W, V)
        toks = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        return toks, logits, cache
    return verify_step


def make_fused_decode_step(cfg: ModelConfig):
    """One decode step with sampling fused into the tail: returns the
    per-row sampled tokens (B,) int32 alongside the logits, so a greedy
    serving tick moves B int32s to the host instead of (B, 1, V) floats.

    seed/rid/pos are (B,) int32 stateless RNG counters; temperature is (B,)
    float32, 0 → greedy argmax (first index of the float32 maximum).  The
    sampler is the fused-sample kernel on the card and its plain version on
    the CPU."""
    @torch.no_grad()
    def fused_decode_step(params: LM, tokens, cache, seed, rid, pos,
                          temperature):
        logits, cache = params.decode(tokens, cache)
        rows = logits[:, 0].float()
        toks = kernel_ops.fused_sample(rows, seed, rid, pos, temperature)
        return toks, logits, cache
    return fused_decode_step


def make_chunked_prefill_step(cfg: ModelConfig, max_seq: int, chunk: int):
    """Prefill with bounded per-step work: a one-shot prefill of the first
    ``chunk`` tokens builds the cache, then the rest of the prompt streams
    through the decode path one token per step.  Produces the same
    (last-position logits, cache) as ``make_prefill_step``.

    An encoder-decoder prefills in one shot (the encoder needs every
    frame); a VLM needs ``chunk > n_vision_patches``, so that the patch
    prefix lands in the one-shot part."""
    if cfg.family == "vlm" and chunk <= cfg.n_vision_patches:
        raise ValueError(
            f"vlm chunked prefill needs chunk > n_vision_patches "
            f"({chunk} <= {cfg.n_vision_patches})")

    @torch.no_grad()
    def chunked_prefill(params: LM, inputs):
        tokens = inputs["tokens"]
        S = tokens.shape[1]
        if S <= chunk or cfg.enc_dec:
            return params.prefill(inputs, max_seq)
        logits, cache = params.prefill({**inputs, "tokens": tokens[:, :chunk]},
                                       max_seq)
        for j in range(chunk, S):
            logits, cache = params.decode(tokens[:, j:j + 1], cache)
        return logits, cache
    return chunked_prefill


def cache_axes(cfg: ModelConfig, batch: int, max_seq: int):
    """Logical-axes tree of the decode cache."""
    return map_spec(lambda s: s[2], LM.cache_spec(cfg, batch, max_seq))


def cache_structs(cfg: ModelConfig, batch: int, max_seq: int):
    """(shape, dtype) tree of the decode cache — no allocation."""
    return map_spec(lambda s: (s[0], s[1]), LM.cache_spec(cfg, batch, max_seq))
