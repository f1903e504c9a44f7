"""Sampling layer: temperature / top-k / greedy, seeded per request.

Sampling runs on the host over the one row of logits each slot produced this
tick — at serving time the (slots, 1, V) logits are already being pulled back
for lifecycle bookkeeping, so host-side numpy keeps the device tick a pure
fixed-shape decode while every request still gets its
own reproducible RNG.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature == 0 → greedy argmax (the deterministic default);
    top_k == 0 → sample over the full vocabulary."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0


GREEDY = SamplingParams()


def sample_token(logits: np.ndarray, params: SamplingParams,
                 rng: np.random.Generator | None = None, *,
                 position: int = 0) -> int:
    """logits: (V,) float — one slot's next-token distribution.

    Callers holding a stateful per-request generator (Request.sample) pass
    ``rng`` and ignore ``position``.  Stateless callers must pass the
    token position instead: the fallback stream is derived from
    ``(seed, position)``, so successive positions draw fresh randomness —
    seeding from ``seed`` alone would rebuild the identical generator every
    call and emit the same token forever.
    """
    logits = np.asarray(logits, np.float64)
    if params.temperature <= 0.0:
        return int(np.argmax(logits))
    if rng is None:
        rng = np.random.default_rng((params.seed, position))
    scaled = logits / params.temperature
    if params.top_k > 0:
        k = min(params.top_k, scaled.size)
        kth = np.partition(scaled, -k)[-k]
        scaled = np.where(scaled >= kth, scaled, -np.inf)
    scaled -= np.max(scaled)
    probs = np.exp(scaled)
    probs /= probs.sum()
    return int(rng.choice(scaled.size, p=probs))
