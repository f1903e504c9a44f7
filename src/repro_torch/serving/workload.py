"""Synthetic serving workloads, shaped by ``sim.serving.WorkloadSpec``
(``repro.serving.workload``: the uniform stream, Poisson arrivals, the
mixed-tier, prompt-echo and shared-prefix streams)."""
from __future__ import annotations

import numpy as np

from repro_torch.serving.sampling import SamplingParams
from repro_torch.serving.scheduler import Request
from repro_torch.sim.serving import WorkloadSpec


def poisson_arrival_times(rps: float, n: int,
                          rng: np.random.Generator) -> np.ndarray:
    """n cumulative arrival times (seconds) at ``rps`` requests/second."""
    return np.cumsum(rng.exponential(1.0 / max(rps, 1e-9), n))


def synthetic_requests(spec: WorkloadSpec, n: int, vocab: int, *,
                       rng: np.random.Generator, base_rid: int = 0,
                       sampling: SamplingParams | None = None,
                       tier: str = "interactive") -> list[Request]:
    """n requests drawn from the spec's shape (uniform random token ids;
    ids < 3 reserved for specials).  When ``sampling`` is omitted, each
    request gets its own SamplingParams."""
    return [
        Request(rid=base_rid + i,
                prompt=rng.integers(3, vocab, size=spec.prompt_len
                                    ).astype(np.int32),
                gen_len=spec.gen_len, tier=tier,
                sampling=SamplingParams() if sampling is None else sampling)
        for i in range(n)
    ]


def tiered_requests(spec: WorkloadSpec, n: int, vocab: int, *,
                    batch_frac: float, rng: np.random.Generator,
                    base_rid: int = 0,
                    sampling: SamplingParams | None = None
                    ) -> list[Request]:
    """A mixed-tier stream: each request lands on the batch lane with
    probability ``batch_frac`` (drawn after the prompts, so the prompt
    stream matches a same-seed ``synthetic_requests`` call token for token;
    only the tier labels differ)."""
    reqs = synthetic_requests(spec, n, vocab, rng=rng, base_rid=base_rid,
                              sampling=sampling)
    if batch_frac > 0.0:
        is_batch = rng.random(n) < batch_frac
        for r, b in zip(reqs, is_batch):
            if b:
                r.tier = "batch"
    return reqs


def repetitive_requests(spec: WorkloadSpec, n: int, vocab: int, *,
                        period: int, rng: np.random.Generator,
                        base_rid: int = 0,
                        sampling: SamplingParams | None = None
                        ) -> list[Request]:
    """n requests whose prompt cycles one random ``period``-token phrase
    (the prompt-echo shape: extraction, templated boilerplate).  The suffix
    n-gram of such a prompt recurs earlier in the history, so a
    prompt-lookup draft (``serving/draft.py``) keeps finding
    continuations."""
    assert 1 <= period <= spec.prompt_len, (period, spec.prompt_len)
    out = []
    for i in range(n):
        phrase = rng.integers(3, vocab, size=period).astype(np.int32)
        reps = -(-spec.prompt_len // period)
        out.append(Request(
            rid=base_rid + i,
            prompt=np.tile(phrase, reps)[:spec.prompt_len],
            gen_len=spec.gen_len,
            sampling=SamplingParams() if sampling is None else sampling))
    return out


def shared_prefix_requests(spec: WorkloadSpec, n: int, vocab: int, *,
                           prefix_len: int, rng: np.random.Generator,
                           base_rid: int = 0,
                           sampling: SamplingParams | None = None
                           ) -> list[Request]:
    """n requests sharing one ``prefix_len``-token system prompt; the rest
    of each prompt is private.  The shape a paged pool's prefix cache is
    built for: the first admission prefills the prefix, later ones map its
    blocks read-only."""
    assert 0 <= prefix_len <= spec.prompt_len, (prefix_len, spec.prompt_len)
    prefix = rng.integers(3, vocab, size=prefix_len).astype(np.int32)
    return [
        Request(rid=base_rid + i,
                prompt=np.concatenate(
                    [prefix,
                     rng.integers(3, vocab, size=spec.prompt_len - prefix_len
                                  ).astype(np.int32)]),
                gen_len=spec.gen_len,
                sampling=SamplingParams() if sampling is None else sampling)
        for i in range(n)
    ]
