"""Synthetic serving workloads, shaped by ``sim.serving.WorkloadSpec``
(``repro.serving.workload``: the uniform stream and Poisson arrivals)."""
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
