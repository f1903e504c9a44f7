"""Request lifecycle + FCFS admission with priority lanes.

A Request moves QUEUED → PREFILL → DECODE → DONE.  The scheduler itself is
deliberately simple — first-come-first-served with slot-count admission
control — because the interesting scheduling (how many replicas exist at all)
belongs to the control plane driving the router.  Timestamps are caller-
supplied ("now" flows in from the caller), so tests run on a virtual clock
and production callers pass wall time.

Traffic is non-uniform: every request carries a ``tier`` — "interactive"
(latency SLO) or "batch" (throughput, tolerant of queueing and preemption).
The scheduler keeps one FCFS deque PER LANE and admits strictly by lane
priority: the interactive lane drains first, and within a lane order is
exactly first-come-first-served — so a single-tier workload behaves
bit-identically to the old single-queue scheduler.  The control plane can
additionally GATE the batch lane (``batch_gated``) when the interactive
lane's SLO is at risk: gated batch requests stay queued (they still count
toward depth/load) but are invisible to pop/peek until the gate lifts.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.serving.sampling import SamplingParams, sample_token

# lane priority order: earlier tiers admit first
TIERS = ("interactive", "batch")


def validate_tier(tier: str) -> str:
    """Both the engine and a remote stub's parent side run this — a typo'd
    tier must bounce at submit, on the submitter's side of the wire."""
    if tier not in TIERS:
        raise ValueError(f"unknown tier {tier!r} (expected one of {TIERS})")
    return tier


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    gen_len: int
    # admission lane (TIERS): interactive requests admit ahead of batch
    # ones and are never routed onto preemptible capacity
    tier: str = "interactive"
    # origin region ("" = untagged): on a region-tagged fleet the router
    # prefers in-region capacity for interactive requests; untagged
    # requests (and region-less fleets) route on the legacy key
    region: str = ""
    # default_factory, NOT a shared class-level instance: safe today only
    # because SamplingParams is frozen, but a future mutable field would
    # silently couple every request in the fleet through one object
    sampling: SamplingParams = dataclasses.field(
        default_factory=SamplingParams)
    # enc-dec families: precomputed encoder frames, (S_enc, d_model) float.
    frames: Optional[np.ndarray] = None
    t_submit: Optional[float] = None
    t_admit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    replica_id: Optional[int] = None
    tokens_out: list = dataclasses.field(default_factory=list)
    _rng: Optional[np.random.Generator] = dataclasses.field(
        default=None, repr=False, compare=False)

    def sample(self, logits: np.ndarray) -> int:
        """Sample (and record) the next output token; RNG is seeded from
        (sampling.seed, rid) so replays are per-request deterministic."""
        if self._rng is None:
            self._rng = np.random.default_rng((self.sampling.seed, self.rid))
        tok = sample_token(logits, self.sampling, self._rng,
                           position=len(self.tokens_out))
        self.tokens_out.append(tok)
        return tok

    def reset_generation(self):
        """Rewind to the not-yet-admitted state (preemption / replica loss).
        t_submit survives — the requeue penalty is real user-visible latency
        and must stay in the accounting; everything generated on the lost
        replica is discarded so the replay is bit-identical to a fresh run
        (the sampling RNG reseeds from (seed, rid) on first use)."""
        self.tokens_out = []
        self._rng = None
        self.t_admit = None
        self.t_first_token = None
        self.t_done = None
        self.replica_id = None

    @property
    def latency_s(self) -> Optional[float]:
        if self.t_done is None or self.t_submit is None:
            return None
        return self.t_done - self.t_submit

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None or self.t_submit is None:
            return None
        return self.t_first_token - self.t_submit


class FCFSScheduler:
    """Priority-laned FCFS admission queue for one engine: one deque per
    tier, drained in TIERS order (interactive before batch), first-come-
    first-served WITHIN a lane.  ``pop``/``peek`` always agree on the same
    head — the paged pool's head-of-line capacity gate peeks, then pops."""

    def __init__(self):
        self._lanes: dict[str, deque[Request]] = {t: deque() for t in TIERS}
        self.n_submitted = 0
        # control-plane gate: while set, the batch lane is invisible to
        # admission (pop/peek/__bool__) but its requests stay queued and
        # still count toward depth — interactive SLO protection, not drop
        self.batch_gated = False

    def submit(self, request: Request):
        self._lanes[validate_tier(request.tier)].append(request)
        self.n_submitted += 1

    def _head_lane(self) -> deque[Request] | None:
        for t in TIERS:
            if t == "batch" and self.batch_gated:
                continue
            if self._lanes[t]:
                return self._lanes[t]
        return None

    def pop(self) -> Request:
        lane = self._head_lane()
        if lane is None:
            raise IndexError("pop from an empty (or fully gated) scheduler")
        return lane.popleft()

    def peek(self) -> Request:
        """Head of the queue without removing it — admission gates that may
        refuse the head (paged pool out of blocks) must not reorder FCFS."""
        lane = self._head_lane()
        if lane is None:
            raise IndexError("peek at an empty (or fully gated) scheduler")
        return lane[0]

    def drain(self) -> list[Request]:
        """Remove and return every queued (not yet admitted) request — used
        when a draining replica hands its backlog to the survivors.  Gated
        batch requests leave too: an evacuation empties the replica."""
        out: list[Request] = []
        for t in TIERS:
            out.extend(self._lanes[t])
            self._lanes[t].clear()
        return out

    def lane_depth(self, tier: str) -> int:
        return len(self._lanes[tier])

    @property
    def depth(self) -> int:
        return sum(len(q) for q in self._lanes.values())

    def __bool__(self) -> bool:
        """Admissible work exists (a gated batch backlog reads False — the
        engine's admission loop must not spin on requests it cannot pop)."""
        return self._head_lane() is not None
