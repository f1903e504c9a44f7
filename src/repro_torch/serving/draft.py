"""Model-free draft proposals for speculative decoding: prompt lookup.

The draft model here is the request's own history.  LLM output — especially
on retrieval, summarization, and code workloads — re-quotes long spans of
its prompt and of its own earlier output, so the last ``n`` generated tokens
very often continue exactly the way they continued the *previous* time that
n-gram appeared.  ``ngram_propose`` finds the most recent earlier occurrence
of the current n-gram suffix in the slot's prompt+generated history and
proposes the tokens that followed it, up to ``k``.

This is the zero-parameter end of the draft-model spectrum (no second
network, no extra HBM, no draft/target skew to manage): proposals are free
on the host, and the target model's verify step is what decides — a wrong
draft costs one wasted lane in a batched decode, never a wrong token.  The
acceptance rate it achieves is therefore purely a *workload* property,
which is exactly why the engine reports it upstream as a metric stream.

Matching is longest-suffix-first: an order-``n`` match is more specific
than an order-1 match, so its continuation is more likely to verify.  The
scan runs right-to-left so the *most recent* occurrence wins — recency
tracks local context (the same n-gram earlier in a long document may have
continued differently).
"""
from __future__ import annotations

import numpy as np


def ngram_propose(history: np.ndarray, *, k: int, ngram: int = 3
                  ) -> np.ndarray:
    """Propose up to ``k`` draft tokens continuing ``history``.

    history: 1-D int token ids (array or list) — the slot's prompt followed
    by everything it has generated so far (the last entry is the newest
    token).  Returns a (m,) int32 array, 0 <= m <= k; empty when no earlier
    occurrence of any suffix n-gram exists (e.g. all-unique prompts) or
    k <= 0.

    The scan runs on plain python ints: it executes on the host once per
    decode slot per verify tick, over histories of at most max_seq tokens,
    where list-slice comparisons are an order of magnitude cheaper than
    per-candidate numpy dispatch — this is engine tick-path code, and draft
    cost eats directly into the speculation speedup.
    """
    h = history if isinstance(history, list) \
        else np.asarray(history).ravel().tolist()
    T = len(h)
    if k <= 0 or T < 2:
        return np.zeros(0, np.int32)
    for n in range(min(ngram, T - 1), 0, -1):
        tail = h[T - n:]
        # candidate match starts: windows h[i:i+n] with i+n < T (the window
        # must END strictly before the suffix itself so there is at least
        # one following token to propose); scan newest-first.  Prefer the
        # newest match with a FULL k-token follow: when generation settles
        # into a cycle shorter than k, the very newest match sits so close
        # to the end that its follow is truncated to a token or two, while
        # one cycle earlier the same continuation is available at full
        # length — a short draft there wastes verify lanes for no accuracy
        # gain.  The newest (possibly truncated) match is the fallback.
        fallback = -1
        for i in range(T - n - 1, -1, -1):
            if h[i:i + n] == tail:
                if i + n + k <= T:
                    return np.asarray(h[i + n: i + n + k], np.int32)
                if fallback < 0:
                    fallback = i
        if fallback >= 0:
            follow = h[fallback + n: fallback + n + k]
            if follow:
                return np.asarray(follow, np.int32)
    return np.zeros(0, np.int32)
