"""Deterministic, counted token pipeline → preemption-safe resume (a copy
of ``repro.data.pipeline``, which is numpy only; the port imports nothing
of ``repro``).

The stream is a pure function of (seed, step): after restart, setting the
step counter reproduces exactly the batches that would have followed — no
data-loader state needs checkpointing beyond the integer step (stored in the
train state).  Synthetic text is drawn from a Zipf distribution with document
structure (BOS/EOS segmentation) so the CE loss has realistic token
statistics; a memory-mapped token file can be substituted for real corpora.
The batches are numpy arrays, byte for byte the reference's.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    mean_doc_len: int = 512
    bos_id: int = 1
    eos_id: int = 2
    token_file: str | None = None


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mm = None
        if cfg.token_file:
            self._mm = np.memmap(cfg.token_file, dtype=np.int32, mode="r")

    def batch(self, step: int):
        """→ {"tokens", "labels"}: (B, S) int32.  Pure in (seed, step)."""
        cfg = self.cfg
        if self._mm is not None:
            return self._file_batch(step)
        rng = np.random.default_rng((cfg.seed, step))
        B, S = cfg.global_batch, cfg.seq_len
        toks = rng.zipf(cfg.zipf_a, size=(B, S + 1)).astype(np.int64)
        toks = (toks - 1) % (cfg.vocab - 3) + 3          # reserve 0,1,2
        # document boundaries: geometric lengths
        n_docs = max(2, (S + 1) // cfg.mean_doc_len + 2)
        for b in range(B):
            cuts = rng.geometric(1.0 / cfg.mean_doc_len, size=n_docs).cumsum()
            cuts = cuts[cuts < S]
            toks[b, cuts] = cfg.eos_id
        toks[:, 0] = cfg.bos_id
        toks = toks.astype(np.int32)
        return {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}

    def _file_batch(self, step: int):
        cfg = self.cfg
        B, S = cfg.global_batch, cfg.seq_len
        n = len(self._mm) - (S + 1)
        rng = np.random.default_rng((cfg.seed, step))
        starts = rng.integers(0, n, size=B)
        toks = np.stack([self._mm[s:s + S + 1] for s in starts]).astype(np.int32)
        return {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}


def extra_inputs(cfg_model, batch_np):
    """Family-specific extras (vision patches / audio frames) as synthetic
    embeddings, deterministic in the token content."""
    out = dict(batch_np)
    B, S = batch_np["tokens"].shape
    if cfg_model.family == "vlm":
        rng = np.random.default_rng(int(batch_np["tokens"][0, 0]))
        out["patches"] = rng.standard_normal(
            (B, cfg_model.n_vision_patches, cfg_model.d_model)).astype(np.float32)
    if cfg_model.enc_dec:
        rng = np.random.default_rng(int(batch_np["tokens"][0, 0]) + 1)
        out["frames"] = rng.standard_normal(
            (B, S, cfg_model.d_model)).astype(np.float32)
    return out
