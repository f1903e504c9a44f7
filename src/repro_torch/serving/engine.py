"""Single-replica continuous-batching engine (``repro.serving.engine``).

Every tick decodes one fixed-shape (slots, 1) token batch:

* **Chunked prefill.**  Admission prefills only the first ``prefill_chunk``
  prompt tokens in one shot; the rest of the prompt streams through the
  shared decode tick one token per step, so a long prompt never stalls the
  other slots.
* **Per-slot ring positions.**  The pool cache's "index" leaf is a (slots,)
  vector: every slot has its own RoPE angles, ring slot and validity mask.
* **Fused sampling.**  Sampling runs in the decode tail
  (``steps.make_fused_decode_step``): greedy rows take the device-sampled
  token, so a greedy tick moves (slots,) int32s to the host; temperature
  rows pull their one logits row and keep their stateful per-request RNG.

The reference donates the cache to ``jit``; here the decode writes it in
place.  Speculative decoding (``spec_k > 0``) is accepted and serves the
plain path, as the reference does for families it cannot speculate on; the
paged pool is not ported yet.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import LM
from repro_torch.models.steps import (
    make_decode_step, make_fused_decode_step, make_prefill_step,
)
from repro_torch.serving.scheduler import FCFSScheduler, Request
from repro_torch.serving.slots import make_pool

PHASE_FREE, PHASE_PREFILL, PHASE_DECODE = 0, 1, 2


class EngineCore:
    """Model weights and step functions, shared by every replica of one
    deployment.  ``params`` injects a prepared ``LM`` (for example
    reference weights through ``models.bridge``); otherwise the weights
    are drawn from ``seed``."""

    def __init__(self, cfg, max_seq: int, *, seed: int = 0,
                 params: LM | None = None, device="cuda"):
        self.cfg = cfg
        self.max_seq = max_seq
        self.device = resolve_device(device)
        if params is None:
            params = LM(cfg, device=self.device, seed=seed)
        elif params.device != self.device:
            raise ValueError(f"params on {params.device}, engine on "
                             f"{self.device}")
        self.params = params
        self.prefill = make_prefill_step(cfg, max_seq)
        self.decode = make_decode_step(cfg)
        self.fused_decode = make_fused_decode_step(cfg)


class EngineStats:
    """Per-replica accumulators: a drainable window (one monitoring tick) on
    top of lifetime totals."""

    def __init__(self):
        self.total_admitted = 0
        self.total_completed = 0
        self.total_tokens = 0
        self.total_ticks = 0
        self.total_busy = 0.0
        self.total_spec_proposed = 0
        self.total_spec_accepted = 0
        self.completed_by_tier: dict[str, int] = {}
        self.latencies_ms = deque(maxlen=4096)
        self.queue_depth = 0
        self._reset_window()

    def _reset_window(self):
        self._win_lat: list[float] = []
        self._win_lat_tiers: dict[str, list[float]] = {}
        self._win_completed = 0
        self._win_tokens = 0
        self._win_ticks = 0
        self._win_busy = 0.0
        self._win_spec_prop = 0
        self._win_spec_acc = 0

    def on_tick(self, busy_slots: int, slots: int, queue_depth: int):
        self.total_ticks += 1
        self.total_busy += busy_slots / max(slots, 1)
        self._win_ticks += 1
        self._win_busy += busy_slots / max(slots, 1)
        self.queue_depth = queue_depth

    def on_complete(self, request: Request):
        tier = getattr(request, "tier", "interactive")
        lat = request.latency_s
        if lat is not None:
            self.latencies_ms.append(lat * 1e3)
            self._win_lat.append(lat * 1e3)
            self._win_lat_tiers.setdefault(tier, []).append(lat * 1e3)
        self.total_completed += 1
        self.completed_by_tier[tier] = self.completed_by_tier.get(tier, 0) + 1
        self.total_tokens += len(request.tokens_out)
        self._win_completed += 1
        self._win_tokens += len(request.tokens_out)

    @property
    def slot_utilization(self) -> float:
        return self.total_busy / max(self.total_ticks, 1)

    def drain_window(self) -> dict:
        """Window metrics since the last drain (one ReplicaReport's worth)."""
        out = {
            "latency_ms_samples": list(self._win_lat),
            "lat_tiers": {t: list(v)
                          for t, v in self._win_lat_tiers.items() if v},
            "n_requests": self._win_completed,
            "n_tokens": self._win_tokens,
            "slot_util": self._win_busy / max(self._win_ticks, 1),
            "queue_depth": self.queue_depth,
            "spec_proposed": self._win_spec_prop,
            "spec_accepted": self._win_spec_acc,
        }
        self._reset_window()
        return out


def validate_request(cfg, max_seq: int, prompt: np.ndarray, frames=None):
    """Shape/length validation for one request against (cfg, max_seq): the
    engine runs it at submit, so a malformed request bounces back to its
    submitter instead of aborting a tick with other requests in flight."""
    P = len(prompt)
    if P < 1:
        raise ValueError("empty prompt")
    if (not cfg.attn_free and cfg.sliding_window is None
            and P >= max_seq):
        raise ValueError(f"prompt ({P}) must fit below max_seq "
                         f"({max_seq}) with room to generate")
    if cfg.family == "vlm" and P <= cfg.n_vision_patches:
        raise ValueError("vlm prompt must extend past the patch prefix")
    if cfg.enc_dec:
        if frames is None:
            raise ValueError("enc-dec request needs encoder frames")
        frames = np.asarray(frames)
        if frames.ndim != 2 or frames.shape[1] != cfg.d_model:
            raise ValueError(f"frames must be (S_enc, d_model="
                             f"{cfg.d_model}), got {frames.shape}")
        if frames.shape[0] < 1 or frames.shape[0] > max_seq:
            raise ValueError(f"encoder length ({frames.shape[0]}) must "
                             f"fit the cross pool (1..{max_seq})")


class ServingEngine:
    """One replica: S decode slots over one shared cache tree."""

    def __init__(self, cfg, *, slots: int, max_seq: int, seed: int = 0,
                 prefill_chunk: int | None = None,
                 core: EngineCore | None = None, replica_id: int = 0,
                 pool: str = "dense", spec_k: int = 0, device="cuda"):
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.replica_id = replica_id
        self.core = core if core is not None else EngineCore(
            cfg, max_seq, seed=seed, device=device)
        self.device = self.core.device
        self.params = self.core.params
        self.prefill = self.core.prefill
        self.decode = self.core.decode
        self.pool = make_pool(cfg, slots, max_seq, pool=pool,
                              device=self.device)
        self.prefill_tokens = 0      # prompt tokens actually computed
        self.prompt_tokens = 0       # prompt tokens admitted
        self._tokens_host = np.zeros(slots, np.int32)
        self._stage_tokens()
        self.pos = np.zeros(slots, np.int64)        # per-slot position
        self.remaining = np.zeros(slots, np.int64)  # tokens left to generate
        self.active = np.zeros(slots, bool)
        self.phase = np.zeros(slots, np.int8)
        self.slot_owner: dict[int, Request] = {}    # cleared on release
        chunk = prefill_chunk if prefill_chunk is not None else max_seq
        self.prefill_chunk = max(chunk, 1)
        self._prompt: list[np.ndarray | None] = [None] * slots
        self._fed = np.zeros(slots, np.int64)       # prompt tokens staged
        # accepted for the reference's signature; the speculative verify
        # path is not ported yet, so every tick is the plain fused tick
        self.spec_k = max(int(spec_k), 0)
        self.logits_pulls = 0        # host (·, V) logits materializations
        self.scheduler = FCFSScheduler()
        self.draining = False
        self.stats = EngineStats()

    # ------------------------------------------------------------- queue API

    def submit(self, request: Request, now: float = 0.0):
        """Enqueue one request; validation happens here, not at admission."""
        self._validate(np.asarray(request.prompt).reshape(-1),
                       frames=request.frames)
        if request.t_submit is None:
            request.t_submit = now
        self.scheduler.submit(request)

    def _validate(self, prompt: np.ndarray, frames=None):
        validate_request(self.cfg, self.max_seq, prompt, frames=frames)

    @property
    def idle(self) -> bool:
        return not self.active.any() and not self.scheduler

    @property
    def load(self) -> float:
        """Admitted + queued work relative to slot capacity."""
        return (int(self.active.sum()) + self.scheduler.depth) / max(
            self.slots, 1)

    def step(self, now: float | None = None) -> list[Request]:
        """One scheduling round: FCFS admission into free slots, one decode
        tick, completion + slot release.  Returns finished requests."""
        if now is None:
            now = time.monotonic()
        completed: list[Request] = []
        if not self.draining:
            free = [s for s in range(self.slots) if not self.active[s]]
            while free and self.scheduler:
                req = self.scheduler.pop()
                slot = free.pop(0)
                req.t_admit = now
                req.replica_id = self.replica_id
                self.admit(slot, req.prompt, req.gen_len, request=req)
                if self.phase[slot] == PHASE_DECODE:
                    req.t_first_token = now      # prompt fit in one chunk
        for slot in self.tick(now=now):
            req = self.slot_owner.get(slot)
            self.release_slot(slot)
            if isinstance(req, Request):
                req.t_done = now
                self.stats.on_complete(req)
                completed.append(req)
        self.stats.on_tick(int(self.active.sum()), self.slots,
                           self.scheduler.depth)
        return completed

    # ------------------------------------------------------------- slot API

    def admit(self, slot: int, prompt: np.ndarray, gen_len: int,
              request: Request | None = None, frames=None):
        """Prefill one slot: one shot over the first chunk; the rest of the
        prompt streams through tick() (PREFILL phase)."""
        if self.active[slot]:
            raise ValueError(f"slot {slot} is still active")
        if frames is None and request is not None:
            frames = request.frames
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        P = len(prompt)
        self._validate(prompt, frames=frames)
        if not self.cfg.attn_free and self.cfg.sliding_window is None:
            # full-attention ring wrap would overwrite live context
            gen_len = min(gen_len, self.max_seq - P)
        self.prompt_tokens += P
        self.stats.total_admitted += 1
        c = P if self.prefill_chunk >= P else self.prefill_chunk
        self.prefill_tokens += P
        inputs = {"tokens": torch.tensor(prompt[None, :c], device=self.device)}
        logits, cache1 = self.prefill(self.params, inputs)
        self.pool.write(cache1, slot, index=c)
        self.pos[slot] = c
        self._prompt[slot] = prompt
        self.remaining[slot] = gen_len
        self.active[slot] = True
        if request is not None:
            self.slot_owner[slot] = request
        if c == P:
            row = logits[0, -1].float().cpu().numpy()
            tok = (request.sample(row) if request is not None
                   else int(np.argmax(row)))
            self._tokens_host[slot] = tok
            self.phase[slot] = PHASE_DECODE
        else:
            self._tokens_host[slot] = int(prompt[c])
            self._fed[slot] = c + 1              # c cached + 1 staged
            self.phase[slot] = PHASE_PREFILL
        self._stage_tokens()

    def tick(self, now: float | None = None) -> list[int]:
        """One decode step for all slots (inactive slots decode garbage that
        is ignored).  Returns slots that finished this tick.

        * **legacy** — ``self.decode`` was replaced (tests monkeypatch):
          pull the (slots, 1, V) logits and sample on the host.
        * **fused** — sampling runs in the decode tail on the device; greedy
          rows never move logits to the host.
        """
        if not self.active.any():
            return []
        if self.decode is not self.core.decode:
            logits, cache = self.decode(self.params, self.tokens,
                                        self.pool.cache)
            self.pool.cache = cache
            rows = logits[:, 0].float().cpu().numpy()        # (slots, V)
            self.logits_pulls += 1
            toks = np.argmax(rows, axis=1).astype(np.int32)
            return self._advance(toks, lambda s: rows[s], now)
        return self._tick_fused(now)

    # -------------------------------------------------- shared tick plumbing

    def _stage_tokens(self):
        """Copy every slot's next input token to the device."""
        self.tokens = torch.tensor(self._tokens_host[:, None],
                                   device=self.device)

    def _emit(self, slot: int, req, tok_dev: int, fetch_row) -> int:
        """One sampled token for a slot, device first: greedy rows take the
        device-sampled token, temperature rows pull their logits row and keep
        their stateful host RNG."""
        if isinstance(req, Request) and req.sampling.temperature > 0.0:
            return req.sample(fetch_row(slot))
        tok = int(tok_dev)
        if isinstance(req, Request):
            req.tokens_out.append(tok)
        return tok

    def _advance(self, toks_host, fetch_row, now) -> list[int]:
        """Per-slot host state advance after one single-position tick."""
        done: list[int] = []
        for slot in np.nonzero(self.active)[0]:
            slot = int(slot)
            self.pos[slot] += 1
            req = self.slot_owner.get(slot)
            if self.phase[slot] == PHASE_PREFILL:
                prompt = self._prompt[slot]
                if self._fed[slot] < len(prompt):
                    self._tokens_host[slot] = int(prompt[self._fed[slot]])
                    self._fed[slot] += 1
                else:
                    # last prompt token just decoded → first generated token
                    self._tokens_host[slot] = self._emit(
                        slot, req, toks_host[slot], fetch_row)
                    self.phase[slot] = PHASE_DECODE
                    if (isinstance(req, Request) and req.t_first_token is None
                            and now is not None):
                        req.t_first_token = now
            else:
                self.remaining[slot] -= 1
                if self.remaining[slot] <= 0:
                    self.active[slot] = False
                    done.append(slot)
                else:
                    self._tokens_host[slot] = self._emit(
                        slot, req, toks_host[slot], fetch_row)
        self._stage_tokens()
        return done

    def _tick_fused(self, now) -> list[int]:
        """One decode step with sampling fused into the tail, drawing from
        stateless (seed, rid, pos) counters per row."""
        B = self.slots
        seed = np.zeros(B, np.int32)
        rid = np.zeros(B, np.int32)
        pos = np.zeros(B, np.int32)
        temp = np.zeros(B, np.float32)
        for slot, req in self.slot_owner.items():
            if isinstance(req, Request):
                seed[slot] = req.sampling.seed
                rid[slot] = req.rid
                pos[slot] = len(req.tokens_out)
                temp[slot] = req.sampling.temperature
        dev = lambda a: torch.tensor(a, device=self.device)
        toks, logits, cache = self.core.fused_decode(
            self.params, self.tokens, self.pool.cache, dev(seed), dev(rid),
            dev(pos), dev(temp))
        self.pool.cache = cache
        toks_host = toks.cpu().numpy()                  # (slots,) int32

        def fetch_row(s):
            self.logits_pulls += 1
            return logits[s, 0].float().cpu().numpy()

        return self._advance(toks_host, fetch_row, now)

    def release_slot(self, slot: int):
        """Free a finished slot; its owner is cleared with it."""
        self.active[slot] = False
        self.phase[slot] = PHASE_FREE
        self._prompt[slot] = None
        self._fed[slot] = 0
        self.slot_owner.pop(slot, None)

    def preempt_slot(self, slot: int) -> Request | None:
        """Evict an in-flight request from its slot, rewound for requeue."""
        req = self.slot_owner.get(slot)
        self.release_slot(slot)
        if isinstance(req, Request):
            req.reset_generation()
            return req
        return None

    def evacuate(self) -> list[Request]:
        """Empty the replica: queued requests plus every in-flight one
        (preempted, rewound), for the caller to requeue elsewhere."""
        out = self.scheduler.drain()
        for slot in np.nonzero(self.active)[0]:
            req = self.preempt_slot(int(slot))
            if req is not None:
                out.append(req)
        return out

    def lifetime(self) -> dict:
        """Lifetime accumulators for fleet-level metrics."""
        return {
            "latencies_ms": [float(v) for v in self.stats.latencies_ms],
            "total_tokens": int(self.stats.total_tokens),
            "total_completed": int(self.stats.total_completed),
            "completed_interactive": int(
                self.stats.completed_by_tier.get("interactive", 0)),
            "completed_batch": int(
                self.stats.completed_by_tier.get("batch", 0)),
            "total_ticks": int(self.stats.total_ticks),
            "slot_utilization": float(self.stats.slot_utilization),
            "queue_depth": int(self.scheduler.depth),
            "prefill_tokens": int(self.prefill_tokens),
            "prompt_tokens": int(self.prompt_tokens),
            "spec_proposed": int(self.stats.total_spec_proposed),
            "spec_accepted": int(self.stats.total_spec_accepted),
            "logits_pulls": int(self.logits_pulls),
        }

    @property
    def cache(self):
        return self.pool.cache

    @cache.setter
    def cache(self, value):
        self.pool.cache = value
