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
* **Speculative decoding** (``spec_k > 0``).  A prompt-lookup draft
  (``serving/draft.py``) proposes up to k tokens per decode slot from the
  slot's own history; one verify step (``steps.make_verify_step``) runs the
  whole (slots, W) window and the engine accepts the longest exact-match
  prefix.  Rejected tails rewind through the pool index vector, so their
  K/V is re-covered later.  PREFILL rows stream up to W prompt tokens per
  verify tick.  Acceptance is exact-match on sampled tokens, so streams
  equal the plain path's for any sampling mode; caches that cannot rewind
  (a sliding-window ring shorter than max_seq) serve the plain path.
* **Paged pool** (``pool="paged"``).  K/V live in shared blocks named by
  per-slot block tables; an admission whose block-aligned prompt prefix is
  resident maps those blocks and runs no prefill for them, and every
  prompt block the engine completes is registered for later admissions.

The reference donates the cache to ``jit``; here the decode writes it in
place.
"""
from __future__ import annotations

import hashlib
import time
from collections import deque

import numpy as np
import torch

from repro_torch.device import resolve_device, same_device
from repro_torch.models import LM
from repro_torch.models.attention import Attention
from repro_torch.models.steps import (
    make_decode_step, make_fused_decode_step, make_prefill_step,
    make_verify_step,
)
from repro_torch.serving.draft import ngram_propose
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
        elif not same_device(params.device, self.device):
            raise ValueError(f"params on {params.device}, engine on "
                             f"{self.device}")
        self.params = params
        self.prefill = make_prefill_step(cfg, max_seq)
        self.decode = make_decode_step(cfg)
        self.fused_decode = make_fused_decode_step(cfg)
        self.verify = make_verify_step(cfg)


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

    def on_speculate(self, proposed: int, accepted: int):
        self.total_spec_proposed += proposed
        self.total_spec_accepted += accepted
        self._win_spec_prop += proposed
        self._win_spec_acc += accepted

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
    """One replica: S decode slots over one shared cache tree.

    ``partitions`` splits a paged pool's blocks into that many contiguous
    ranges, each slot drawing from its own (the reference's).  ``mesh``
    (``launch.mesh``) lays the pool over a device mesh, one shard of slots
    per device; the caller then installs a decode that runs shard by
    shard (``replica.make_sharded_decode``; ``ShardedReplica`` and a pod
    rank do), so every tick takes the legacy bulk-pull path (``tick``),
    whatever ``spec_k`` says.  Prefill runs on ``device`` (the core's)."""

    def __init__(self, cfg, *, slots: int, max_seq: int, seed: int = 0,
                 prefill_chunk: int | None = None,
                 core: EngineCore | None = None, replica_id: int = 0,
                 pool: str = "dense", block_size: int | None = None,
                 num_blocks: int | None = None, partitions: int = 1,
                 spec_k: int = 0, spec_ngram: int = 3, mesh=None,
                 device="cuda"):
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
                              block_size=block_size, num_blocks=num_blocks,
                              partitions=partitions, mesh=mesh,
                              device=self.device)
        # "paged" on a family with no pageable leaves (a sliding window
        # shorter than max_seq) degenerates to the dense tree, and the
        # engine's dense paths apply unchanged
        self._paged = getattr(self.pool, "is_paged", False)
        self.prefill_tokens = 0      # prompt tokens actually computed
        self.prompt_tokens = 0       # prompt tokens admitted (incl. shared)
        self._tokens_host = np.zeros(slots, np.int32)
        # verify ticks read _tokens_host directly and defer the (slots, 1)
        # device copy until a fused or legacy tick needs self.tokens
        self._tokens_dirty = False
        self._stage_tokens()
        self.pos = np.zeros(slots, np.int64)        # per-slot position
        self.remaining = np.zeros(slots, np.int64)  # tokens left to generate
        self.active = np.zeros(slots, bool)
        self.phase = np.zeros(slots, np.int8)
        self.slot_owner: dict[int, Request] = {}    # cleared on release
        chunk = prefill_chunk if prefill_chunk is not None else max_seq
        if cfg.family == "vlm":
            # the patch prefix must land in the one-shot prefill
            chunk = max(chunk, cfg.n_vision_patches + 1)
        self.prefill_chunk = max(chunk, 1)
        self._prompt: list[np.ndarray | None] = [None] * slots
        self._fed = np.zeros(slots, np.int64)       # prompt tokens staged
        # a VLM's prefix K/V depends on its patches as well as its token
        # ids, so their digest goes into every prefix key: prompts with the
        # same ids and other patches never alias.  Every request gets the
        # same zero patches today, so this is one constant an engine.
        self._patch_key = (hashlib.sha1(np.zeros(
            (cfg.n_vision_patches, cfg.d_model), np.float32).tobytes()
        ).digest() if cfg.family == "vlm" else b"")
        self.spec_k = max(int(spec_k), 0)
        self.spec_ngram = max(int(spec_ngram), 1)
        # speculation needs a rewindable cache: recurrent state cannot roll
        # back, an encoder-decoder serves plain as in the reference, and a
        # sliding-window ring shorter than max_seq wraps, so speculative
        # writes would clobber live context that rewinding the index cannot
        # restore.  Such configs serve the plain path; the knob is never an
        # error.
        self._spec_ok = (
            self.spec_k > 0
            and cfg.ssm is None and getattr(cfg, "hybrid", None) is None
            and not cfg.enc_dec and not cfg.attn_free
            and Attention.cache_len(cfg, max_seq) == max_seq)
        self.logits_pulls = 0        # host (·, V) logits materializations
        # device steps by kind, kept beside lifetime() (whose keys stay the
        # reference's): the launch-count checks read them
        self.fused_ticks = 0         # single-position fused decode steps
        self.verify_lanes = 0        # positions decoded by verify steps
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
                if self._paged:
                    # head-of-line capacity gate: a paged pool can have free
                    # slots but no free blocks; admitting anyway would fault
                    # mid-decode, and skipping ahead would break FCFS order
                    head = self.scheduler.peek()
                    if not self.pool.can_admit(
                            free[0], np.asarray(head.prompt).reshape(-1),
                            head.gen_len, extra=self._patch_key):
                        break
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
        prompt streams through tick() (PREFILL phase).  An encoder-decoder
        takes ``frames`` (or the request's): the encoder runs whole in the
        one-shot part, and the decoder prompt's tail can still stream."""
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
        if self._paged:
            h_tok = self.pool.admit_slot(slot, prompt, gen_len,
                                         extra=self._patch_key)
            if h_tok > 0:
                # resident prefix: the shared blocks hold positions
                # 0..h_tok-1, so no prefill runs; the rest of the prompt
                # streams through the decode tick from position h_tok
                self.prefill_tokens += P - h_tok
                self.pool.set_slot_index(slot, h_tok)
                self.pos[slot] = h_tok
                self._prompt[slot] = prompt
                self.remaining[slot] = gen_len
                self.active[slot] = True
                if request is not None:
                    self.slot_owner[slot] = request
                self._tokens_host[slot] = int(prompt[h_tok])
                self._fed[slot] = h_tok + 1      # h_tok shared + 1 staged
                self.phase[slot] = PHASE_PREFILL
                self._stage_tokens()
                return
        c = P if self.prefill_chunk >= P else self.prefill_chunk
        self.prefill_tokens += P
        inputs = {"tokens": torch.tensor(prompt[None, :c], device=self.device)}
        if self.cfg.family == "vlm":
            inputs["patches"] = torch.zeros(
                (1, self.cfg.n_vision_patches, self.cfg.d_model),
                dtype=self.cfg.cdtype, device=self.device)
        if self.cfg.enc_dec:
            inputs["frames"] = torch.tensor(
                np.asarray(frames)[None], dtype=self.cfg.cdtype,
                device=self.device)
        logits, cache1 = self.prefill(self.params, inputs)
        self.pool.write(cache1, slot, index=c)
        if self._paged:
            # blocks the one-shot prefill covered are complete prompt
            # prefixes: publish them for later admissions to share
            for j in range(c // self.pool.block_size):
                self.pool.register_block(slot, j, prompt,
                                         extra=self._patch_key)
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
        * **verify** — with speculation on and a draft (or a streamable
          prompt tail) present, one multi-position decode verifies a
          (slots, W) window and the engine emits the accepted prefix.
        """
        if not self.active.any():
            return []
        if self.decode is not self.core.decode:
            if self._tokens_dirty:
                self._stage_tokens()
            logits, cache = self.decode(self.params, self.tokens,
                                        self.pool.cache)
            self.pool.cache = cache
            rows = logits[:, 0].float().cpu().numpy()        # (slots, V)
            self.logits_pulls += 1
            toks = np.argmax(rows, axis=1).astype(np.int32)
            return self._advance(toks, lambda s: rows[s], now)
        if self._spec_ok:
            drafts, window_w = self._plan_window()
            if window_w >= 2:
                return self._tick_verify(drafts, window_w, now)
        return self._tick_fused(now)

    # -------------------------------------------------- shared tick plumbing

    def _stage_tokens(self):
        """Copy every slot's next input token to the device."""
        self.tokens = torch.tensor(self._tokens_host[:, None],
                                   device=self.device)
        self._tokens_dirty = False

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
                pos = int(self.pos[slot])
                if (self._paged and pos % self.pool.block_size == 0
                        and pos <= len(prompt)):
                    # a streamed block just filled with prompt tokens:
                    # publish it (positions pos-bk..pos-1 are prompt[:pos])
                    self.pool.register_block(
                        slot, pos // self.pool.block_size - 1, prompt,
                        extra=self._patch_key)
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
        if self._tokens_dirty:
            self._stage_tokens()
        dev = lambda a: torch.tensor(a, device=self.device)
        self.fused_ticks += 1
        toks, logits, cache = self.core.fused_decode(
            self.params, self.tokens, self.pool.cache, dev(seed), dev(rid),
            dev(pos), dev(temp))
        self.pool.cache = cache
        toks_host = toks.cpu().numpy()                  # (slots,) int32

        def fetch_row(s):
            self.logits_pulls += 1
            return logits[s, 0].float().cpu().numpy()

        return self._advance(toks_host, fetch_row, now)

    # ------------------------------------------------------- speculative path

    def _plan_window(self) -> tuple[dict[int, np.ndarray], int]:
        """Collect n-gram drafts and size this tick's verify window.

        Returns (drafts, W).  W is clamped so that no active row's window
        writes past ``max_seq - 1``: the window advances every row's index
        by W, and a wrapped write would clobber valid context (or a shared
        prefix block) that rewinding cannot restore.  W < 2 buys nothing:
        the caller falls back to the fused tick."""
        drafts: dict[int, np.ndarray] = {}
        w_cap = self.spec_k + 1
        streamable = False
        for slot in np.nonzero(self.active)[0]:
            slot = int(slot)
            w_cap = min(w_cap, self.max_seq - int(self.pos[slot]))
            if self.phase[slot] == PHASE_PREFILL:
                if self._fed[slot] < len(self._prompt[slot]):
                    streamable = True
                continue
            req = self.slot_owner.get(slot)
            lim = min(self.spec_k, int(self.remaining[slot]) - 1)
            if not isinstance(req, Request) or lim <= 0:
                continue
            hist = np.asarray(req.prompt).ravel().tolist() + \
                list(req.tokens_out)
            d = ngram_propose(hist, k=lim, ngram=self.spec_ngram)
            if d.size:
                drafts[slot] = d
        if not drafts and not streamable:
            return {}, 0
        return drafts, max(w_cap, 0)

    def _tick_verify(self, drafts: dict[int, np.ndarray], W: int,
                     now) -> list[int]:
        """One multi-position decode over a (slots, W) window.

        Lane 0 is every slot's staged token; decode lanes 1.. carry that
        slot's draft, prefill lanes upcoming prompt tokens.  The engine
        accepts the longest exact-match draft prefix per slot and rewinds
        the pool index to the host positions: unconsumed lanes are
        re-covered by later writes."""
        B = self.slots
        window = np.zeros((B, W), np.int32)
        window[:, 0] = self._tokens_host
        n_extra = np.zeros(B, np.int64)      # prompt tokens fed in lanes 1..
        n_draft = np.zeros(B, np.int64)      # draft tokens staged in lanes 1..
        for slot in np.nonzero(self.active)[0]:
            slot = int(slot)
            if self.phase[slot] == PHASE_PREFILL:
                prompt = self._prompt[slot]
                m = min(W - 1, len(prompt) - int(self._fed[slot]))
                if m > 0:
                    lo = int(self._fed[slot])
                    window[slot, 1:1 + m] = prompt[lo:lo + m]
                    n_extra[slot] = m
            elif slot in drafts:
                d = drafts[slot][:W - 1]
                window[slot, 1:1 + len(d)] = d
                n_draft[slot] = len(d)
        self.verify_lanes += W
        toks, logits, cache = self.core.verify(
            self.params, torch.tensor(window, device=self.device),
            self.pool.cache)
        self.pool.cache = cache
        toks_host = toks.cpu().numpy()                  # (slots, W) int32

        done: list[int] = []
        for slot in np.nonzero(self.active)[0]:
            slot = int(slot)
            req = self.slot_owner.get(slot)

            def fetch_row(lane, slot=slot):
                self.logits_pulls += 1
                return logits[slot, lane].float().cpu().numpy()

            if self.phase[slot] == PHASE_PREFILL:
                done.extend(self._advance_prefill_window(
                    slot, req, int(n_extra[slot]), toks_host, fetch_row, now))
            else:
                done.extend(self._advance_decode_window(
                    slot, req, window, int(n_draft[slot]), toks_host,
                    fetch_row))
        # host positions are truth: rejected and padding lanes' writes fall
        # past the new horizon.  The next window reads _tokens_host, so the
        # token copy waits until a fused or legacy tick needs it.
        self.pool.set_index(self.pos.astype(np.int32))
        self._tokens_dirty = True
        return done

    def _advance_prefill_window(self, slot, req, m, toks_host, fetch_row,
                                now) -> list[int]:
        """A PREFILL slot consumed lanes 0..m: the staged prompt token plus
        m more.  Publish every prompt block the window completed, then
        stage the next prompt token or turn to DECODE off lane m."""
        prompt = self._prompt[slot]
        pos_old = int(self.pos[slot])
        self.pos[slot] += 1 + m
        self._fed[slot] += m
        pos_new = int(self.pos[slot])
        if self._paged:
            bs = self.pool.block_size
            q = (pos_old // bs + 1) * bs
            while q <= min(pos_new, len(prompt)):
                self.pool.register_block(slot, q // bs - 1, prompt,
                                         extra=self._patch_key)
                q += bs
        if self._fed[slot] < len(prompt):
            self._tokens_host[slot] = int(prompt[self._fed[slot]])
            self._fed[slot] += 1
        else:
            self._tokens_host[slot] = self._emit(
                slot, req, toks_host[slot, m], lambda s: fetch_row(m))
            self.phase[slot] = PHASE_DECODE
            if (isinstance(req, Request) and req.t_first_token is None
                    and now is not None):
                req.t_first_token = now
        return []

    def _advance_decode_window(self, slot, req, window, m, toks_host,
                               fetch_row) -> list[int]:
        """A DECODE slot with m draft lanes: accept the longest prefix where
        the sampled token equals the draft and emit a+1 tokens.  Temperature
        rows sample each lane with their host RNG, one draw per emitted
        token as on the plain path."""
        a = 0
        for j in range(m + 1):
            # one simulated plain tick per lane: the plain path's
            # completing tick samples nothing, and neither may this one
            self.pos[slot] += 1
            self.remaining[slot] -= 1
            if self.remaining[slot] <= 0:
                self.stats.on_speculate(m, a)
                self.active[slot] = False
                return [slot]
            tok = self._emit(slot, req, toks_host[slot, j],
                             lambda s, j=j: fetch_row(j))
            self._tokens_host[slot] = tok
            if not (j < m and tok == int(window[slot, j + 1])):
                break
            a += 1
        self.stats.on_speculate(m, a)
        return []

    def release_slot(self, slot: int):
        """Free a finished slot; its owner is cleared with it, and a paged
        slot drops its block references."""
        self.active[slot] = False
        self.phase[slot] = PHASE_FREE
        self._prompt[slot] = None
        self._fed[slot] = 0
        self.slot_owner.pop(slot, None)
        if self._paged:
            self.pool.release(slot)

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
        if self._paged:
            # with every slot released, dropping the registry's references
            # drives every block refcount back to zero
            self.pool.release_registry()
        return out

    def lifetime(self) -> dict:
        """Lifetime accumulators for fleet-level metrics."""
        out = {
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
        if self._paged:
            out["prefix_hits"] = int(self.pool.n_prefix_hits)
            out["prefix_admits"] = int(self.pool.n_admits)
            out["tokens_shared"] = int(self.pool.tokens_shared)
        return out

    @property
    def cache(self):
        return self.pool.cache

    @cache.setter
    def cache(self, value):
        self.pool.cache = value
