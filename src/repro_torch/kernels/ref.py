"""Plain PyTorch versions of the kernels on the serving path.

Written from the JAX oracles in ``repro.kernels.ref``, with the same
numerics: full-materialization attention with a float32 softmax (the paged
form over the gathered block pool), the indexed ring-slot and paged
scatters, decode with the row write folded in as the two scatters and the
attention in turn, the murmur3-counter Gumbel-max sampler, and the
sequential SSD (Mamba2) recurrence.  On a
CPU tensor the kernel wrappers run these; on the card, tests and
``chip_smoke.py`` hold each CUDA kernel against them.
"""
from __future__ import annotations

import torch

NEG_INF = -1e9

# murmur3 fmix32 constants of repro/kernels/sample.py
M1 = 0x85EBCA6B
M2 = 0xC2B2AE35
GOLDEN = 0x9E3779B9
_MASK = 0xFFFFFFFF


def _attend(qg, k, v, ok):
    """qg: (B, Sq, KV, G, hd); k/v: (B, Sk, KV, hd); ok: bool mask
    broadcastable to (B, KV, G, Sq, Sk) → (B, Sq, KV, G, hd) float32."""
    hd = qg.shape[-1]
    scores = torch.einsum("bskgh,btkh->bkgst", qg.float(), k.float())
    scores = scores * (hd ** -0.5)
    scores = scores + torch.where(ok, 0.0, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # the oracle rounds the probabilities to the value dtype before P @ V
    probs = probs.to(v.dtype).float()
    return torch.einsum("bkgst,btkh->bskgh", probs, v.float())


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q: (B, Sq, H, hd); k/v: (B, Sk, KV, hd) — GQA, float32 softmax."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    q_pos = torch.arange(Sq, device=q.device)[:, None]
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    ok = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        ok &= k_pos <= q_pos
    if window is not None:
        ok &= k_pos > q_pos - window
    out = _attend(q.reshape(B, Sq, KV, H // KV, hd), k, v, ok)
    return out.reshape(B, Sq, H, hd).to(q.dtype)


def _rows_index(index, B, device):
    """An int or (B,) index as a (B,) int32 tensor."""
    return torch.as_tensor(index, dtype=torch.int32,
                           device=device).reshape(-1).expand(B)


def decode_attention_ref(q, k_cache, v_cache, index):
    """q: (B, 1, H, hd); caches: (B, Smax, KV, hd); slots > index masked.
    ``index`` is an int or a (B,) tensor: row b sees slots <= index[b]
    (every slot once the ring has wrapped)."""
    B, _, H, hd = q.shape
    Smax, KV = k_cache.shape[1], k_cache.shape[2]
    idx = _rows_index(index, B, q.device)
    ok = (torch.arange(Smax, device=q.device)[None, :] <= idx[:, None])
    out = _attend(q.reshape(B, 1, KV, H // KV, hd), k_cache, v_cache,
                  ok[:, None, None, None, :])
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_paged_ref(q, k_cache, v_cache, tbl, index):
    """q: (B, 1, H, hd); caches: (NB, bk, KV, hd) physical block pools;
    tbl: (B, nk) block table; index: int or (B,).  Gathers each row's
    logical sequence ``pool[tbl[b]]`` → (nk·bk, KV, hd) and runs the dense
    decode attention on it, so under an identity table it equals the dense
    plain version bitwise."""
    B, nk = tbl.shape
    bk = k_cache.shape[1]
    tbl = tbl.long()
    kg = k_cache[tbl].reshape(B, nk * bk, *k_cache.shape[2:])
    vg = v_cache[tbl].reshape(B, nk * bk, *v_cache.shape[2:])
    return decode_attention_ref(q, kg, vg, index)


def cache_paged_update_ref(cache, new, blk, off):
    """cache: (NB, bk, KV, hd); new: (B, KV, hd); blk/off: (B,) — writes
    ``new[b]`` into ``cache[blk[b], off[b]]`` in place and returns the
    cache.  Rows that name the same (blk, off) collide: which one lands is
    undefined, here as in the kernel."""
    cache[blk.long(), off.long()] = new.to(cache.dtype)
    return cache


def cache_ring_update_ref(cache, new, slot):
    """cache: (B, Smax, KV, hd); new: (B, KV, hd); slot: (B,) — writes
    ``new[b]`` into ``cache[b, slot[b]]`` in place and returns the cache."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache[rows, slot.long()] = new.to(cache.dtype)
    return cache


def decode_attention_write_ref(q, k_new, v_new, k_cache, v_cache, index):
    """The write instance of K1 as the unfused composition: k_new and v_new
    (B, KV, hd) into slot ``index % Smax`` of each row (two
    ``cache_ring_update_ref``), then ``decode_attention_ref``."""
    slot = torch.remainder(_rows_index(index, q.shape[0], q.device),
                           k_cache.shape[1])
    cache_ring_update_ref(k_cache, k_new, slot)
    cache_ring_update_ref(v_cache, v_new, slot)
    return decode_attention_ref(q, k_cache, v_cache, index)


def decode_attention_paged_write_ref(q, k_new, v_new, k_cache, v_cache, tbl,
                                     index):
    """The write instance of K5 as the unfused composition: k_new and v_new
    into logical key rpos = ``index % (nk·bk)`` of each row,
    ``pool[tbl[b, rpos // bk], rpos % bk]`` (two ``cache_paged_update_ref``),
    then ``decode_attention_paged_ref``."""
    B, nk = tbl.shape
    bk = k_cache.shape[1]
    rpos = torch.remainder(_rows_index(index, B, q.device), nk * bk)
    blk = tbl[torch.arange(B, device=q.device), (rpos // bk).long()]
    off = rpos % bk
    cache_paged_update_ref(k_cache, k_new, blk, off)
    cache_paged_update_ref(v_cache, v_new, blk, off)
    return decode_attention_paged_ref(q, k_cache, v_cache, tbl, index)


def _mul32(v, m: int):
    """(v * m) mod 2**32 for int64 ``v`` < 2**32 without leaving int64: the
    16-bit halves of ``m`` keep every partial product below 2**49."""
    lo = v * (m & 0xFFFF)
    hi = ((v * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix(v):
    """murmur3 fmix32 on int64 tensors holding uint32 values (PyTorch has
    only partial uint32 arithmetic on the CPU)."""
    v = v ^ (v >> 16)
    v = _mul32(v, M1)
    v = v ^ (v >> 13)
    v = _mul32(v, M2)
    return v ^ (v >> 16)


def _u32(x):
    return torch.as_tensor(x).to(torch.int64) & _MASK


def sample_bits(seed, rid, pos, V: int):
    """(B, V) int64 hash bits of (seed, rid, pos, column), values < 2**32."""
    key = _mix(GOLDEN ^ _u32(seed))
    key = _mix(key ^ _u32(rid))
    key = _mix(key ^ _u32(pos))                                 # (B,)
    cols = torch.arange(V, dtype=torch.int64, device=key.device)
    return _mix(key[:, None] ^ cols[None, :])


def gumbel_noise(bits):
    """Hash bits → Gumbel noise g = -log(-log(u)), u in (0, 1), float32."""
    u = ((bits >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def fused_sample_ref(logits, seed, rid, pos, temperature, *, top_k: int = 0):
    """logits: (B, V); seed/rid/pos: (B,) int32 counters; temperature: (B,)
    float32 → (B,) int32 tokens.  ``temperature == 0`` rows take the first
    index of the float32 maximum; other rows take the Gumbel-max of
    ``logits / t + g``.  ``top_k > 0`` masks scaled logits below the row's
    k-th largest before the noise."""
    B, V = logits.shape
    x = logits.float()
    g = gumbel_noise(sample_bits(seed, rid, pos, V))
    t = torch.as_tensor(temperature, dtype=torch.float32,
                        device=x.device)[:, None]
    scaled = x / torch.clamp(t, min=1e-30)
    if top_k > 0:
        k = min(top_k, V)
        kth = torch.sort(scaled, dim=1).values[:, V - k][:, None]
        scaled = torch.where(scaled >= kth, scaled, float("-inf"))
    score = torch.where(t > 0.0, scaled + g, x)
    return torch.argmax(score, dim=1).to(torch.int32)


def ssm_scan_ref(x, dt, A, B, C, *, return_state: bool = False):
    """SSD (Mamba2) recurrence, step by step (``repro.kernels.ref.
    ssm_scan_ref``).  x: (Bsz, L, H, hd); dt: (Bsz, L, H); A: (H,)
    (negative); B/C: (Bsz, L, H, N); all float32.  Returns y (Bsz, L, H, hd)
    float32 with h_t = exp(dt_t A) h_{t-1} + dt_t x_t ⊗ B_t and
    y_t = h_t · C_t; with ``return_state`` also the carried h after the last
    token, (Bsz, H, hd, N) — the reference's ``_mamba2_final_state``
    recomputes it with this same recurrence."""
    x, dt, A, B, C = (t.float() for t in (x, dt, A, B, C))
    Bsz, L, H, hd = x.shape
    h = torch.zeros(Bsz, H, hd, B.shape[-1], dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(L):
        a = torch.exp(dt[:, t] * A[None])                        # (Bsz, H)
        h = (a[..., None, None] * h
             + (dt[:, t, :, None] * x[:, t])[..., None] * B[:, t, :, None, :])
        ys.append(torch.einsum("bhdn,bhn->bhd", h, C[:, t]))
    y = torch.stack(ys, dim=1)
    return (y, h) if return_state else y
