"""The port's paged KV pool against the JAX reference, on the CPU.

- K5/K6 plain versions (what ``ops.decode_attention_paged`` and
  ``ops.cache_paged_update`` run on CPU tensors) against the reference's
  oracles and its Pallas kernels in interpret mode, on the same numpy
  inputs: attention within atol = rtol = 2e-5 in float32, the write
  exactly; under an identity table the paged plain version equals the
  dense one bitwise.  ``ops.decode_attention_paged_write`` (K5 with the
  K6 write folded in) against the reference's two ``cache_paged_update``
  calls and ``decode_attention_paged``: the pools exactly, outputs within
  the same tolerance (2e-2 against the Pallas kernel over bf16 pools,
  which keeps its probabilities in float32).
- ``Attention.decode`` with a block table and ``LM.decode`` on a paged
  cache at bridged weights: outputs and written pool rows within
  atol = rtol = 2e-5, rows not written bit-identical.
- ``PagedSlotPool`` driven by the same call sequence as the reference's:
  tables, refcounts, free lists, slot blocks, the registry in LRU order and
  the prefix counters equal after every call; copied pool contents equal.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import LM as RefLM
from repro.models.attention import Attention as RefAttention
from repro.models.rotary import rope_angles as ref_rope_angles
from repro.serving import PagedSlotPool as RefPagedSlotPool
from repro.serving import paged_cache_spec as ref_paged_cache_spec
from repro.serving.slots import pool_geometry as ref_pool_geometry

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models.bridge import from_reference
from repro_torch.models.rotary import rope_angles
from repro_torch.serving import PagedSlotPool, make_pool, paged_cache_spec
from repro_torch.serving.slots import pool_geometry

ARCH = "qwen2.5-3b"
ATOL = RTOL = 2e-5
MAX_SEQ = 24
BK = 4


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------- K5 / K6 plain versions


@pytest.mark.parametrize("bk,nk,NB", [(8, 4, 13), (4, 8, 40), (6, 5, 31)])
@pytest.mark.parametrize("index", [[0, 7, 31], [31, 12, 1], [5, 5, 5],
                                   [2, 40, 29]])
def test_decode_attention_paged_plain_matches_reference(bk, nk, NB, index):
    B, H, KV, hd = 3, 4, 2, 32
    q = _rand((B, 1, H, hd), 1)
    kc, vc = _rand((NB, bk, KV, hd), 2), _rand((NB, bk, KV, hd), 3)
    rng = np.random.default_rng(bk)
    tbl = np.stack([rng.permutation(NB)[:nk] for _ in range(B)]
                   ).astype(np.int32)
    idx = np.asarray(index, np.int32)
    got = ops.decode_attention_paged(_t(q), _t(kc), _t(vc), _t(tbl), _t(idx))
    want = jref.decode_attention_paged_ref(q, kc, vc, tbl, idx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)
    pallas = jops.decode_attention_paged(q, kc, vc, tbl, idx, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=ATOL,
                               rtol=RTOL)


@pytest.mark.parametrize("bk", [4, 6, 8])
def test_paged_plain_equals_dense_plain_bitwise(bk):
    """Identity layout: block b*nk + j holds row b's keys [j*bk, (j+1)*bk)."""
    B, H, KV, hd, nk = 2, 4, 2, 32, 8
    Smax = nk * bk
    q = _t(_rand((B, 1, H, hd), 4))
    kc, vc = _t(_rand((B, Smax, KV, hd), 5)), _t(_rand((B, Smax, KV, hd), 6))
    tbl = torch.arange(B * nk, dtype=torch.int32).reshape(B, nk)
    index = torch.tensor([Smax - 1, 3 * bk + 1], dtype=torch.int32)
    dense = ref.decode_attention_ref(q, kc, vc, index)
    paged = ops.decode_attention_paged(q, kc.reshape(B * nk, bk, KV, hd),
                                       vc.reshape(B * nk, bk, KV, hd), tbl,
                                       index)
    assert torch.equal(dense, paged)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_cache_paged_update_plain_is_exact(cache_dtype):
    NB, bk, KV, hd, B = 9, 8, 2, 32, 4
    cache = _rand((NB, bk, KV, hd), 7)
    new = _rand((B, KV, hd), 8)
    blk = np.asarray([1, 4, 7, 2], np.int32)
    off = np.asarray([0, 3, 7, 5], np.int32)
    jc = jnp.asarray(cache).astype(cache_dtype)
    tc = _t(cache).to(getattr(torch, cache_dtype))
    before = tc.clone()
    out = ops.cache_paged_update(tc, _t(new), _t(blk), _t(off))
    assert out is tc                                   # written in place
    want = jref.cache_paged_update_ref(jc, jnp.asarray(new), blk, off)
    pallas = jops.cache_paged_update(jc, jnp.asarray(new), blk, off,
                                     interpret=True)
    got = tc.float().numpy()
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    np.testing.assert_array_equal(got, np.asarray(pallas, np.float32))
    untouched = np.ones(NB, bool)
    untouched[blk] = False
    assert torch.equal(tc[torch.from_numpy(untouched)],
                       before[torch.from_numpy(untouched)])


@pytest.mark.parametrize("cache_dtype,tol", [("float32", ATOL),
                                             ("bfloat16", 2e-2)])
@pytest.mark.parametrize("index", [[0, 7, 30], [45, 70, 33], [5, 40, 95]])
def test_decode_attention_paged_write_plain_matches_reference(index,
                                                              cache_dtype,
                                                              tol):
    """Indices below Smax = 32, wrapped past it, and mixed per row; each
    row writes into its own block of a shuffled table."""
    B, H, KV, hd, bk, nk = 3, 4, 2, 32, 4, 8
    NB, Smax = B * nk + 1, nk * bk
    q = _rand((B, 1, H, hd), 11)
    kc, vc = _rand((NB, bk, KV, hd), 12), _rand((NB, bk, KV, hd), 13)
    kn, vn = _rand((B, KV, hd), 14), _rand((B, KV, hd), 15)
    rng = np.random.default_rng(16)
    tbl = (1 + rng.permutation(B * nk)).reshape(B, nk).astype(np.int32)
    idx = np.asarray(index, np.int32)
    dt = getattr(torch, cache_dtype)
    tk, tv = _t(kc).to(dt), _t(vc).to(dt)
    uk, uv = tk.clone(), tv.clone()
    out = ops.decode_attention_paged_write(_t(q), _t(kn), _t(vn), tk, tv,
                                           _t(tbl), _t(idx))
    # what the port ran before the fold, one call after another
    rpos = idx % Smax
    blk = tbl[np.arange(B), rpos // bk]
    off = (rpos % bk).astype(np.int32)
    ops.cache_paged_update(uk, _t(kn), _t(blk), _t(off))
    ops.cache_paged_update(uv, _t(vn), _t(blk), _t(off))
    assert torch.equal(out, ops.decode_attention_paged(_t(q), uk, uv,
                                                       _t(tbl), _t(idx)))
    assert torch.equal(tk, uk) and torch.equal(tv, uv)
    # the reference: two table-routed writes (Pallas), then paged decode
    jk = jops.cache_paged_update(jnp.asarray(kc).astype(cache_dtype),
                                 jnp.asarray(kn), blk, off, interpret=True)
    jv = jops.cache_paged_update(jnp.asarray(vc).astype(cache_dtype),
                                 jnp.asarray(vn), blk, off, interpret=True)
    np.testing.assert_array_equal(tk.float().numpy(),
                                  np.asarray(jk, np.float32))
    np.testing.assert_array_equal(tv.float().numpy(),
                                  np.asarray(jv, np.float32))
    np.testing.assert_allclose(
        out.numpy(), np.asarray(jref.decode_attention_paged_ref(
            q, jk, jv, tbl, idx), np.float32), atol=ATOL, rtol=RTOL)
    pallas = jops.decode_attention_paged(q, jk, jv, tbl, idx, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(pallas, np.float32),
                               atol=tol, rtol=tol)


# -------------------------------------------------------- model on a paged pool


@functools.lru_cache(maxsize=None)
def pair():
    rcfg = ref_smoke_config(ARCH)
    params = jax.jit(lambda key: RefLM.init(key, rcfg)[0])(
        jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, params)
    return rcfg, params, from_reference(params, get_smoke_config(ARCH),
                                        device="cpu")


def _pool(rcfg, L, B, nk, bk, seed):
    NB = B * nk + 1
    hd = rcfg.d_model // rcfg.n_heads
    shape = (L, NB, bk, rcfg.n_kv_heads, hd)
    rng = np.random.default_rng(seed)
    tbl = (1 + rng.permutation(B * nk)).reshape(B, nk).astype(np.int32)
    return _rand(shape, seed + 1), _rand(shape, seed + 2), tbl


def test_attention_decode_with_block_table_matches_reference():
    rcfg, params, model = pair()
    B, nk, bk = 2, 6, BK
    k, v, tbl = _pool(rcfg, 1, B, nk, bk, seed=10)
    k, v = k[0], v[0]
    index = np.array([5, 17], np.int32)
    x = _rand((B, 1, rcfg.d_model), 11)
    pos = index[:, None]
    ja = ref_rope_angles(jnp.asarray(pos), rcfg.hd, rcfg.rope_theta)
    ta = rope_angles(torch.from_numpy(pos), rcfg.hd, rcfg.rope_theta)
    lp = jax.tree.map(lambda p: p[0], params["blocks"])
    y, rc = RefAttention.decode(lp["attn"], x, rcfg,
                                {"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                jnp.asarray(index), angles=ja,
                                block_tbl=jnp.asarray(tbl))
    tc = {"k": _t(k), "v": _t(v)}
    ty, tc2 = model.blocks[0].attn.decode(_t(x), tc, _t(index), angles=ta,
                                          block_tbl=_t(tbl))
    assert tc2["k"] is tc["k"]                         # written in place
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=ATOL,
                               rtol=RTOL)
    written = np.zeros(k.shape[:2], bool)
    written[tbl[np.arange(B), index // bk], index % bk] = True
    for n, before in (("k", k), ("v", v)):
        got = tc[n].numpy()
        np.testing.assert_allclose(got[written], np.asarray(rc[n])[written],
                                   atol=ATOL, rtol=RTOL)
        np.testing.assert_array_equal(got[~written], before[~written])


def test_lm_decode_on_paged_cache_matches_reference():
    rcfg, params, model = pair()
    B, nk, bk = 2, MAX_SEQ // BK, BK
    k, v, tbl = _pool(rcfg, rcfg.n_layers, B, nk, bk, seed=20)
    index = np.array([3, 14], np.int32)
    rcache = {"index": jnp.asarray(index), "block_tbl": jnp.asarray(tbl),
              "layers": {"k": jnp.asarray(k), "v": jnp.asarray(v)}}
    tcache = {"index": _t(index), "block_tbl": _t(tbl),
              "layers": {"k": _t(k), "v": _t(v)}}
    rdecode = jax.jit(lambda p, t, c: RefLM.decode(p, t, rcfg, c))
    rng = np.random.default_rng(21)
    for _ in range(3):
        tok = rng.integers(0, rcfg.vocab, (B, 1)).astype(np.int32)
        rlogits, rcache = rdecode(params, jnp.asarray(tok), rcache)
        with torch.no_grad():
            tlogits, tcache = model.decode(_t(tok), tcache)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(rlogits),
                                   atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(tcache["index"].numpy(), index + 3)
    np.testing.assert_array_equal(tcache["block_tbl"].numpy(), tbl)
    for n, before in (("k", k), ("v", v)):
        got, want = tcache["layers"][n].numpy(), np.asarray(
            rcache["layers"][n])
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
        # the trash block 0 is named by no row: untouched
        np.testing.assert_array_equal(got[:, 0], before[:, 0])


# ----------------------------------------------------------------- allocator


def test_paged_cache_spec_and_geometry_match_reference():
    cfg, rcfg = get_smoke_config(ARCH), ref_smoke_config(ARCH)
    got = paged_cache_spec(cfg, 4, MAX_SEQ, block_size=BK, num_blocks=25)
    want = ref_paged_cache_spec(rcfg, 4, MAX_SEQ, block_size=BK,
                                num_blocks=25)
    assert set(got) == set(want) == {"index", "layers", "block_tbl"}
    for leaf_g, leaf_w in ((got["index"], want["index"]),
                           (got["block_tbl"], want["block_tbl"]),
                           (got["layers"]["k"], want["layers"]["k"]),
                           (got["layers"]["v"], want["layers"]["v"])):
        assert leaf_g[0] == leaf_w[0] and leaf_g[2] == leaf_w[2]
    for slots, max_seq, bs, nb, parts in [(2, 24, None, None, 1),
                                          (4, 12, None, None, 2),
                                          (3, 7, None, None, 1),
                                          (4, 32, 8, None, 2),
                                          (2, 16, 4, 9, 1)]:
        assert pool_geometry(slots, max_seq, block_size=bs, num_blocks=nb,
                             partitions=parts) == ref_pool_geometry(
            slots, max_seq, block_size=bs, num_blocks=nb, partitions=parts)
    with pytest.raises(ValueError, match="divide"):
        pool_geometry(2, 24, block_size=5)


def assert_same_state(port, refp):
    np.testing.assert_array_equal(port.tables, refp.tables)
    np.testing.assert_array_equal(port.refcount, refp.refcount)
    np.testing.assert_array_equal(port.cache["block_tbl"].numpy(),
                                  np.asarray(refp.cache["block_tbl"]))
    assert port.free == [[int(b) for b in f] for f in refp.free]
    assert port.slot_blocks == [[int(b) for b in s]
                                for s in refp.slot_blocks]
    assert ([[(k, int(b)) for k, b in r.items()] for r in port.registry]
            == [[(k, int(b)) for k, b in r.items()] for r in refp.registry])
    assert ((port.n_admits, port.n_prefix_hits, port.tokens_shared)
            == (refp.n_admits, refp.n_prefix_hits, refp.tokens_shared))


def assert_same_leaves(port, refp):
    for n in ("k", "v"):
        np.testing.assert_array_equal(port.cache["layers"][n].numpy(),
                                      np.asarray(refp.cache["layers"][n]))


def drive(calls, slots, max_seq, **geometry):
    """Apply the same calls to both pools, comparing after each one."""
    port = PagedSlotPool(get_smoke_config(ARCH), slots, max_seq,
                         device="cpu", **geometry)
    refp = RefPagedSlotPool(ref_smoke_config(ARCH), slots, max_seq,
                            **geometry)
    assert_same_state(port, refp)
    for name, *args in calls:
        if name == "mark":                       # fill a block's contents
            slot, j, value = args
            blk = int(port.tables[slot, j])
            port.cache["layers"]["k"][:, blk] = value
            k = refp.cache["layers"]["k"].at[:, blk].set(value)
            refp.cache = {**refp.cache,
                          "layers": {**refp.cache["layers"], "k": k}}
            continue
        if name == "write":                      # a prefill's batch-1 cache
            slot, S, seed = args
            L, KV = port.cfg.n_layers, port.cfg.n_kv_heads
            shape = (L, 1, S, KV, port.cfg.d_model // port.cfg.n_heads)
            one = {"k": _rand(shape, seed), "v": _rand(shape, seed + 1)}
            port.write({"index": torch.tensor(S, dtype=torch.int32),
                        "layers": {n: _t(a) for n, a in one.items()}}, slot)
            refp.write({"index": jnp.asarray(S, jnp.int32),
                        "layers": {n: jnp.asarray(a)
                                   for n, a in one.items()}}, slot)
            np.testing.assert_array_equal(port.index.numpy(),
                                          np.asarray(refp.index))
            assert_same_leaves(port, refp)
            continue
        outcomes = []
        for pool in (port, refp):
            try:
                outcomes.append(("ok", getattr(pool, name)(*args)))
            except AssertionError as e:
                outcomes.append(("raised", "exhausted" in str(e)))
        (kind_p, got), (kind_r, want) = outcomes
        assert kind_p == kind_r, (name, args, outcomes)
        if isinstance(want, tuple):               # lookup_prefix
            want = (want[0], [int(b) for b in want[1]])
        assert got == want, (name, args, got, want)
        assert_same_state(port, refp)
    assert_same_leaves(port, refp)
    return port, refp


def test_pool_share_write_fork_release_equal_reference():
    prompt = np.arange(3, 14, dtype=np.int32)              # 11 tokens
    prompt2 = np.concatenate([prompt[:8], np.asarray([60, 61, 62], np.int32)])
    calls = [("can_admit", 0, prompt, 3), ("admit_slot", 0, prompt, 3),
             ("write", 0, 4, 30),
             ("register_block", 0, 0, prompt),
             ("register_block", 0, 1, prompt),
             ("register_block", 0, 1, prompt),            # already known
             ("lookup_prefix", 1, prompt2),
             ("admit_slot", 1, prompt2, 3),                # a prefix hit
             ("mark", 1, 0, 7.5),
             ("ensure_private", 1, 0),                     # COW fork
             ("ensure_private", 0, 2),                     # private: no-op
             ("release", 0), ("release", 1),
             ("admit_slot", 0, prompt, 3),                 # hit after release
             ("release", 0), ("release_registry",)]
    port, _ = drive(calls, 2, MAX_SEQ, block_size=BK)
    assert (port.refcount == 0).all()
    assert port.n_prefix_hits == 2


def test_pool_lru_reclaim_under_pressure_equals_reference():
    nk = MAX_SEQ // BK
    long_a = np.arange(3, 23, dtype=np.int32)             # 20 tokens
    long_b = np.arange(40, 60, dtype=np.int32)
    calls = [("admit_slot", 0, long_a, 4)]
    calls += [("register_block", 0, j, long_a) for j in range(4)]
    calls += [("release", 0), ("can_admit", 0, long_b, 4),
              ("admit_slot", 0, long_b, 4),
              ("admit_slot", 1, long_b[::-1].copy(), 4),  # full reclaim
              ("release", 0), ("release", 1), ("release_registry",)]
    drive(calls, 2, MAX_SEQ, block_size=BK, num_blocks=2 * nk + 1)


def test_pool_pinned_hits_equal_reference():
    """tests/test_paged_pool.py's pinned-hit cases: an admission whose only
    evictable blocks are its own hits is refused and rolled back; with
    other registry blocks to evict it succeeds with distinct blocks."""
    prompt_a = np.arange(3, 15, dtype=np.int32)           # 12 tokens
    other = np.arange(40, 48, dtype=np.int32)
    calls = [("admit_slot", 0, prompt_a, 4),
             ("register_block", 0, 0, prompt_a),
             ("register_block", 0, 1, prompt_a),
             ("release", 0), ("admit_slot", 1, other, 0),
             ("lookup_prefix", 0, prompt_a),
             ("can_admit", 0, prompt_a, 4),
             ("admit_slot", 0, prompt_a, 4),               # exhausted
             ("release", 1), ("admit_slot", 0, prompt_a, 4)]
    port, _ = drive(calls, 2, 16, block_size=4, num_blocks=5)
    row = [int(b) for b in port.tables[0]]
    assert len(set(row)) == len(row)
    calls = [("admit_slot", 0, prompt_a, 4)]
    calls += [("register_block", 0, j, prompt_a) for j in range(3)]
    calls += [("release", 0), ("admit_slot", 0, prompt_a, 4),
              ("release", 0), ("release_registry",)]
    port, _ = drive(calls, 1, 16, block_size=4, num_blocks=5)
    assert (port.refcount == 0).all()


def test_pool_partitions_equal_reference():
    """Two partitions: each slot draws from and shares within its own
    range, with its own trash block."""
    prompt = np.arange(3, 14, dtype=np.int32)
    calls = [("admit_slot", 0, prompt, 3), ("admit_slot", 2, prompt, 3),
             ("write", 2, 8, 40),
             ("register_block", 0, 0, prompt),
             ("register_block", 0, 1, prompt),
             ("admit_slot", 1, prompt, 3),                 # partition 0 hit
             ("admit_slot", 3, prompt, 3),                 # partition 1 miss
             ("release", 0), ("release", 1), ("release", 2), ("release", 3),
             ("release_registry",)]
    port, _ = drive(calls, 4, MAX_SEQ, block_size=BK, partitions=2)
    assert port.trash == [0, port.nb_local]
    assert port.n_prefix_hits == 1
    assert (port.refcount == 0).all()


def test_sliding_window_pool_stays_dense():
    cfg = get_smoke_config("h2o-danube-1.8b")
    pool = make_pool(cfg, 2, MAX_SEQ, pool="paged", block_size=BK,
                     device="cpu")
    refp = RefPagedSlotPool(ref_smoke_config("h2o-danube-1.8b"), 2, MAX_SEQ,
                            block_size=BK)
    assert not pool.is_paged and not refp.is_paged
    assert pool.can_share == refp.can_share is False
    assert pool.cache["layers"]["k"].shape == refp.cache["layers"]["k"].shape
