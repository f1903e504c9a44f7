"""One replica across a device mesh (``ShardedReplica``) against the
reference's unsharded ``InProcessReplica``, on the CPU, at the reference's
weights carried across (``models.bridge``).

The reference's own sharded tests cannot run here (its 2-device mesh needs
a re-exec, and its sharded topology test fails under this JAX), and they
assert one property: the fabric changes nothing observable.  So the port
is held to that property against the reference's unsharded replica:

* on meshes of 1, 2 and 4 CPU shards, dense and paged pools, the dense
  decoder (qwen2.5-3b) and the hybrid (zamba2-2.7b) smoke configs: token
  streams equal, request for request, with staggered admissions;
* the logits of one tick after staggered admissions within atol = rtol =
  1e-5 (float32; the reference holds its sharded tick to the same) of the
  reference's decode on the same state;
* on the paged pool over 2 and 4 shards, prompts sharing a block-aligned
  prefix hit each partition's prefix registry, and a copy-on-write fork
  of a shared block (``ensure_private``) on each shard leaves the streams
  equal to the reference's;
* slots that do not divide over the mesh raise;
* the ``sharded`` router topology serves the same streams.

Each shard's slots sit in a cache of their own on the shard's device (the
CPU here), so a 4-shard tick runs ``LM.decode`` four times at batch 1.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.serving import InProcessReplica as RefInProcessReplica
from repro.serving import Request as RefRequest
from repro.serving.engine import EngineCore as RefEngineCore

from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.bridge import from_reference
from repro_torch.serving import (
    ReplicaRouter, Request, ShardedCache, ShardedReplica,
)
from repro_torch.serving.engine import EngineCore

ARCHS = ["qwen2.5-3b", "zamba2-2.7b"]
SLOTS, MAX_SEQ, CHUNK = 4, 24, 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def cores(arch):
    ref = RefEngineCore(ref_smoke_config(arch), MAX_SEQ, seed=0)
    cfg = get_smoke_config(arch)
    params = from_reference(jax.tree.map(np.asarray, ref.params), cfg,
                            device="cpu")
    return ref, EngineCore(cfg, MAX_SEQ, params=params, device="cpu")


def _requests(cls, vocab, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=i, prompt=rng.integers(3, vocab, size=6 + i
                                           ).astype(np.int32), gen_len=5)
            for i in range(n)]


def _run(rep, reqs):
    """Two requests, two ticks, then the rest: staggered admissions."""
    done, now = [], 0.0
    for r in reqs[:2]:
        rep.submit(r, now=0.0)
    for _ in range(2):
        now += 1.0
        done.extend(rep.step(now))
    for r in reqs[2:]:
        rep.submit(r, now=now)
    while len(done) < len(reqs) and now < 200:
        now += 1.0
        done.extend(rep.step(now))
    return {r.rid: tuple(r.tokens_out) for r in done}


@functools.lru_cache(maxsize=None)
def ref_streams(arch, pool):
    ref, _ = cores(arch)
    rep = RefInProcessReplica.build(ref.cfg, slots=SLOTS, max_seq=MAX_SEQ,
                                    prefill_chunk=CHUNK, core=ref, pool=pool)
    return _run(rep, _requests(RefRequest, ref.cfg.vocab))


def _mesh(n):
    return make_mesh((n,), ("data",), devices=["cpu"] * n)


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("pool", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_streams_equal_reference(arch, pool, shards):
    _, core = cores(arch)
    rep = ShardedReplica(core.cfg, slots=SLOTS, max_seq=MAX_SEQ,
                         prefill_chunk=CHUNK, core=core, pool=pool,
                         mesh=_mesh(shards))
    assert isinstance(rep.engine.pool.cache, ShardedCache)
    assert len(rep.engine.pool.cache.shards) == shards
    got = _run(rep, _requests(Request, core.cfg.vocab))
    assert got == ref_streams(arch, pool)
    assert all(len(t) == 5 for t in got.values())
    # every decode took the legacy bulk path: (slots, V) logits pulled
    assert rep.engine.logits_pulls > 0 == rep.engine.fused_ticks


def _clone(cache: ShardedCache) -> ShardedCache:
    from repro_torch.serving.slots import _map_tree
    return cache.replace([_map_tree(torch.clone, s) for s in cache.shards])


@pytest.mark.parametrize("pool", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_first_tick_logits_match_reference(arch, pool):
    ref, core = cores(arch)
    rref = RefInProcessReplica.build(ref.cfg, slots=SLOTS, max_seq=MAX_SEQ,
                                     prefill_chunk=CHUNK, core=ref, pool=pool)
    rep = ShardedReplica(core.cfg, slots=SLOTS, max_seq=MAX_SEQ,
                         prefill_chunk=CHUNK, core=core, pool=pool,
                         mesh=_mesh(2))
    for target, cls in ((rref, RefRequest), (rep, Request)):
        reqs = _requests(cls, ref.cfg.vocab)
        target.submit(reqs[0], now=0.0)
        target.step(1.0)                       # slot 0 one tick ahead
        target.submit(reqs[3], now=1.0)        # slot 1: a longer prompt
        target.step(2.0)
    eng = rep.engine
    np.testing.assert_array_equal(eng.tokens.numpy(),
                                  np.asarray(rref.engine.tokens))
    want, _ = ref.decode(ref.params, rref.engine.tokens,
                         jax.tree.map(jnp.copy, rref.engine.pool.cache))
    got, cache = eng.decode(eng.params, eng.tokens, _clone(eng.pool.cache))
    assert isinstance(cache, ShardedCache) and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=1e-5, rtol=1e-5)


def _prefix_requests(cls, vocab, n=8, seed=0):
    """Prompts of one shared 8-token prefix (two 4-token blocks) and three
    tokens of their own."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(3, vocab, size=8).astype(np.int32)
    return [cls(rid=i, prompt=np.concatenate(
        [prefix, rng.integers(3, vocab, size=3).astype(np.int32)]),
        gen_len=3) for i in range(n)]


def _run_one_a_step(rep, reqs, after_step=lambda: None):
    """One submission a step, so later prompts find earlier ones'
    registered prefix blocks."""
    done, now = [], 0.0
    for i in range(300):
        if len(done) == len(reqs):
            break
        if i < len(reqs):
            rep.submit(reqs[i], now=now)
        now += 1.0
        done.extend(rep.step(now))
        after_step()
    return {r.rid: tuple(r.tokens_out) for r in done}


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_paged_prefix_sharing_and_fork(shards):
    """The paged pool over a mesh with real prefix hits: every partition's
    registry holds the shared prefix, admissions hit it, and each shared
    block a slot maps is forked copy-on-write (``ensure_private``) mid-run
    on the slot's shard: the fork lands in the slot's block range, its
    content equals the shared block's, and the streams stay equal to the
    reference's unsharded replica's."""
    ref, core = cores("qwen2.5-3b")
    rref = RefInProcessReplica.build(ref.cfg, slots=SLOTS, max_seq=MAX_SEQ,
                                     prefill_chunk=CHUNK, core=ref)
    want = _run_one_a_step(rref, _prefix_requests(RefRequest, ref.cfg.vocab))
    rep = ShardedReplica(core.cfg, slots=SLOTS, max_seq=MAX_SEQ,
                         prefill_chunk=CHUNK, core=core, pool="paged",
                         block_size=4, mesh=_mesh(shards))
    pool = rep.engine.pool
    forked = []

    def fork():
        for slot in range(SLOTS):
            blk = int(pool.tables[slot, 0])
            if pool.refcount[blk] <= 1 or (slot, blk) in forked:
                continue
            new = pool.ensure_private(slot, 0)
            k, _ = pool._locate(slot)
            lo = k * pool.nb_local
            assert new != blk and lo <= new < lo + pool.nb_local
            assert int(pool.tables[slot, 0]) == new
            local = pool.cache.shards[k]
            assert torch.equal(local["block_tbl"][slot - k * pool.per_shard],
                               torch.from_numpy(pool.tables[slot]))
            for leaf in ("k", "v"):
                blocks = local["layers"][leaf]
                assert torch.equal(blocks[:, new - lo], blocks[:, blk - lo])
            forked.append((slot, blk))

    got = _run_one_a_step(rep, _prefix_requests(Request, core.cfg.vocab),
                          fork)
    assert got == want
    assert pool.n_prefix_hits >= shards
    assert all(len(reg) == 2 for reg in pool.registry)
    assert {pool._partition(s) for s, _ in forked} == set(range(shards))


def test_indivisible_slots_raise():
    _, core = cores("qwen2.5-3b")
    with pytest.raises(ValueError, match="divide evenly"):
        ShardedReplica(core.cfg, slots=3, max_seq=MAX_SEQ, core=core,
                       mesh=_mesh(2))
    with pytest.raises(ValueError, match="divide evenly"):
        ShardedReplica(core.cfg, slots=2, max_seq=MAX_SEQ, core=core,
                       mesh=_mesh(4), pool="paged")


@pytest.mark.parametrize("pool", ["dense", "paged"])
def test_sharded_topology_serves_reference_streams(pool):
    """``from_topology("sharded")``: the replicas share one core and one
    sharded decode; two replicas over a 2-shard mesh serve the reference's
    streams (least-loaded routing spreads the requests)."""
    ref, core = cores("qwen2.5-3b")
    router = ReplicaRouter.from_topology(
        core.cfg, "sharded", slots=SLOTS, max_seq=MAX_SEQ,
        prefill_chunk=CHUNK, n_replicas=2, mesh=_mesh(2), pool=pool,
        params=core.params, device="cpu")
    assert [r.kind for r in router.replicas] == ["sharded", "sharded"]
    assert router.replicas[0].engine.decode is \
        router.replicas[1].engine.decode
    reqs = _requests(Request, core.cfg.vocab)
    for r in reqs:
        router.submit(r, now=0.0)
    done, now = [], 0.0
    while len(done) < len(reqs) and now < 200:
        now += 1.0
        done.extend(router.step(now))
    got = {r.rid: tuple(r.tokens_out) for r in done}
    rref = RefInProcessReplica.build(ref.cfg, slots=SLOTS, max_seq=MAX_SEQ,
                                     prefill_chunk=CHUNK, core=ref, pool=pool)
    want = {}
    for r in _requests(RefRequest, ref.cfg.vocab):
        rref.submit(r, now=0.0)
    now = 0.0
    while len(want) < len(reqs) and now < 200:
        now += 1.0
        want.update({r.rid: tuple(r.tokens_out) for r in rref.step(now)})
    assert got == want
    assert {r.replica_id for r in done} == {0, 1}
    router.close()
