"""The port's training substrate against the JAX package's, on the CPU:
schedules, SGD, clipping and error-feedback int8 compression
(``repro_torch.optim``), the counted token pipeline (``repro_torch.data``),
the checkpoint manager (``repro_torch.checkpoint``) and the train launcher
(``repro_torch.launch.train``).

- Schedules within 1e-6 of the reference's over steps 0..2·total.
- ``sgd``, ``clip_by_global_norm``, ``compress_int8`` and the error-feedback
  pair as ``tests/test_optim.py`` asserts them, and equal to the
  reference's on the same arrays (int8 payloads exactly).
- ``TokenPipeline`` (Zipf and memory-mapped file) and ``extra_inputs`` byte
  for byte the reference's, over seeds and steps, and as
  ``tests/test_checkpoint_data.py`` asserts them.
- ``CheckpointManager`` as ``tests/test_checkpoint_data.py`` asserts it
  (its elastic restore is ``tests/test_torch_train_mesh.py``'s), and on the
  port's own leaves: bfloat16, numbers, a module restored in place, a
  restore re-sharded onto a mesh.
- The launcher: checkpoints at 3 and 6, ``--resume`` to 9 bitwise equal to
  an uninterrupted 9-step run, the log's records as
  ``tests/test_integration.py`` reads them, SIGTERM's final checkpoint,
  ``--mesh`` refusing a Mamba model by name, cuda by default.
"""
import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY_CFGS
from repro.data import DataConfig as RefDataConfig
from repro.data import TokenPipeline as RefTokenPipeline
from repro.data import extra_inputs as ref_extra_inputs
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import sgd as ref_sgd
from repro.optim import apply_updates as ref_apply_updates
from repro.optim import compression as ref_compression
from repro.optim import schedule as ref_schedule

from repro_torch.checkpoint import (
    CheckpointManager, manager, restore_checkpoint, save_checkpoint,
)
from repro_torch.data import DataConfig, TokenPipeline, extra_inputs
from repro_torch.models import HybridCfg, ModelConfig, MoECfg, SSMCfg
from repro_torch.launch import train as launcher
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.steps import (
    ShapeDtypeStruct, init_train_state, make_train_step, model_inputs,
)
from repro_torch.sharding import NamedSharding, ShardedArray
from repro_torch.models.transformer import LM
from repro_torch.optim import (
    adamw, apply_updates, clip_by_global_norm, compress_int8,
    constant_schedule, cosine_schedule, decompress_int8, decompress_tree,
    error_feedback_compress, init_error_feedback, linear_warmup_cosine, sgd,
    wsd_schedule,
)


def port_cfg(rcfg, **kw):
    """The port's ModelConfig equal, field for field, to a reference one."""
    d = {**dataclasses.asdict(rcfg), **kw}
    for name, cls in (("ssm", SSMCfg), ("hybrid", HybridCfg), ("moe", MoECfg)):
        if isinstance(d[name], dict):
            d[name] = cls(**d[name])
    d["m_rope_sections"] = tuple(d["m_rope_sections"])
    return ModelConfig(**d)


def t(x):
    return torch.tensor(np.asarray(x))


def close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# ------------------------------------------------------------- schedules

SCHEDULES = {
    "constant": ((3e-4,), {}),
    "cosine": ((1e-3, 50), {"final_frac": 0.1}),
    "cosine0": ((2e-3, 0), {}),
    "warmup_cosine": ((1e-3, 10, 100), {"final_frac": 0.1}),
    "warmup_cosine_short": ((5e-4, 7, 9), {"final_frac": 0.0}),
    "wsd": ((1e-3, 10, 100), {"decay_frac": 0.2}),
    "wsd_default": ((3e-4, 3, 40), {}),
}
PORT = {"constant": constant_schedule, "cosine": cosine_schedule,
        "cosine0": cosine_schedule, "warmup_cosine": linear_warmup_cosine,
        "warmup_cosine_short": linear_warmup_cosine, "wsd": wsd_schedule,
        "wsd_default": wsd_schedule}
REF = {"constant": ref_schedule.constant_schedule,
       "cosine": ref_schedule.cosine_schedule,
       "cosine0": ref_schedule.cosine_schedule,
       "warmup_cosine": ref_schedule.linear_warmup_cosine,
       "warmup_cosine_short": ref_schedule.linear_warmup_cosine,
       "wsd": ref_schedule.wsd_schedule,
       "wsd_default": ref_schedule.wsd_schedule}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_equal_reference(name):
    args, kw = SCHEDULES[name]
    total = max(args[-1] if len(args) > 1 else 10, 1)
    mine, ref = PORT[name](*args, **kw), REF[name](*args, **kw)
    got = np.array([float(mine(s)) for s in range(2 * total + 1)])
    want = np.asarray(jax.vmap(ref)(jnp.arange(2 * total + 1)))
    np.testing.assert_allclose(got, want, atol=1e-6 * args[0], rtol=1e-6)
    # a Python int step, as the launcher's AdamW passes it
    np.testing.assert_allclose(float(mine(3)), float(ref(3)), rtol=1e-6)
    assert mine(3).dtype == torch.float32


def test_cosine_schedule_endpoints():
    sched = linear_warmup_cosine(1e-3, warmup_steps=10, total_steps=100,
                                 final_frac=0.1)
    assert float(sched(0)) < 1e-4 + 1e-9
    np.testing.assert_allclose(float(sched(10)), 1e-3, rtol=1e-5)
    np.testing.assert_allclose(float(sched(100)), 1e-4, rtol=1e-5)
    vals = [float(sched(s)) for s in range(10, 101, 10)]
    assert all(a >= b - 1e-12 for a, b in zip(vals, vals[1:]))


def test_wsd_schedule_phases():
    sched = wsd_schedule(1e-3, warmup_steps=10, total_steps=100,
                         decay_frac=0.2)
    np.testing.assert_allclose(float(sched(50)), 1e-3, rtol=1e-6)
    assert float(sched(5)) < 1e-3
    assert float(sched(95)) < 1e-3
    np.testing.assert_allclose(float(sched(100)), 0.0, atol=1e-9)


# ------------------------------------------------------------- sgd, clipping


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("scheduled", [False, True])
def test_sgd_equals_reference(momentum, scheduled):
    rng = np.random.default_rng(11)
    shapes = {"w": (4, 3), "b": (3,)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    lr = (linear_warmup_cosine(0.1, 2, 6), ref_schedule.linear_warmup_cosine(
        0.1, 2, 6)) if scheduled else (0.05, 0.05)
    init, update = sgd(lr[0], momentum=momentum)
    r_init, r_update = ref_sgd(lr[1], momentum=momentum)
    tp, rp = {k: t(v) for k, v in p.items()}, dict(p)
    ts, rs = init(tp), r_init(rp)
    for _ in range(6):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        tu, ts = update({k: t(v) for k, v in g.items()}, ts, tp)
        ru, rs = r_update(g, rs, rp)
        tp, rp = apply_updates(tp, tu), ref_apply_updates(rp, ru)
        for k in shapes:
            close(tu[k], ru[k], 1e-6)
            if momentum:
                close(ts["mom"][k], rs["mom"][k], 1e-6)
    assert ts["step"] == int(rs["step"]) == 6
    for k in shapes:
        close(tp[k], rp[k], 1e-6)


def test_sgd_converges_on_quadratic():
    init, update = sgd(0.1, momentum=0.5)
    p = {"x": torch.tensor([5.0, -3.0])}
    state = init(p)
    for _ in range(100):
        u, state = update({"x": 2 * p["x"]}, state, p)
        p = apply_updates(p, u)
    assert float(p["x"].abs().max()) < 1e-2


def test_adamw_mask_by_name_equals_dict_mask():
    rng = np.random.default_rng(2)
    p = {"a.0.w": t(rng.normal(size=(3,)).astype(np.float32)),
         "b": t(rng.normal(size=(2, 2)).astype(np.float32))}
    g = {k: torch.ones_like(v) for k, v in p.items()}
    by_dict = adamw(1e-2, mask={"a.0.w": True, "b": False})
    by_name = adamw(1e-2, mask=lambda k, v: k.startswith("a"))
    u1, _ = by_dict[1](g, by_dict[0](p), p)
    u2, _ = by_name[1](g, by_name[0](p), p)
    for k in p:
        assert torch.equal(u1[k], u2[k])
    assert not torch.equal(u1["b"], adamw(1e-2)[1](g, adamw(1e-2)[0](p),
                                                    p)[0]["b"])


def test_clip_by_global_norm_as_reference():
    g = {"a": torch.tensor([3.0, 0.0]), "b": torch.tensor([0.0, 4.0])}
    clipped, norm = clip_by_global_norm(g, 1.0)
    np.testing.assert_allclose(float(norm), 5.0, rtol=1e-6)
    total = torch.sqrt(sum((x ** 2).sum() for x in clipped.values()))
    np.testing.assert_allclose(float(total), 1.0, rtol=1e-5)
    same, _ = clip_by_global_norm(g, 10.0)
    assert torch.equal(same["a"], g["a"])
    rng = np.random.default_rng(4)
    arrs = {k: rng.normal(size=(17,)).astype(np.float32) * 3 for k in "xyz"}
    for limit in (0.5, 100.0):
        got, gn = clip_by_global_norm({k: t(v) for k, v in arrs.items()},
                                      limit)
        want, rn = ref_clip(arrs, limit)
        close(gn, rn, 1e-6)
        for k in arrs:
            close(got[k], want[k], 1e-6)


# ------------------------------------------------------------- compression


@pytest.mark.parametrize("scale,n", [(1e-3, 1), (0.37, 17), (1.0, 64),
                                     (42.0, 255), (1e3, 256)])
def test_int8_roundtrip_error_bound_and_reference(scale, n):
    x = (scale * np.random.default_rng(n).standard_normal(n)).astype(
        np.float32)
    q, s = compress_int8(t(x))
    err = (decompress_int8(q, s) - t(x)).abs()
    assert float(err.max()) <= float(s) * 0.5 + 1e-9
    assert q.dtype == torch.int8
    rq, rs = ref_compression.compress_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert float(s) == float(rs)


def test_int8_rounds_half_to_even_as_reference():
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 127.0], np.float32)
    q, _ = compress_int8(t(x))
    rq, _ = ref_compression.compress_int8(jnp.asarray(x))
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert q.tolist() == [0, 2, 2, 0, -2, 127]


def test_error_feedback_invariant_and_reference():
    rng = np.random.default_rng(0)
    g = {"w": rng.standard_normal(64).astype(np.float32),
         "b": (rng.standard_normal(8) * 10).astype(np.float32)}
    res = init_error_feedback({k: t(v) for k, v in g.items()})
    comp, res2 = error_feedback_compress({k: t(v) for k, v in g.items()},
                                         res)
    deq = decompress_tree(comp)
    for k in g:
        close(deq[k] + res2[k], t(g[k]) + res[k], 1e-5)
    rcomp, rres = ref_compression.error_feedback_compress(
        g, ref_compression.init_error_feedback(g))
    rdeq = ref_compression.decompress_tree(rcomp)
    for k in g:
        assert np.array_equal(comp[k][0].numpy(), np.asarray(rcomp[k][0]))
        close(res2[k], rres[k], 1e-7)
        close(deq[k], rdeq[k], 1e-7)


def test_error_feedback_unbiased_over_steps():
    rng = np.random.default_rng(2)
    g_true = [t(0.01 * rng.standard_normal(128).astype(np.float32))
              for _ in range(50)]
    res = init_error_feedback({"w": g_true[0]})
    acc_deq = torch.zeros(128, dtype=torch.float64)
    acc_true = torch.zeros(128, dtype=torch.float64)
    for g in g_true:
        comp, res = error_feedback_compress({"w": g}, res)
        acc_deq += decompress_tree(comp)["w"].double()
        acc_true += g.double()
    gap = (acc_deq + res["w"].double() - acc_true).abs().max()
    assert float(gap) < 1e-4


# ------------------------------------------------------------- data


@pytest.mark.parametrize("seed", [0, 9, 42])
@pytest.mark.parametrize("kw", [dict(vocab=100, seq_len=32, global_batch=4),
                                dict(vocab=64, seq_len=16, global_batch=2,
                                     mean_doc_len=8, zipf_a=1.5),
                                dict(vocab=151936, seq_len=64,
                                     global_batch=3)])
def test_pipeline_bytes_equal_reference(seed, kw):
    mine = TokenPipeline(DataConfig(seed=seed, **kw))
    ref = RefTokenPipeline(RefDataConfig(seed=seed, **kw))
    for step in (0, 1, 7, 123):
        a, b = mine.batch(step), ref.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].tobytes() == \
                b[k].tobytes()


def test_file_pipeline_bytes_equal_reference(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(1).integers(0, 500, 4096).astype(np.int32)\
        .tofile(path)
    kw = dict(vocab=500, seq_len=32, global_batch=4, seed=5,
              token_file=str(path))
    mine, ref = TokenPipeline(DataConfig(**kw)), RefTokenPipeline(
        RefDataConfig(**kw))
    for step in (0, 3, 11):
        a, b = mine.batch(step), ref.batch(step)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes()


@pytest.mark.parametrize("family", ["vlm", "audio", "dense"])
def test_extra_inputs_bytes_equal_reference(family):
    rcfg = TINY_CFGS[family]
    data = TokenPipeline(DataConfig(vocab=rcfg.vocab, seq_len=16,
                                    global_batch=2, seed=7))
    for step in range(3):
        b = data.batch(step)
        a, r = extra_inputs(port_cfg(rcfg), b), ref_extra_inputs(rcfg, b)
        assert a.keys() == r.keys()
        for k in a:
            assert a[k].tobytes() == np.asarray(r[k]).tobytes()
    e = extra_inputs(port_cfg(TINY_CFGS["vlm"]),
                     {"tokens": np.ones((2, 8), np.int32)})
    assert e["patches"].shape == (2, TINY_CFGS["vlm"].n_vision_patches,
                                  TINY_CFGS["vlm"].d_model)


def test_pipeline_contract():
    cfg = DataConfig(vocab=100, seq_len=32, global_batch=4, seed=42)
    p1, p2 = TokenPipeline(cfg), TokenPipeline(cfg)
    for step in (0, 7, 123):
        assert np.array_equal(p1.batch(step)["tokens"],
                              p2.batch(step)["tokens"])
    assert not np.array_equal(p1.batch(0)["tokens"], p1.batch(1)["tokens"])
    b = TokenPipeline(DataConfig(vocab=100, seq_len=32,
                                 global_batch=2)).batch(0)
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    b = TokenPipeline(DataConfig(vocab=50, seq_len=64,
                                 global_batch=4)).batch(3)
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 50
    assert b["tokens"].dtype == np.int32
    cfg = DataConfig(vocab=70, seq_len=16, global_batch=2, seed=9)
    run = [TokenPipeline(cfg).batch(s)["tokens"] for s in range(5)]
    resumed = TokenPipeline(cfg)
    assert np.array_equal(resumed.batch(3)["tokens"], run[3])
    assert np.array_equal(resumed.batch(4)["tokens"], run[4])


# ------------------------------------------------------------- checkpoint


def small_state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(8, 4, generator=g),
            "nested": {"b": torch.arange(5.0),
                       "step": torch.tensor(3, dtype=torch.int32)}}


def tree_equal(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(tree_equal(a[k], b[k])
                                            for k in a)
    return a.dtype == b.dtype and torch.equal(a, b)


def zeros_like(tree):
    if isinstance(tree, dict):
        return {k: zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path)
    state = small_state()
    mgr.save(7, state, blocking=True)
    restored, manifest = mgr.restore(zeros_like(state))
    assert manifest["step"] == 7
    assert tree_equal(restored, state)
    assert manifest["leaves"]["nested/step"] == {"shape": [],
                                                 "dtype": "int32"}
    assert (tmp_path / "step_7" / "nested__b.npy").exists()


def test_async_save_then_wait(tmp_path):
    mgr = CheckpointManager(tmp_path)
    state = small_state()
    mgr.save(1, state)
    state["w"].add_(1.0)        # the host copy was taken at save()
    mgr.wait()
    assert mgr.latest_step() == 1
    restored, _ = mgr.restore(zeros_like(state))
    assert tree_equal(restored, small_state())


def test_async_error_surfaces_at_wait(tmp_path, monkeypatch):
    def refuse(*a, **k):
        raise OSError("disk full")

    mgr = CheckpointManager(tmp_path)
    monkeypatch.setattr(manager.np, "save", refuse)
    mgr.save(1, small_state())          # returns; the writer fails
    with pytest.raises(OSError, match="disk full"):
        mgr.wait()
    mgr.wait()                          # raised once
    assert mgr.steps() == []


def test_no_tmp_dirs_after_commit(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, small_state(), blocking=True)
    assert not list(tmp_path.glob("*.tmp"))
    assert (tmp_path / "step_1" / "manifest.json").exists()


def test_gc_keeps_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, small_state(), blocking=True)
    assert mgr.steps() == [3, 4]
    assert CheckpointManager(tmp_path / "d").keep == 3


def test_restore_specific_step(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=5)
    s1, s2 = small_state(1), small_state(2)
    mgr.save(1, s1, blocking=True)
    mgr.save(2, s2, blocking=True)
    r1, _ = mgr.restore(zeros_like(s1), step=1)
    assert tree_equal(r1, s1) and not tree_equal(r1, s2)


def test_restore_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"w": torch.zeros(4)}, blocking=True)
    (tmp_path / "step_1" / "w.npy").unlink()
    np.save(tmp_path / "step_1" / "w.npy", np.zeros((5,)))
    with pytest.raises(ValueError, match="shape mismatch"):
        mgr.restore({"w": torch.zeros(4)})


def test_restore_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path).restore({"w": torch.zeros(2)})


def test_restore_onto_a_mesh_is_refused_by_name(tmp_path):
    """A sharding whose mesh axes do not divide a leaf is refused, naming
    the dim and the axes."""
    save_checkpoint(tmp_path, 1, {"w": torch.zeros(2)})
    mesh = make_mesh((4,), ("data",), devices=["cpu"] * 4)
    with pytest.raises(ValueError, match=r"dim 0 of size 2 .*'data'"):
        restore_checkpoint(tmp_path, {"w": torch.zeros(2)},
                           shardings={"w": NamedSharding(mesh, ("data",))})


def test_restore_re_shards_onto_a_mesh(tmp_path):
    """A one-device checkpoint restored by ``NamedSharding``s: each leaf
    comes back a ``ShardedArray`` on the mesh, bitwise the saved values;
    a ``None`` sharding leaves its leaf as ``like`` has it."""
    w = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    save_checkpoint(tmp_path, 1, {"w": w, "b": torch.ones(3), "step": 1})
    mesh = make_mesh((2, 2), ("data", "model"), devices=["cpu"] * 4)
    got, _ = restore_checkpoint(
        tmp_path, {"w": ShapeDtypeStruct((4, 6), torch.float32),
                   "b": torch.zeros(3), "step": 0},
        shardings={"w": NamedSharding(mesh, ("data", "model")), "b": None,
                   "step": None})
    assert isinstance(got["w"], ShardedArray)
    assert got["w"].spec == ("data", "model")
    assert torch.equal(got["w"].blocks[(1, 0)], w[2:, :3])
    assert torch.equal(got["w"].full(), w)
    assert torch.equal(got["b"], torch.ones(3)) and got["step"] == 1


def test_bfloat16_numbers_and_modules_round_trip(tmp_path):
    model = LM(port_cfg(TINY_CFGS["moe"], dtype="bfloat16"), device="cpu")
    state = {"model": model, "half": torch.randn(3, 2).to(torch.bfloat16),
             "step": 12, "lr": 0.5, "pair": (torch.ones(2), 3)}
    save_checkpoint(tmp_path, 12, state, meta={"arch": "tiny-moe"})
    manifest = json.loads((tmp_path / "step_12" / "manifest.json")
                          .read_text())
    assert manifest["leaves"]["half"]["dtype"] == "bfloat16"
    assert manifest["meta"] == {"arch": "tiny-moe"}
    assert np.load(tmp_path / "step_12" / "half.npy").dtype == np.float32
    like = {"model": LM(port_cfg(TINY_CFGS["moe"], dtype="bfloat16"),
                        device="cpu", seed=1),
            "half": torch.zeros(3, 2, dtype=torch.bfloat16), "step": 0,
            "lr": 0.0, "pair": (torch.zeros(2), 0)}
    target = like["model"]
    got, _ = restore_checkpoint(tmp_path, like)
    assert got["model"] is target
    for (k, p), q in zip(model.named_parameters(), target.parameters()):
        assert torch.equal(p, q), k
    # the restored model's compute-dtype copies are refreshed
    assert torch.equal(target.blocks[0].moe.gate_c,
                       model.blocks[0].moe.gate.to(torch.bfloat16))
    assert got["half"].dtype == torch.bfloat16
    assert torch.equal(got["half"], state["half"])
    assert got["step"] == 12 and got["lr"] == 0.5
    assert isinstance(got["pair"], tuple) and got["pair"][1] == 3


# ------------------------------------------------------------- launcher

ARGS = ["--arch", "qwen2.5-3b", "--smoke", "--seq", "32", "--batch", "2",
        "--device", "cpu"]


def read_log(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def ckpt_files(d):
    return {f.name: np.load(f) for f in sorted(d.glob("*.npy"))}


def test_launcher_checkpoints_and_resumes_bitwise(tmp_path):
    ck, straight = tmp_path / "ck", tmp_path / "straight"
    assert launcher.main(ARGS + ["--steps", "6", "--ckpt-dir", str(ck),
                                 "--ckpt-every", "3", "--log",
                                 str(tmp_path / "a.jsonl")]) == 0
    assert CheckpointManager(ck).steps() == [3, 6]
    assert CheckpointManager(ck).latest_step() == 6
    assert launcher.main(ARGS + ["--steps", "9", "--ckpt-dir", str(ck),
                                 "--resume", "--log",
                                 str(tmp_path / "b.jsonl")]) == 0
    recs = read_log(tmp_path / "b.jsonl")
    assert recs[-1]["step"] == 9
    assert all(np.isfinite(r["loss"]) for r in recs)
    assert launcher.main(ARGS + ["--steps", "9", "--ckpt-dir", str(straight),
                                 "--log", str(tmp_path / "c.jsonl")]) == 0
    whole = read_log(tmp_path / "c.jsonl")
    assert [r["step"] for r in whole] == [1, 9]
    drop = lambda r: {k: v for k, v in r.items() if k != "sec"}
    assert drop(whole[-1]) == drop(recs[-1])
    assert [r["step"] for r in read_log(tmp_path / "a.jsonl")] == [1, 6]
    assert drop(read_log(tmp_path / "a.jsonl")[0]) == drop(whole[0])
    a, b = ckpt_files(ck / "step_9"), ckpt_files(straight / "step_9")
    assert a.keys() == b.keys() and len(a) > 0
    for k in a:
        assert a[k].tobytes() == b[k].tobytes(), k
    manifest = json.loads((ck / "step_9" / "manifest.json").read_text())
    assert manifest["step"] == 9
    assert manifest["leaves"]["step"]["shape"] == []


def test_launcher_takes_a_final_checkpoint_on_sigterm(tmp_path, monkeypatch):
    build = launcher.make_train_step

    def interrupted(cfg, **kw):
        step, opt = build(cfg, **kw)

        def one(state, batch):
            out = step(state, batch)
            if out[0].step == 4:
                os.kill(os.getpid(), signal.SIGTERM)
            return out
        return one, opt

    monkeypatch.setattr(launcher, "make_train_step", interrupted)
    before = signal.getsignal(signal.SIGTERM)
    state = launcher.train(launcher.parse_args(
        ARGS + ["--steps", "9", "--ckpt-dir", str(tmp_path)]))
    assert state.step == 4
    assert CheckpointManager(tmp_path).steps() == [4]
    assert signal.getsignal(signal.SIGTERM) is before


def test_launcher_refuses_a_mesh_by_name():
    """``--mesh`` trains every family: the Mamba model that was refused on
    (2, 4), naming its family, now trains there.  A mesh of three sizes
    is refused, naming the two axes (data, model) the launcher lays
    out."""
    assert launcher.main(["--arch", "falcon-mamba-7b", "--smoke", "--device",
                          "cpu", "--steps", "1", "--mesh", "2,4",
                          "--seq", "16", "--batch", "2"]) == 0
    with pytest.raises(ValueError, match=r"axes \('data', 'model'\)"):
        launcher.main(["--arch", "falcon-mamba-7b", "--smoke", "--device",
                       "cpu", "--steps", "1", "--mesh", "2,2,2",
                       "--seq", "16", "--batch", "2"])


def test_training_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: cuda is a valid default here")
    cfg = port_cfg(TINY_CFGS["dense"])
    with pytest.raises(RuntimeError, match="cuda"):
        launcher.main(["--arch", "qwen2.5-3b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        init_train_state(0, cfg, make_train_step(cfg)[1][0])


@pytest.mark.parametrize("family", list(TINY_CFGS))
@pytest.mark.parametrize("with_labels", [False, True])
def test_model_inputs_equal_reference(family, with_labels):
    import repro.models.steps as ref_steps
    rcfg = TINY_CFGS[family]
    for seq in (1, 16):
        got = model_inputs(port_cfg(rcfg), 2, seq, with_labels=with_labels)
        want = ref_steps.model_inputs(rcfg, 2, seq, with_labels=with_labels)
        assert got.keys() == want.keys()
        for k, (shape, dtype) in want.items():
            assert got[k][0] == shape
            assert str(got[k][1]).removeprefix("torch.") == \
                np.dtype(dtype).name
