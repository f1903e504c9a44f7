"""Training over a ("data", "model") mesh for the families beyond the dense
and MoE ones: Mamba1 (falcon-mamba-7b), the hybrid (zamba2-2.7b: Mamba2
towers and shared attention), the VLM (qwen2-vl-7b: M-RoPE and a patch
prefix) and the encoder-decoder (seamless-m4t-medium: cross attention), on
the CPU, in float32 at smoke configs.

* A subprocess with 8 host devices a config runs the reference's own mesh
  step on an Auto-typed (2, 4) mesh (``tests/test_torch_train_mesh.py``'s
  script), batches of 4 x 8 tokens.  Over 3 steps from the weights the
  bridge carries across, every
  metric is within 1e-5 relative, and every leaf of the parameters, ``mu``
  and ``nu`` within 1e-5 x max(1, max |leaf|).  On (2, 4) the fused
  ``in_proj`` columns (and Mamba2's conv channels) lie over "model" in
  blocks that do not line up with the channels a rank scans, so a
  partition that took a rank's block for its channels would part here.
  The parameters' elements whose first-step gradient is rounding-sized
  (under 1e-6) are held to AdamW's first-step bound instead
  (``assert_params_close``).
* The port's mesh step against its one-device step over 2 steps on (2,
  2), (1, 4) and (4, 1), same tolerances (the parameters too: at 8
  tokens a row, a hybrid ``ln.scale`` element's first-step gradient is
  rounding-sized); and the layouts the smoke configs do not reach:
  Mamba2 with 2 and 4 B/C groups (a rank's heads within one group, and
  spanning two), and meshes whose "model" axis divides neither the
  channels nor the heads (each position runs the whole block).
* Each position's scan runs on d_inner/m channels (Mamba1) or H/m heads
  (Mamba2), seen by wrapping the scan functions.
* The replicated Mamba2 leaves (``A_log``, ``dt_bias``, ``D``), each rank
  reading its heads' slice, take the one-device gradient: the step's psum
  over the axes they are replicated on sums the ranks' slices, once.
* The collectives ``CostCounter`` records for one (2, 2) step of falcon
  and of zamba2 are what the layout implies.
* Elastic: a zamba2 state restored from (2, 2) onto (1, 4) is bitwise the
  saved one, and 2 more steps equal the straight run.

The launcher's ``--mesh`` over these families is tested in
``tests/test_torch_train_mesh.py``.
"""
import collections
import dataclasses
import functools
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ref as kref
from repro_torch.launch.cost import CostCounter
from repro_torch.launch.elastic import ReMesh, elastic_restore
from repro_torch.models import mamba, steps
from repro_torch.models.bridge import from_reference, to_reference
from repro_torch.sharding import TRAIN_RULES, shard_ctx

from repro_torch.data import DataConfig, TokenPipeline, extra_inputs

from test_torch_train_mesh import (
    B, STEPS, SUB, TOL, _flat, assert_leaves_close, assert_metrics_close,
    cpu_mesh, mesh_state, run, state_leaves,
)

REPO = Path(__file__).resolve().parents[1]
FAMILIES = {"ssm": "falcon-mamba-7b", "hybrid": "zamba2-2.7b",
            "vlm": "qwen2-vl-7b", "encdec": "seamless-m4t-medium"}
# tokens a row, here and in the reference's run: the Mamba train scans are
# per-token loops, run once a position (the VLM's 4 patch rows fit)
S = 8


def port_batches(cfg, n=STEPS, batch=B, seq=S):
    data = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                    global_batch=batch, seed=3))
    return [{k: torch.from_numpy(v) for k, v in
             extra_inputs(cfg, data.batch(i)).items()} for i in range(n)]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------- the reference's mesh step

@pytest.fixture(scope="module")
def reference_steps():
    """One subprocess a family, all started when the module's first test
    asks for them; the port-only tests run while they work."""
    tmp = tempfile.mkdtemp(prefix="train-mesh-families-")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    procs = {}
    for name, arch in FAMILIES.items():
        code = (f"C = {arch!r}\nSEQ = {S}\nBATCH = {B}\nSTEPS = {STEPS}\n"
                + SUB)
        path = os.path.join(tmp, f"{name}.npz")
        procs[name] = (path, subprocess.Popen(
            [sys.executable, "-c", code, path], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))

    def result(name):
        path, proc = procs[name]
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        z = np.load(path)
        tree: dict = {}
        for k in z.files:
            node = tree
            *head, last = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = z[k]
        return tree
    yield functools.lru_cache(maxsize=None)(result)
    for _, proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module", autouse=True)
def start_reference_steps(reference_steps):
    yield


# steps of the port-only comparisons (the reference's run takes STEPS)
PORT_STEPS = 2


def one_device(cfg, n):
    """A seeded state stepped over ``n`` batches on one device → (state,
    metrics, the batches)."""
    step, (opt_init, _) = steps.make_train_step(cfg)
    batches = port_batches(cfg, n=n)
    state, metrics = run(step, steps.init_train_state(0, cfg, opt_init,
                                                      device="cpu"), batches)
    return state, metrics, batches


@functools.lru_cache(maxsize=None)
def one_device_run(arch):
    """``one_device`` of a family's smoke config and its first-step
    gradients (``first_gradients``), shared by its meshes."""
    cfg = get_smoke_config(arch)
    return one_device(cfg, PORT_STEPS), first_gradients(one_device(cfg,
                                                                   1)[0])


def on_mesh(cfg, shape, batches):
    """The same seeded state stepped over ``batches`` on ``shape`` →
    (state, metrics)."""
    step, (opt_init, _) = steps.make_train_step(cfg)
    model = steps.init_train_state(0, cfg, opt_init, device="cpu").params
    mesh = cpu_mesh(shape)
    return run(step, mesh_state(cfg, mesh, model), batches, mesh)


def assert_states_close(a, b, g1):
    """Metrics aside, the tolerances above: ``mu`` and ``nu`` leaf by
    leaf, the parameters by ``assert_params_close`` against ``g1``, the
    first-step gradients."""
    sa, sb = state_leaves(a), state_leaves(b)
    for part in ("mu", "nu"):
        assert_leaves_close(sa[part], sb[part], f"{part}/")
    assert_params_close(sa["params"], sb["params"], g1)


LR, ADAM_B1 = 3e-4, 0.9         # make_train_step's default lr, AdamW's b1
ADAM_NOISE_G = 1e-6             # 100 x AdamW's eps: below, |g| is rounding


def first_gradients(state) -> dict:
    """{name: the clipped gradient AdamW took} of a one-device state after
    its first step: mu = (1 - b1) g from mu = 0."""
    return {k: v / (1 - ADAM_B1) for k, v in state.opt_state.mu.items()}


def assert_params_close(got: dict, want: dict, g1: dict):
    """Each parameter element within 1e-5 x max(1, max |leaf|), except
    where its first-step gradient is rounding-sized (under 1e-6): AdamW's
    first step moves such an element by lr x g / (|g| + 1e-8), so two sums
    of one near-zero gradient that round apart move it apart by a fraction
    of lr, and it is held to AdamW's bound, 2 lr (``chip_smoke.py`` phase
    13's rule)."""
    assert got.keys() == want.keys() == g1.keys()
    for k, w in want.items():
        w = torch.as_tensor(np.asarray(w))
        gap = (torch.as_tensor(np.asarray(got[k])) - w).abs()
        noisy = torch.as_tensor(np.asarray(g1[k])).abs() < ADAM_NOISE_G
        assert bool((gap[noisy] <= 2 * LR).all()), k
        scale = max(1.0, float(w.abs().max()))
        assert float(torch.where(noisy, 0.0, gap).max()) <= TOL * scale, k


# ------------------------------------------------- against one device

@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_mesh_step_matches_the_one_device_step(family, shape):
    (one, want, batches), g1 = one_device_run(FAMILIES[family])
    sharded, got = on_mesh(get_smoke_config(FAMILIES[family]), shape,
                           batches)
    assert_metrics_close(got, want)
    assert_states_close(sharded, one, g1)


def _zamba2(**ssm):
    cfg = get_smoke_config("zamba2-2.7b")
    return dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, **ssm))


# (config, mesh): 8 heads over 2 groups, 2 heads a rank (one group each);
# over 4 groups on (2, 2), 4 heads a rank spanning 2 groups; 8 heads, 64
# channels and 152 in_proj columns over 3 (nothing splits: the whole block
# on each position); falcon's 64 channels over 3
LAYOUTS = {"mamba2 G=2 (1, 4)": (lambda: _zamba2(n_groups=2), (1, 4)),
           "mamba2 G=4 (2, 2)": (lambda: _zamba2(n_groups=4), (2, 2)),
           "mamba2 unsplit (1, 3)": (lambda: _zamba2(), (1, 3)),
           "mamba1 unsplit (1, 3)": (
               lambda: get_smoke_config("falcon-mamba-7b"), (1, 3))}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mesh_step_matches_the_one_device_step_on_other_layouts(layout):
    """As ``test_mesh_step_matches_the_one_device_step``."""
    make, shape = LAYOUTS[layout]
    cfg = make()
    one, want, batches = one_device(cfg, PORT_STEPS)
    sharded, got = on_mesh(cfg, shape, batches)
    assert_metrics_close(got, want)
    assert_states_close(sharded, one, first_gradients(one_device(cfg,
                                                                 1)[0]))


# ------------------------------------------------- what each position runs

SCAN_CASES = [("falcon-mamba-7b", (2, 2)), ("falcon-mamba-7b", (1, 4)),
              ("zamba2-2.7b", (2, 2)), ("zamba2-2.7b", (1, 4))]


@pytest.mark.parametrize("arch,shape", SCAN_CASES)
def test_each_position_scans_its_own_channels_or_heads(arch, shape,
                                                        monkeypatch):
    cfg = get_smoke_config(arch)
    m = shape[1]
    calls = []

    def wrap(fn):
        def scan(x, *args, **kw):
            calls.append(tuple(x.shape))
            return fn(x, *args, **kw)
        return scan

    if cfg.ssm.version == 1:
        monkeypatch.setattr(mamba, "selective_scan_train",
                            wrap(mamba.selective_scan_train))
        want = (B // shape[0], S, cfg.d_inner // m)
    else:
        monkeypatch.setattr(kref, "ssm_scan_ref", wrap(kref.ssm_scan_ref))
        want = (B // shape[0], S, cfg.ssm_heads // m, cfg.ssm.headdim)
    step, (opt_init, _) = steps.make_train_step(cfg)
    mesh = cpu_mesh(shape)
    model = steps.init_train_state(0, cfg, opt_init, device="cpu").params
    run(step, mesh_state(cfg, mesh, model), port_batches(cfg, n=1), mesh)
    # under remat ("full", the configs' default) each layer's recompute
    # scans again
    again = cfg.remat != "none"
    assert calls == [want] * (cfg.n_layers * shape[0] * shape[1]
                              * (1 + again))


def test_replicated_ssm_leaves_take_the_summed_gradient():
    """zamba2 on (2, 4): ``A_log``, ``dt_bias`` and ``D`` are replicated
    and each rank reads its 2 heads of 8.  After one step mu = 0.1 x the
    clipped gradient; it equals the one-device one within 1e-5 of the
    leaf's own largest element (a missing psum would leave 1/4 of it, a
    second one 8 times it)."""
    cfg = get_smoke_config("zamba2-2.7b")
    one, _, batches = one_device(cfg, 1)
    sharded, _ = on_mesh(cfg, (2, 4), batches)
    names = [k for k in one.opt_state.mu
             if k.rsplit(".", 1)[-1] in ("A_log", "dt_bias", "D")]
    assert len(names) == 3 * cfg.n_layers
    for k in names:
        want = one.opt_state.mu[k]
        got = sharded.opt_state.mu[k].full()
        top = float(want.abs().max())
        assert top > 0, k
        assert float((got - want).abs().max()) <= TOL * top, k


def _collectives(arch, remat, seq):
    cfg = dataclasses.replace(get_smoke_config(arch), remat=remat)
    step, (opt_init, _) = steps.make_train_step(cfg)
    mesh = cpu_mesh((2, 2))
    model = steps.init_train_state(0, cfg, opt_init, device="cpu").params
    state = mesh_state(cfg, mesh, model)
    with CostCounter() as c, shard_ctx(TRAIN_RULES, mesh):
        step(state, port_batches(cfg, n=1, batch=2, seq=seq)[0])
    return cfg, c.collectives


# the collectives of the embedding and the loss, as on the dense family:
# the table's gather over "data" (and its reduce-scatter), the lookup's
# "model" psum (1 + 1 backward), the vocab-split CE's pmax and two psums
# (2 backward), the token mean's psum over "data" (1 backward), the final
# norm's gradient psum over both axes and the global norm's
EMBED_AND_LOSS = {("all-gather", 2): 1, ("reduce-scatter", 2): 1,
                  ("all-reduce", 2): 2 + 5 + 2, ("all-reduce", 4): 2}


def _plus(*counts):
    out = collections.Counter()
    for c in counts:
        out.update(c)
    return dict(out)


# a batch shard's rows (one row of ``seq`` tokens): under d_model (32)
# the fused in_proj moves each rank's product, from d_model on the weight
SEQS = (12, 48)


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("remat", ["none", "full"])
def test_collectives_of_one_falcon_step_follow_the_layout(remat, seq):
    """falcon-mamba-7b smoke (2 layers, d 32, d_inner 64, N 4, dt_rank 2)
    on (2, 2), batch 2 x ``seq``.  A layer: ``in_proj`` (data, model)
    gathered over "data", then over "model" either whole or, with fewer
    rows than d_model, as each rank's (1, seq, di) product (fewer bytes),
    and ``out_proj`` (model, data) over
    "data": 3 all-gathers and 3 reduce-scatters; the ``x_proj`` psum over
    "model" of the (1, seq, 10) partial products and the ``out_proj`` psum,
    each with its backward psum; the gradient psums over "data" of the
    leaves split over "model" alone (conv w and b, x_proj, dt_proj w and
    b, A_log, D: 7) and over both axes of the replicated ``ln``.  With
    ``remat="full"`` each layer's recompute runs its 3 gathers and its 2
    forward psums again."""
    cfg, recs = _collectives("falcon-mamba-7b", remat, seq)
    L, d, di = cfg.n_layers, cfg.d_model, cfg.d_inner
    R, N = cfg.dt_rank, cfg.ssm.d_state
    again = remat != "none"
    layer = {("all-gather", 2): 3 + again * 3, ("reduce-scatter", 2): 3,
             ("all-reduce", 2): 2 * 2 + 7 + again * 2,
             ("all-reduce", 4): 1}
    want = _plus(EMBED_AND_LOSS, *[layer] * L)
    assert dict(collections.Counter((k, n) for k, _, n in recs)) == want
    got = collections.Counter(recs)
    f32 = 4
    whole = seq >= d
    # in_proj over "model": whole (d, 2 di), and its reduce-scatter back to
    # the (d, di) block the "data" gather made; or the (1, seq, 2 di)
    # product, and its reduce-scatter to (1, seq, di)
    gathered, scattered = (d, seq)[::1 if whole else -1]
    assert got[("all-gather", gathered * 2 * di * f32, 2)] == L * (1 + again)
    assert got[("reduce-scatter", gathered * di * f32, 2)] == L
    assert got[("all-gather", scattered * 2 * di * f32, 2)] == 0
    # the x_proj psum, forward (and its recompute) and backward: (B_loc,
    # seq, R + 2N)
    assert got[("all-reduce", seq * (R + 2 * N) * f32, 2)] == (2 + again) * L


@pytest.mark.parametrize("seq", SEQS)
@pytest.mark.parametrize("remat", ["none", "full"])
def test_collectives_of_one_zamba2_step_follow_the_layout(remat, seq):
    """zamba2-2.7b smoke (4 Mamba2 layers in 2 groups, 2 shared blocks,
    d 32, d_inner 64, 8 heads, N 8) on (2, 2), batch 2 x ``seq``.  A
    Mamba2 layer: ``in_proj`` gathered over "data", then over "model"
    whole or, with fewer rows than d_model, as each rank's product, the
    conv's w and b whole (over "model"), ``out_proj`` over "data": 5
    all-gathers and 5 reduce-scatters; the gated norm's psum over "model"
    of each row's sum of squares and the ``out_proj`` psum, each with its
    backward; gradient psums over "data" of the conv's w and b and the
    norm's scale, over both axes of ``ln`` and of the replicated
    ``A_log``, ``dt_bias``, ``D``.  A shared block (used once by each
    group here): 7 weights gathered over "data", the attention's and the
    MLP's psums with their backward, its two norms' gradient psums over
    both axes.  A group's ``down``, split over "data" alone: one gather,
    one reduce-scatter, its gradient psummed over "model".  With
    ``remat="full"`` each group is one checkpoint: its recompute runs the
    group's gathers (its shared block's among them) and forward psums
    again."""
    cfg, recs = _collectives("zamba2-2.7b", remat, seq)
    A, d, di = cfg.n_layers, cfg.d_model, cfg.d_inner
    G = A // cfg.hybrid.attn_every
    again = remat != "none"
    mamba2 = {("all-gather", 2): 5 + again * 5, ("reduce-scatter", 2): 5,
              ("all-reduce", 2): 2 * 2 + 3 + again * 2,
              ("all-reduce", 4): 1 + 3}
    shared = {("all-gather", 2): 7 + again * 7, ("reduce-scatter", 2): 7,
              ("all-reduce", 2): 2 * 2 + again * 2, ("all-reduce", 4): 2}
    down = {("all-gather", 2): 1 + again, ("reduce-scatter", 2): 1,
            ("all-reduce", 2): 1}
    want = _plus(EMBED_AND_LOSS, *[mamba2] * A, *[shared] * G, *[down] * G)
    assert dict(collections.Counter((k, n) for k, _, n in recs)) == want
    got = collections.Counter(recs)
    f32 = 4
    cols = 2 * di + 2 * cfg.ssm.d_state + cfg.ssm_heads
    gathered, scattered = (d, seq)[::1 if seq >= d else -1]
    assert got[("all-gather", gathered * cols * f32, 2)] == A * (1 + again)
    assert got[("reduce-scatter", gathered * cols // 2 * f32, 2)] == A
    assert got[("all-gather", scattered * cols * f32, 2)] == 0
    # the norm's psum of (B_loc, seq, 1) and the CE's pmax and 4 psums of
    # (B_loc, seq): the same size
    assert got[("all-reduce", seq * f32, 2)] == (2 + again) * A + 5
    # the replicated (H,) leaves' gradient psums over both axes
    assert got[("all-reduce", cfg.ssm_heads * f32, 4)] == 3 * A


# ------------------------------------------------- elastic and the launcher

def test_elastic_restore_of_a_zamba2_state(tmp_path):
    cfg = get_smoke_config("zamba2-2.7b")
    step, _ = steps.make_train_step(cfg)
    batches = port_batches(cfg, n=4)
    mesh = cpu_mesh((2, 2))
    state, _ = on_mesh(cfg, (2, 2), batches[:2])
    CheckpointManager(tmp_path).save(2, state, blocking=True)
    restored, step2, mesh2 = elastic_restore(
        str(tmp_path), cfg, ReMesh(data_axis=1, model_axis=4),
        devices=["cpu"] * 4)
    assert dict(mesh2.shape) == {"data": 1, "model": 4}
    assert restored.step == 2
    saved, back = state_leaves(state), state_leaves(restored)
    for part in saved:
        for k in saved[part]:
            assert torch.equal(back[part][k], saved[part][k]), (part, k)
    # (d, 152) in_proj: 38 columns a rank on (1, 4)
    blk = restored.params["blocks.0.0.mamba.in_proj.w"]
    assert blk.spec == ("data", "model") and blk.blocks[(0, 3)].shape == (
        cfg.d_model, blk.shape[1] // 4)
    _, got = run(step2, restored, batches[2:])
    # the straight run: the saved state stepped on where it was
    straight, want = run(step, state, batches[2:], mesh)
    assert_metrics_close(got, want)
    for part, leaves in state_leaves(restored).items():
        assert_leaves_close(leaves, state_leaves(straight)[part], part)


# ------------------------------------------------- the reference, read last
# (the port-only tests above run while its subprocesses work)

@pytest.mark.parametrize("family", list(FAMILIES))
def test_mesh_step_matches_the_reference_mesh_step(reference_steps, family):
    ref = reference_steps(family)
    cfg = get_smoke_config(FAMILIES[family])
    mesh = cpu_mesh((2, 4))
    model = from_reference(ref["params0"], cfg, device="cpu")
    step, _ = steps.make_train_step(cfg)
    batches = [{k: torch.from_numpy(v) for k, v in ref[f"batch{i}"].items()}
               for i in range(STEPS)]
    state, got = run(step, mesh_state(cfg, mesh, model), batches, mesh)
    want = [{k: float(v) for k, v in ref[f"metrics{i}"].items()}
            for i in range(STEPS)]
    assert_metrics_close(got, want)
    leaves = state_leaves(state)
    for part in ("mu", "nu"):
        assert_leaves_close(_flat(to_reference(leaves[part], cfg)),
                            _flat(ref[part]), f"{part}")
    # the rounding-sized first-step gradients, from the port's one-device
    # step on the same weights and batch (hybrid: one element of a Mamba2
    # in_proj's dt columns, g ~ -3e-9, where the port's one-device step
    # parts from the reference's mesh step by 3.6e-5 after its first step)
    _, (opt_init, _) = steps.make_train_step(cfg)
    one = from_reference(ref["params0"], cfg, device="cpu")
    first, _ = run(step, steps.TrainState(
        one, opt_init(dict(one.named_parameters())), 0), batches[:1])
    assert_params_close(_flat(to_reference(leaves["params"], cfg)),
                        _flat(ref["params"]),
                        _flat(to_reference(first_gradients(first), cfg)))
