"""The port's cost counter (``repro_torch.launch.cost``) and dry-run
(``repro_torch.launch.dryrun``) on the CPU, against closed forms and the
JAX reference's compiled cost.

The counter's unit cases are exact: a Linear counts 2·M·N·K, bmm, the
elementwise ops, reductions and transcendentals follow the stated rules,
views move no byte, and each kernel region (K1's write instance, K4 causal
and windowed, K7, K3 greedy and sampled) records its module's ``cost(...)``
and hides the plain version's ops.  A serve step's matmul-class FLOPs
equal a closed form from the config exactly (dense, windowed and hybrid
smoke configs, prefill and decode).

Its total FLOPs are held against the reference's ``cost_summary`` of the
same step (``make_decode_step``/``make_prefill_step`` jitted with
``use_scan=False``, ``use_pallas=False``, on the same shapes).  Two op
classes count differently, and the comparison adds each back first:
XLA's plain attention multiplies every (query, key) pair, masked or not,
where the kernel regions count the visible ones (4·H·hd a pair); and XLA
counts a ``lax.scan`` body once, so the reference's SSD recurrence over a
prompt needs its own correction (``repro.sim.roofline_db.ssm_scan_flops``).
With both the totals agree within REF_TOL = 8%: the rest is the elementwise work of
XLA's masking and softmax over the masked pairs, and mask building.
Without them the totals differ by up to 20% at these widths (danube's
window of 8 masks 78% of the pairs).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.launch.hlo_cost import cost_summary as ref_cost_summary
from repro.models import LM as RefLM
from repro.models.steps import make_decode_step as ref_decode_step
from repro.models.steps import make_prefill_step as ref_prefill_step
from repro.sim.roofline_db import ssm_scan_flops as ref_ssm_scan_flops

from repro_torch.configs import get_smoke_config
from repro_torch.kernels import decode_attention, flash_attention, ops
from repro_torch.kernels import sample, ssm_scan
from repro_torch.launch import dryrun
from repro_torch.launch.cost import CostCounter, cost_summary
from repro_torch.models import ShapeCfg
from repro_torch.nn import Linear

REF_TOL = 0.08
MATMULS = ("aten.mm", "aten.addmm", "aten.bmm", "aten.baddbmm",
           "aten.convolution")
ARCHS = ["qwen2.5-3b", "h2o-danube-1.8b", "zamba2-2.7b"]
B, S = 2, 32
# one card's share of a (B·16)-row cell at S tokens
SHAPES = {"prefill": ShapeCfg("prefill_32k", S, 16 * B, "prefill"),
          "decode": ShapeCfg("decode_32k", S, 16 * B, "decode")}


def count(fn, *args, **kw):
    with CostCounter() as c:
        out = fn(*args, **kw)
    return c, out


def randn(*shape, seed=0, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g).to(dtype)


# --------------------------------------------------------------- unit cases


@pytest.mark.parametrize("lead", [(5,), (3, 5)])
def test_linear_counts_2mnk(lead):
    M, K, N = int(np.prod(lead)), 7, 11
    lin = Linear(K, N, dtype=torch.float32, use_bias=False)
    x = randn(*lead, K)
    c, _ = count(lin, x)
    assert c.flops == 2 * M * N * K
    assert c.bytes == 4 * (M * K + K * N + M * N)
    assert c.transcendentals == 0


def test_bmm_elementwise_reduction_transcendental_rules():
    a, b = randn(3, 4, 5), randn(3, 5, 6, seed=1)
    c, _ = count(torch.bmm, a, b)
    assert (c.flops, c.bytes) == (2 * 3 * 4 * 5 * 6, 4 * (60 + 90 + 72))
    x, y = randn(4, 6), randn(4, 6, seed=1)
    for fn, flops, trans in [
            (lambda: x + y, 24, 0), (lambda: x * y, 24, 0),
            (lambda: torch.where(x > 0, x, y), 48, 0),   # compare, select
            (lambda: x.sum(-1), 24, 0), (lambda: x.amax(), 24, 0),
            (lambda: x.exp(), 0, 24), (lambda: torch.rsqrt(x.abs()), 24, 24),
            (lambda: x.tanh(), 0, 24), (lambda: torch.sigmoid(x), 0, 24),
            (lambda: torch.nn.functional.silu(x), 24, 24),
            (lambda: torch.softmax(x, -1), 96, 24),
            (lambda: x.square(), 24, 0),
            (lambda: x.to(torch.bfloat16), 24, 0),
            (lambda: x.clone(), 0, 0)]:
        c, _ = count(fn)
        assert (c.flops, c.transcendentals) == (flops, trans), c.by_op


def test_views_move_no_bytes_and_broadcasts_count_once():
    x = randn(4, 6)
    c, _ = count(lambda: (x.view(24), x.reshape(6, 4), x.t(), x[1:3],
                          x.transpose(0, 1), x[:, None].expand(4, 3, 6),
                          x.as_strided((2, 2), (6, 1))))
    assert (c.flops, c.bytes, dict(c.by_op)) == (0, 0, {})
    b = randn(6, seed=1)
    c, _ = count(lambda: x + b)            # b broadcast over 4 rows
    assert c.bytes == 4 * (24 + 6 + 24)
    c, _ = count(lambda: x + b.expand(4, 6))
    assert c.bytes == 4 * (24 + 6 + 24)


def test_in_place_ops_count_read_and_write():
    x, y = randn(4, 6), randn(4, 6, seed=1)
    c, _ = count(x.add_, y)                # reads x and y, writes x
    assert (c.flops, c.bytes) == (24, 4 * 3 * 24)
    c, _ = count(x.copy_, y)               # reads y, writes x
    assert (c.flops, c.bytes) == (0, 4 * 2 * 24)
    c, _ = count(x.zero_)
    assert (c.flops, c.bytes) == (0, 4 * 24)


def _qkv(B_, Sq, Sk, H, KV, hd, seed=0):
    return (randn(B_, Sq, H, hd, seed=seed), randn(B_, Sk, KV, hd, seed=1),
            randn(B_, Sk, KV, hd, seed=2))


@pytest.mark.parametrize("window", [None, 5])
def test_flash_attention_region(window):
    q, k, v = _qkv(2, 13, 13, 4, 2, 8)
    c, out = count(ops.flash_attention, q, k, v, causal=True, window=window)
    torch.testing.assert_close(out, ops.flash_attention(q, k, v, causal=True,
                                                        window=window))
    pairs = sum(min(i + 1, window or 99) for i in range(13))
    want = flash_attention.cost(2, 13, 13, 4, 2, 8, window=window,
                                itemsize=4)
    assert want == (4 * 2 * pairs * 4 * 8, 2 * 4 * (2 * 13 * 32 + 2 * 13 * 16),
                    2 * pairs * 4)
    assert (c.flops, c.bytes, c.transcendentals) == want
    assert set(c.by_op) == {"kernel:flash_attention"}
    assert c.kernels["flash_attention"]["calls"] == 1


def test_decode_attention_write_region():
    B_, Smax, H, KV, hd = 4, 16, 4, 2, 8
    q = randn(B_, 1, H, hd)
    kn, vn = randn(B_, KV, hd, seed=1), randn(B_, KV, hd, seed=2)
    kc, vc = randn(B_, Smax, KV, hd, seed=3), randn(B_, Smax, KV, hd, seed=4)
    index = torch.tensor([0, 5, 15, 40], dtype=torch.int32)
    c, _ = count(ops.decode_attention_write, q, kn, vn, kc, vc, index)
    live = 1 + 6 + 16 + 16
    want = decode_attention.cost(B_, H, KV, hd, live, itemsize=4,
                                 new_itemsize=4)
    assert want.flops == 4 * live * H * hd
    assert want.bytes == 4 * (2 * B_ * H * hd + 2 * live * KV * hd
                              + 2 * B_ * KV * hd * 2) + 4 * B_
    assert (c.flops, c.bytes, c.transcendentals) == want
    assert set(c.by_op) == {"kernel:decode_attention_write"}


@pytest.mark.parametrize("state", [False, True])
def test_ssm_scan_region(state):
    Bsz, L, H, hd, N = 1, 70, 4, 8, 8
    x, dt = randn(Bsz, L, H, hd), randn(Bsz, L, H, seed=1).abs()
    A = -torch.arange(1.0, H + 1)
    Bm = randn(Bsz, L, 1, N, seed=2).expand(Bsz, L, H, N)
    C = randn(Bsz, L, H, N, seed=3)
    c, _ = count(ops.ssm_scan, x, dt, A, Bm, C, return_state=state)
    # chunks of 64 and 6 tokens; B one group (a stride-0 head axis), C four
    flops = sum(2 * (n * (n + 1) // 2) * (N + hd) + 4 * n * N * hd
                for n in (64, 6)) * Bsz * H
    nbytes = 4 * (2 * L * H * hd + L * H + H + L * (1 + H) * N
                  + (H * hd * N if state else 0))
    want = ssm_scan.cost(Bsz, L, H, hd, N, groups_b=1, groups_c=H,
                         state=state)
    assert (want.flops, want.bytes) == (flops, nbytes)
    assert (c.flops, c.bytes, c.transcendentals) == want
    assert set(c.by_op) == {"kernel:ssm_scan"}


def test_fused_sample_region_greedy_and_sampled():
    B_, V = 3, 50
    logits = randn(B_, V)
    ctr = torch.arange(B_, dtype=torch.int32)
    temp = torch.tensor([0.0, 0.7, 1.0])
    c, _ = count(ops.fused_sample, logits, ctr, ctr, ctr, temp)
    assert (c.flops, c.bytes, c.transcendentals) == sample.cost(B_, V, 2)
    assert sample.cost(B_, V, 2) == (B_ * V + 4 * V, 4 * B_ * V + 20 * B_,
                                     4 * V)
    c, _ = count(ops.fused_sample, logits, ctr, ctr, ctr, torch.zeros(B_))
    assert (c.flops, c.bytes, c.transcendentals) == (B_ * V, 4 * B_ * V
                                                      + 20 * B_, 0)
    assert set(c.by_op) == {"kernel:fused_sample"}


@pytest.mark.parametrize("KV", [4, 2])
def test_plain_versions_return_the_kernels_layout(KV):
    """Contiguous, as the kernels' outputs: the ops after a call, and so
    the counts, are the same on either device."""
    q, k, v = _qkv(2, 9, 9, 4, KV, 8)
    assert ops.flash_attention(q, k, v, causal=True).is_contiguous()
    kc, vc = randn(2, 16, KV, 8, seed=3), randn(2, 16, KV, 8, seed=4)
    idx = torch.tensor([3, 20], dtype=torch.int32)
    assert ops.decode_attention(q[:, :1], kc, vc, idx).is_contiguous()
    assert ops.decode_attention_write(q[:, :1], k[:, 0], v[:, 0], kc, vc,
                                      idx).is_contiguous()
    tbl = torch.arange(8, dtype=torch.int32).reshape(2, 4)
    assert ops.decode_attention_paged(q[:, :1], kc.reshape(8, 4, KV, 8),
                                      vc.reshape(8, 4, KV, 8), tbl,
                                      idx).is_contiguous()
    x, dt = randn(2, 9, 4, 8), randn(2, 9, 4, seed=1).abs()
    Bm = randn(2, 9, 1, 8, seed=2).expand(2, 9, 4, 8)
    y, h = ops.ssm_scan(x, dt, -torch.ones(4), Bm, Bm, return_state=True)
    assert y.is_contiguous() and h.is_contiguous()


def test_wrappers_unchanged_outside_a_counter():
    q, k, v = _qkv(1, 9, 9, 4, 2, 8)
    before = ops.launch_counts()
    a = ops.flash_attention(q, k, v, causal=True)
    _, b = count(ops.flash_attention, q, k, v, causal=True)
    assert torch.equal(a, b)
    assert ops.launch_counts() == before      # the CPU launches nothing


def test_two_counts_of_one_program_are_equal():
    cfg = get_smoke_config("zamba2-2.7b")
    recs = []
    for _ in range(2):
        params, step, args = dryrun.build_cell(cfg, SHAPES["decode"], "cpu")
        c, _ = count(step, *args)
        recs.append((cost_summary(c), dict(c.by_op), c.kernels))
    assert recs[0] == recs[1]


# ------------------------------------------------------- serve step counts


def matmul_closed_form(cfg, kind: str) -> int:
    """Matmul-class FLOPs of one prefill (B prompts of S) or decode (B
    rows) step: 2 a multiply-add of every Linear, the Mamba2 conv (prefill)
    and state readout (decode), and the tied readout of one row each."""
    d, V = cfg.d_model, cfg.vocab
    tokens = B * S if kind == "prefill" else B
    attn = lambda din: 2 * din * cfg.hd * (2 * cfg.n_heads
                                           + 2 * cfg.n_kv_heads)
    total = 2 * B * d * V
    if cfg.hybrid is None:
        per = attn(d) + 6 * d * cfg.d_ff
        return total + cfg.n_layers * tokens * per
    di, N, H = cfg.d_inner, cfg.ssm.d_state, cfg.ssm_heads
    GN = cfg.ssm.n_groups * N
    mamba = 2 * d * (2 * di + 2 * GN + H) + 2 * di * d
    if kind == "prefill":
        mamba += 2 * (di + 2 * GN) * cfg.ssm.d_conv
    else:
        mamba += 2 * H * cfg.ssm.headdim * N
    groups = cfg.n_layers // cfg.hybrid.attn_every
    shared = attn(2 * d) + 6 * 2 * d * cfg.d_ff + 2 * 2 * d * d
    return total + tokens * (cfg.n_layers * mamba + groups * shared)


def port_count(arch, kind):
    cfg = get_smoke_config(arch)
    params, step, args = dryrun.build_cell(cfg, SHAPES[kind], "cpu")
    c, _ = count(step, *args)
    return cfg, c


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_matmul_flops_equal_closed_form(arch, kind):
    cfg, c = port_count(arch, kind)
    got = sum(v[1] for k, v in c.by_op.items() if k in MATMULS)
    assert got == matmul_closed_form(cfg, kind)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_step_flops_against_reference(arch, kind):
    cfg, c = port_count(arch, kind)
    rcfg = dataclasses.replace(ref_smoke_config(arch), use_scan=False,
                               use_pallas=False)
    # shapes only: the compiled cost does not read the weights
    params = jax.eval_shape(lambda key: RefLM.init(key, rcfg)[0],
                            jax.random.PRNGKey(0))
    if kind == "prefill":
        lowered = jax.jit(ref_prefill_step(rcfg, S)).lower(
            params, {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)})
    else:
        cache = {**RefLM.init_cache(rcfg, B, S), "index": jnp.int32(S - 1)}
        lowered = jax.jit(ref_decode_step(rcfg)).lower(
            params, jax.ShapeDtypeStruct((B, 1), jnp.int32), cache)
    ref = ref_cost_summary(lowered.compile())["flops"]
    if kind == "prefill":      # the time scan, whose body XLA counts once
        ref += ref_ssm_scan_flops(rcfg, ShapeCfg("s", S, B, kind))
    # the (query, key) pairs XLA's plain attention multiplies and the
    # kernel regions skip: prefill masks S·S less the visible pairs;
    # decode over a full ring of S slots masks none
    n_attn = (cfg.n_layers // cfg.hybrid.attn_every if cfg.hybrid
              else cfg.n_layers)
    masked = 0
    if kind == "prefill":
        masked = S * S - flash_attention.visible_pairs(
            S, S, window=cfg.sliding_window)
    port = c.flops + 4 * B * n_attn * cfg.n_heads * cfg.hd * masked
    assert abs(port - ref) <= REF_TOL * ref, (port, ref, c.flops)


# ------------------------------------------------------------------ dry-run


def test_dryrun_record_keys_and_launches(tmp_path):
    cfg = dataclasses.replace(get_smoke_config("zamba2-2.7b"),
                              name="zamba2-2.7b")
    rec = dryrun.analyze_cell(cfg, SHAPES["prefill"], "cpu", reps=2)
    for key in ("arch", "shape", "mesh", "chips", "cost", "memory",
                "collective_bytes", "collective_detail", "device",
                "replica_batch", "step_s", "step_s_runs", "launches",
                "scan_flops_counted"):
        assert key in rec
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == (
        "zamba2-2.7b", "prefill_32k", [1, 1], 1)
    assert rec["replica_batch"] == B and len(rec["step_s_runs"]) == 2
    assert rec["collective_bytes"] == 0.0 and rec["collective_detail"] == {}
    assert rec["launches"] == {}               # no kernel launches on a CPU
    assert rec["memory"]["temp_size_in_bytes"] == 0
    assert rec["device"] == {"name": "cpu", "power_limit": None}
    assert rec["kernel_regions"]["ssm_scan"]["calls"] == cfg.n_layers
    assert set(rec["cost"]) == {"flops", "bytes", "transcendentals"}
    json.dumps(rec)


@pytest.mark.parametrize("argv,what", [
    (["--mesh", "card", "--shape", "train_4k"], "train_4k"),
    (["--probe"], "--probe")])
def test_dryrun_cli_refuses_by_name(argv, what, capsys, tmp_path):
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--arch", "qwen2.5-3b"] + argv + ["--out",
                                                       str(tmp_path)])
    assert e.value.code != 0
    assert what in capsys.readouterr().err


def test_dryrun_runs_on_cuda_unless_asked(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.main(["--arch", "qwen2.5-3b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
