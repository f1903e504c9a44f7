"""The port's SSD scan, Conv1D and Mamba2 against the JAX reference, on the
CPU.

- ``ops.ssm_scan`` on CPU tensors (the plain sequential recurrence) against
  ``repro.kernels.ref.ssm_scan_ref`` and against the Pallas kernel in
  interpret mode, on the reference's sweep (``tests/test_kernels.py``:
  B, L, H, hd, N, chunk; L = 100 is ragged): atol = rtol = 3e-4, the
  reference's own tolerance; the instant-forgetting property; the final
  state of ``return_state=True`` against the reference's
  ``LM._mamba2_final_state`` within 1e-5.
- ``Conv1D`` (causal and "SAME", depthwise and dense) within 1e-6.
- ``Mamba2`` forward and one-token decode (output and both state leaves) at
  bridged weights, with one and two B/C groups, within atol = rtol = 1e-5.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import TINY_CFGS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import LM as RefLM
from repro.models.mamba import Mamba2 as RefMamba2
from repro.nn import Conv1D as RefConv1D

from repro_torch.kernels import ops, ref
from repro_torch.models import HybridCfg, ModelConfig, MoECfg, SSMCfg
from repro_torch.models.bridge import from_reference
from repro_torch.nn import Conv1D

SCAN_TOL = 3e-4
RTOL, ATOL = 1e-5, 1e-5


def port_cfg(rcfg, **kw):
    """The port's ModelConfig equal, field for field, to a reference one."""
    d = {**dataclasses.asdict(rcfg), **kw}
    for name, cls in (("ssm", SSMCfg), ("hybrid", HybridCfg), ("moe", MoECfg)):
        if isinstance(d[name], dict):
            d[name] = cls(**d[name])
    d["m_rope_sections"] = tuple(d["m_rope_sections"])
    return ModelConfig(**d)


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol)


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def scan_inputs(B, L, H, hd, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, H, hd)).astype(np.float32)
    dt = np.logaddexp(rng.standard_normal((B, L, H)), 0).astype(np.float32)
    A = -np.exp(rng.standard_normal(H)).astype(np.float32)
    Bm = rng.standard_normal((B, L, H, N)).astype(np.float32)
    C = rng.standard_normal((B, L, H, N)).astype(np.float32)
    return x, dt, A, Bm, C


# ------------------------------------------------------------ the SSD scan


@pytest.mark.parametrize("chunk", [32, 64])
@pytest.mark.parametrize("N", [4, 8])
@pytest.mark.parametrize("hd", [8, 16])
@pytest.mark.parametrize("H", [2, 4])
@pytest.mark.parametrize("L", [64, 128, 256, 100])
@pytest.mark.parametrize("B", [1, 2])
def test_ssm_scan_plain_matches_reference(B, L, H, hd, N, chunk):
    args = scan_inputs(B, L, H, hd, N, seed=L + H + N)
    got = ops.ssm_scan(*map(torch.from_numpy, args), chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == (B, L, H, hd)
    close(got, jref.ssm_scan_ref(*args), SCAN_TOL, SCAN_TOL)
    close(got, jops.ssm_scan(*args, chunk=chunk, interpret=True), SCAN_TOL,
          SCAN_TOL)


def test_ssm_scan_instant_forgetting():
    """A -> -inf in effect (dt = 100, A = -1): no cross-step memory, so
    y_t = (dt_t x_t)(B_t . C_t)."""
    B, L, H, hd, N = 1, 64, 2, 8, 4
    x, _, _, Bm, C = scan_inputs(B, L, H, hd, N, seed=11)
    dt = np.full((B, L, H), 100.0, np.float32)
    A = -np.ones(H, np.float32)
    got = ops.ssm_scan(*map(torch.from_numpy, (x, dt, A, Bm, C)), chunk=32)
    want = (dt[..., None] * x) * np.einsum("blhn,blhn->blh", Bm, C)[..., None]
    close(got, want, 1e-3, 1e-3)


@pytest.mark.parametrize("L", [1, 7, 64, 100])
def test_ssm_scan_return_state_is_the_last_carry(L):
    """With return_state the plain path returns y unchanged and the carry
    after token L-1: scanning one more token from it gives the same y as
    scanning L+1 tokens at once."""
    B, H, hd, N = 2, 3, 8, 4
    args = scan_inputs(B, L + 1, H, hd, N, seed=L)
    full = ref.ssm_scan_ref(*map(torch.from_numpy, args))
    head = [torch.from_numpy(a[:, :L]) if a.ndim > 1 else torch.from_numpy(a)
            for a in args]
    y, h = ops.ssm_scan(*head, return_state=True)
    assert h.shape == (B, H, hd, N) and h.dtype == torch.float32
    close(y, full[:, :L])
    x, dt, A, Bm, C = (torch.from_numpy(a) for a in args)
    a = torch.exp(dt[:, L] * A[None])
    h1 = (a[..., None, None] * h
          + (dt[:, L, :, None] * x[:, L])[..., None] * Bm[:, L, :, None, :])
    close(torch.einsum("bhdn,bhn->bhd", h1, C[:, L]), full[:, L])


# ------------------------------------------------------------------ Conv1D


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("C,out,groups,k", [(12, 12, 12, 4), (6, 5, 1, 3),
                                            (8, 8, 2, 4)])
def test_conv1d_matches_reference(causal, C, out, groups, k):
    params = RefConv1D.init(jax.random.PRNGKey(C + k), C, out, k,
                            groups=groups)
    params = {n: np.asarray(v) + 0.1 * _x(v.shape, 1) for n, v in
              params.items()}                 # a non-zero bias too
    x = _x((2, 9, C), 2)
    want = RefConv1D.apply(params, x, causal=causal, groups=groups)
    conv = Conv1D(C, out, k, groups=groups)
    assert tuple(conv.w.shape) == params["w"].shape == (k, C // groups, out)
    with torch.no_grad():
        conv.w.copy_(torch.from_numpy(params["w"]))
        conv.b.copy_(torch.from_numpy(params["b"]))
    got = conv(torch.from_numpy(x), causal=causal)
    assert got.is_contiguous()          # NLC, as K7's wrapper takes it
    close(got, want, 1e-6, 1e-6)


def test_conv1d_init_distribution():
    conv = Conv1D(256, 256, 4, groups=256,
                  generator=torch.Generator().manual_seed(0))
    assert float(conv.b.abs().max()) == 0.0
    # std = (1 / fan_in) ** 0.5 with fan_in = in/groups * k = 4
    assert abs(float(conv.w.std()) - 0.5) < 0.05


# ------------------------------------------------------------------ Mamba2


@functools.lru_cache(maxsize=None)
def ssm_pair(n_groups):
    """(reference cfg, reference params, port model): TINY_CFGS["ssm2"]
    widened to 4 heads per group."""
    base = TINY_CFGS["ssm2"]
    rcfg = dataclasses.replace(base, ssm=dataclasses.replace(
        base.ssm, n_groups=n_groups))
    params = jax.jit(lambda key: RefLM.init(key, rcfg)[0])(
        jax.random.PRNGKey(n_groups))
    params = jax.tree.map(np.asarray, params)
    return rcfg, params, from_reference(params, port_cfg(rcfg), device="cpu")


def mamba0(params):
    return jax.tree.map(lambda p: p[0], params["blocks"]["mamba"])


@pytest.mark.parametrize("n_groups", [1, 2])
def test_mamba2_forward_and_decode_match(n_groups):
    rcfg, params, model = ssm_pair(n_groups)
    m, mp = model.blocks[0].mamba, mamba0(params)
    assert rcfg.ssm_heads // n_groups >= 2     # the repeat is exercised
    x = _x((2, 11, rcfg.d_model), 3)
    with torch.no_grad():
        close(m(torch.from_numpy(x)), RefMamba2.apply(mp, x, rcfg))
        y, st = m(torch.from_numpy(x), return_state=True)
    close(y, RefMamba2.apply(mp, x, rcfg))
    want = RefLM._mamba2_final_state(mp, x, rcfg)
    for n in ("h", "conv"):
        close(st[n], want[n])

    shapes = RefMamba2.state_shape(rcfg, 2)
    state = {n: _x(s, 4 + i) for i, (n, (s, _, _)) in
             enumerate(shapes.items())}
    x1 = _x((2, 1, rcfg.d_model), 6)
    ry, rst = RefMamba2.decode(mp, x1, rcfg, {n: jnp.asarray(v) for n, v in
                                                state.items()})
    tstate = {n: torch.from_numpy(v.copy()) for n, v in state.items()}
    with torch.no_grad():
        ty, tst = m.decode(torch.from_numpy(x1), tstate)
    assert tst is tstate                         # written in place
    close(ty, ry)
    for n in ("h", "conv"):
        close(tstate[n], rst[n])

