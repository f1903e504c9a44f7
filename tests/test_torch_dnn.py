"""The port's control-plane networks against the JAX package's, on the CPU,
at bridged weights.

- ``Conv1D`` (causal and "SAME"), ``GRU``, ``BatchNorm`` (training and
  evaluation, with threaded state) and ``MLP``, then ``MultiStreamDNN``'s
  forward (the reference's ``apply``) in both modes: outputs and new
  BatchNorm state within atol = 1e-5 (float32; the two sides sum in other
  orders).
- ``adamw`` against the reference's over 5 steps, with and without weight
  decay: updates and moments within 1e-6.
- ``DQNAgent`` at bridged weights and the same seed: ``q_values`` within
  1e-5; ``observe`` past warmup, ``train_offline`` and ``imitate``: losses,
  parameters and BatchNorm state within 1e-4, and the replay indices (one
  numpy generator on each side) equal.

Some leaves are held differently, and ``test_deploy_stream_gradients_
vanish`` shows why.  ``dep1.b`` and ``dep2.b`` feed a BatchNorm that runs in
training mode in every gradient pass, so their gradient is zero in exact
arithmetic and each side's is rounding noise (about 1e-7 beside gradients
of order 1).  When every row of a batch carries the same deployment vector,
as in the closed loop, which serves one deployment, the same holds for the
whole deployment stream before its last normalisation (``dep1``, ``bn1``,
``dep2`` and ``bn2``'s scale): each BatchNorm sees identical rows, so its
output is its bias whatever the weights before it are.  ``bn2``'s bias
starts at 0 and then meets a ReLU at its kink: the sign of the rounding
noise decides whether its gradient passes.  AdamW divides a gradient by
its own running RMS, so that noise moves each such leaf by up to about lr
a step, in a direction neither side determines; so do the rows of the
trunk's first layer that read the stream's output, which is that ReLU's.
They are held to Adam's step bound, 1.2·lr a step on each side, and the
running means that absorb them to that bound carried through the layer
before them.  Every other element, and every loss, is held to 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.allocation.rl import DQNAgent as RefAgent
from repro.core.allocation.rl import DQNConfig as RefDQNConfig
from repro.core.dnn.model import DNNConfig as RefDNNConfig
from repro.core.dnn.model import MultiStreamDNN as RefDNN
from repro.nn import MLP as RefMLP
from repro.nn import BatchNorm as RefBatchNorm
from repro.nn import Conv1D as RefConv1D
from repro.nn import GRU as RefGRU
from repro.optim import adamw as ref_adamw
from repro.optim import apply_updates as ref_apply_updates
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import global_norm as ref_global_norm

from repro_torch.core.allocation.rl import DQNAgent, DQNConfig
from repro_torch.core.dnn.model import (
    DNNConfig, MultiStreamDNN, dnn_from_reference,
)
from repro_torch.nn import MLP, GRU, BatchNorm, Conv1D
from repro_torch.optim import (
    adamw, apply_updates, clip_by_global_norm, global_norm,
)

CFG = DNNConfig()
NET_TOL = 1e-5
DQN_TOL = 1e-4
# Adam's |m̂ / √v̂| stays below 1.2 for b1 = 0.9, b2 = 0.95 (Cauchy-Schwarz
# over the two EWMAs), so a leaf moves at most 1.2·lr a step on each side
ADAM_STEP = 1.2
ZERO_GRAD = ("dep1.b", "dep2.b")
# ... and with one deployment vector in every row of the batch
ZERO_GRAD_ONE_DEPLOYMENT = ZERO_GRAD + ("dep1.w", "bn1.scale", "bn1.bias",
                                        "dep2.w", "bn2.scale")
# ... and bn2's bias, whose gradient the ReLU at 0 gates by the noise's
# sign, and the trunk's rows that read that ReLU (the deploy features come
# last in the fused vector)
DEPLOY_ROWS = slice(2 * CFG.conv_channels + CFG.gru_hidden, None)
UNDETERMINED_ONE_DEPLOYMENT = {
    **{n: slice(None) for n in ZERO_GRAD_ONE_DEPLOYMENT + ("bn2.bias",)},
    "trunk.layers.0.w": DEPLOY_ROWS}


def t(x):
    return torch.tensor(np.asarray(x))


def flat(tree, prefix=()):
    """A nested dict/list tree → {"a.0.b": numpy array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {".".join(prefix): np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(flat(v, prefix + (k,)))
    return out


def load(module, params_np):
    """Copy a reference layer's params (a dict) into a port module."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            p.copy_(t(flat(params_np)[name]))
    return module


def close(got, want, tol=NET_TOL, what=""):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=0,
                               err_msg=what)


# ------------------------------------------------------------------ layers


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kernel", [3, 5])
def test_conv1d_equals_reference(causal, kernel):
    rp = RefConv1D.init(jax.random.PRNGKey(kernel), 9, 16, kernel)
    conv = load(Conv1D(9, 16, kernel), rp)
    x = np.random.default_rng(0).normal(size=(3, 32, 9)).astype(np.float32)
    close(conv(t(x), causal=causal), RefConv1D.apply(rp, x, causal=causal))


@pytest.mark.parametrize("T", [1, 7, 32])
def test_gru_equals_reference(T):
    rp = RefGRU.init(jax.random.PRNGKey(T), 10, 32)
    gru = load(GRU(10, 32), rp)
    rng = np.random.default_rng(T)
    x = rng.normal(size=(4, T, 10)).astype(np.float32)
    h0 = rng.normal(size=(4, 32)).astype(np.float32)
    h, hs = gru(t(x))
    rh, rhs = RefGRU.apply(rp, x)
    close(h, rh)
    close(hs, rhs)
    close(gru(t(x), t(h0))[0], RefGRU.apply(rp, x, jnp.asarray(h0))[0])


@pytest.mark.parametrize("training", [True, False])
def test_batchnorm_with_threaded_state_equals_reference(training):
    rng = np.random.default_rng(1)
    rp = {"scale": rng.normal(size=8).astype(np.float32),
          "bias": rng.normal(size=8).astype(np.float32)}
    bn = load(BatchNorm(8), rp)
    state = {"mean": rng.normal(size=8).astype(np.float32),
             "var": rng.random(8).astype(np.float32) + 0.5,
             "count": np.float32(3.0)}
    for _ in range(3):                        # the state threads through
        x = (rng.normal(size=(16, 8)) * 3 + 1).astype(np.float32)
        y, new = bn({k: t(v) for k, v in state.items()}, t(x),
                    training=training)
        ry, rnew = RefBatchNorm.apply(rp, state, x, training=training)
        close(y, ry)
        for k in ("mean", "var", "count"):
            close(new[k], rnew[k])
        state = {k: np.asarray(v) for k, v in rnew.items()}
    assert float(new["count"]) == (6.0 if training else 3.0)


def test_batchnorm_is_not_nn_batchnorm1d():
    """The biased batch variance goes into the running state (torch's
    module keeps the unbiased one)."""
    x = torch.tensor([[0.0], [2.0]])
    _, new = BatchNorm(1)(BatchNorm(1).init_state(), x, training=True)
    assert float(new["var"]) == pytest.approx(0.9 * 1.0 + 0.1 * 1.0)


def test_mlp_equals_reference():
    rp = RefMLP.init(jax.random.PRNGKey(3), (12, 32, 7))
    mlp = load(MLP((12, 32, 7)), rp)
    x = np.random.default_rng(3).normal(size=(5, 12)).astype(np.float32)
    close(mlp(t(x)), RefMLP.apply(rp, x))
    close(mlp(t(x), final_act=torch.relu),
          RefMLP.apply(rp, x, final_act=jax.nn.relu))


# ---------------------------------------------------------------- the DNN


@functools.lru_cache(maxsize=None)
def ref_dnn():
    params, state = RefDNN.init(jax.random.PRNGKey(0), RefDNNConfig())
    return jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)


def streams(seed, B=6, same_deploy=False):
    rng = np.random.default_rng(seed)
    dep = rng.normal(size=(1 if same_deploy else B, CFG.n_deploy_features))
    return {
        "resource": rng.normal(size=(B, CFG.window, CFG.n_resource_features)
                               ).astype(np.float32),
        "perf": rng.normal(size=(B, CFG.window, CFG.n_perf_features)
                           ).astype(np.float32),
        "deploy": np.broadcast_to(dep, (B, CFG.n_deploy_features)
                                  ).astype(np.float32),
    }


@pytest.mark.parametrize("training", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_multistream_dnn_equals_reference(training, seed):
    params, state = ref_dnn()
    model, st = dnn_from_reference(params, state, CFG, device="cpu")
    s = streams(seed)
    out, new = model(st, {k: t(v) for k, v in s.items()}, training=training)
    rout, rnew = RefDNN.apply(params, state, s, training=training)
    for k in ("alloc", "strategy_logits", "q", "features"):
        close(out[k], rout[k])
    for bn in ("bn1", "bn2"):
        for k in ("mean", "var", "count"):
            close(new[bn][k], rnew[bn][k])


def test_dnn_bridge_consumes_every_leaf():
    params, state = ref_dnn()
    model, _ = dnn_from_reference(params, state, CFG, device="cpu")
    assert len(dict(model.named_parameters())) == len(flat(params))
    assert {n for n, _ in model.named_parameters()} == set(flat(params))
    extra = dict(params, spare={"w": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="consumed"):
        dnn_from_reference(extra, state, CFG, device="cpu")
    bad = dict(params, q={"w": np.zeros((3, 3), np.float32),
                          "b": params["q"]["b"]})
    with pytest.raises(ValueError, match="q.w"):
        dnn_from_reference(bad, state, CFG, device="cpu")


def test_dnn_seeded_init_is_deterministic():
    a = MultiStreamDNN(CFG, seed=3, device="cpu")
    b = MultiStreamDNN(CFG, seed=3, device="cpu")
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    assert not torch.equal(MultiStreamDNN(CFG, seed=4, device="cpu").q.w, a.q.w)


@pytest.mark.parametrize("same_deploy", [False, True])
def test_deploy_stream_gradients_vanish(same_deploy):
    """The leaves before a training-mode BatchNorm's normalisation have no
    gradient (the biases always, the whole deployment stream when every row
    is one deployment); the others' are of order 1.  In float64, so the
    rounding noise that float32 leaves there (up to 1e-4 of the largest
    gradient after two normalisations of identical rows) falls to 1e-12."""
    zero = ZERO_GRAD_ONE_DEPLOYMENT if same_deploy else ZERO_GRAD
    params, state = ref_dnn()
    model, st = dnn_from_reference(params, state, CFG, device="cpu")
    model.double().requires_grad_(True)
    st = {bn: {k: v.double() for k, v in d.items()} for bn, d in st.items()}
    s = {k: t(v).double() for k, v in streams(
        5, B=16, same_deploy=same_deploy).items()}
    out, _ = model(st, s, training=True)
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(out["q"].square().sum(),
                                list(model.parameters()), allow_unused=True)
    g = {n: float(x.abs().max()) for n, x in zip(names, grads)
         if x is not None}
    top = max(g.values())
    assert all(g[n] < 1e-9 * top for n in zero), g
    assert all(v > 1e-3 * top for n, v in g.items()
               if n not in zero and n.startswith(("dep", "bn", "conv",
                                                  "trunk", "q."))), g


# ------------------------------------------------------------------- AdamW


@pytest.mark.parametrize("decay", [True, False])
def test_adamw_equals_reference(decay):
    rng = np.random.default_rng(7)
    shapes = {"w": (4, 3), "b": (3,), "c": (2, 2, 2)}
    p = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    mask = None if decay else {k: False for k in shapes}
    r_init, r_update = ref_adamw(1e-2, mask=mask)
    init, update = adamw(1e-2, mask=mask)
    rp, rs = dict(p), r_init(p)
    tp = {k: t(v) for k, v in p.items()}
    ts = init(tp)
    for _ in range(5):
        g = {k: rng.normal(size=s).astype(np.float32)
             for k, s in shapes.items()}
        ru, rs = r_update(g, rs, rp)
        tu, ts = update({k: t(v) for k, v in g.items()}, ts, tp)
        for k in shapes:
            close(tu[k], ru[k], 1e-6)
            close(ts.mu[k], rs.mu[k], 1e-6)
            close(ts.nu[k], rs.nu[k], 1e-6)
        rp, tp = ref_apply_updates(rp, ru), apply_updates(tp, tu)
    for k in shapes:
        close(tp[k], rp[k], 1e-6)
    assert ts.step == int(rs.step) == 5
    close(global_norm(tp), ref_global_norm(rp), 1e-5)
    clipped, norm = clip_by_global_norm(tp, 0.5)
    rclipped, rnorm = ref_clip(rp, 0.5)
    for k in shapes:
        close(clipped[k], rclipped[k], 1e-6)


# --------------------------------------------------------------------- DQN


def agents(cfg_kw=None):
    """A reference agent and the port's, the port's loaded with the
    reference's initial weights; the same seed drives both generators."""
    kw = cfg_kw or {}
    ref = RefAgent(RefDNNConfig(), RefDQNConfig(**kw), seed=0)
    port = DQNAgent(CFG, DQNConfig(**kw), seed=0, device="cpu")
    port.load_reference(jax.tree.map(np.asarray, ref.params),
                        jax.tree.map(np.asarray, ref.bn_state))
    return ref, port


def transitions(n, seed, same_deploy=False):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s, s2 = streams(2 * i + seed, B=1), streams(2 * i + 1 + seed, B=1)
        if same_deploy:
            s["deploy"] = s2["deploy"] = streams(seed, B=1)["deploy"]
        out.append((s, int(rng.integers(7)), float(rng.normal()), s2,
                    bool(rng.random() < 0.1)))
    return out


def assert_agents_close(ref, port, steps, lr, deploy=None):
    """Every leaf, the target net and the BN state within DQN_TOL; the
    undetermined elements within Adam's step bound B, the running means
    within B carried through the layer before them: B·(1 + |d|₁) for bn1's
    (x₁ = W₁·d + b₁) and B·(1 + |relu(β₁)|₁ + H·max|W₂|) for bn2's when
    ``deploy`` (the one deployment vector d) fills every batch, where bn1's
    output is its bias β₁; B for both otherwise."""
    loose = ({n: slice(None) for n in ZERO_GRAD} if deploy is None
             else UNDETERMINED_ONE_DEPLOYMENT)
    bound = 2 * ADAM_STEP * lr * steps
    mean_tol = {"bn1": DQN_TOL + bound, "bn2": DQN_TOL + bound}
    if deploy is not None:
        p = port.params
        mean_tol["bn1"] += bound * float(np.abs(deploy).sum())
        mean_tol["bn2"] += bound * float(
            p["bn1.bias"].detach().relu().sum()
            + p["dep2.w"].shape[0] * p["dep2.w"].detach().abs().max())
    for tree, mine in ((ref.params, port.params),
                       (ref.target_params, port.target_params)):
        want = flat(jax.tree.map(np.asarray, tree))
        for name, p in mine.items():
            tol = np.full(p.shape, DQN_TOL, np.float32)
            if name in loose:
                tol[loose[name]] += bound
            got = p.detach().numpy()
            assert (np.abs(got - want[name]) <= tol).all(), (
                name, float(np.abs(got - want[name]).max()))
    for bn in ("bn1", "bn2"):
        close(port.bn_state[bn]["mean"], ref.bn_state[bn]["mean"],
              mean_tol[bn], f"{bn} mean")
        close(port.bn_state[bn]["var"], ref.bn_state[bn]["var"], DQN_TOL,
              f"{bn} var")
        assert float(port.bn_state[bn]["count"]) == \
            float(ref.bn_state[bn]["count"])
    # one generator on each side, drawn in the same order
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state


def test_q_values_and_act_equal_reference():
    ref, port = agents()
    for seed in range(4):
        s = streams(seed, B=1)
        close(port.q_values(s), ref.q_values(s))
        assert port.act(s) == ref.act(s)
        assert port.act(s, greedy=True) == ref.act(s, greedy=True)
    assert port.rng.bit_generator.state == ref.rng.bit_generator.state


def test_replay_sample_indices_equal_reference():
    ref, port = agents({"buffer_size": 64})
    for tr in transitions(40, 3):
        ref.buffer.push(*tr)
        port.buffer.push(*tr)
    a = np.random.default_rng(9)
    b = np.random.default_rng(9)
    for _ in range(3):
        want, got = ref.buffer.sample(a, 16), port.buffer.sample(b, 16)
        assert np.array_equal(got[1], np.asarray(want[1]))
        for k in got[0]:
            assert np.array_equal(got[0][k], np.asarray(want[0][k]))
            assert np.array_equal(got[3][k], np.asarray(want[3][k]))


@pytest.mark.parametrize("same_deploy", [False, True])
def test_observe_past_warmup_equals_reference(same_deploy):
    kw = dict(warmup=8, train_every=2, batch_size=8)
    ref, port = agents(kw)
    losses = []
    trs = transitions(20, 1, same_deploy=same_deploy)
    for tr in trs:
        lr_, lp = ref.observe(*tr), port.observe(*tr)
        assert (lr_ is None) == (lp is None)
        if lp is not None:
            losses.append((lp, lr_))
    assert len(losses) == 7
    got, want = np.array(losses).T
    np.testing.assert_allclose(got, want, atol=DQN_TOL, rtol=0)
    assert port.step_count == ref.step_count
    assert_agents_close(ref, port, len(losses), DQNConfig().lr,
                        deploy=trs[0][0]["deploy"] if same_deploy else None)


def test_train_offline_equals_reference():
    ref, port = agents()
    for tr in transitions(128, 2):
        ref.buffer.push(*tr)
        port.buffer.push(*tr)
    want, got = ref.train_offline(10), port.train_offline(10)
    np.testing.assert_allclose(got, want, atol=DQN_TOL, rtol=0)
    assert_agents_close(ref, port, 10, DQNConfig().lr)
    s = streams(11, B=1)
    close(port.q_values(s), ref.q_values(s), DQN_TOL)


def test_imitate_equals_reference():
    ref, port = agents()
    s = streams(4, B=40)
    actions = np.random.default_rng(4).integers(0, 7, 40)
    want = ref.imitate(s, actions, epochs=3, lr=1e-3, batch_size=16)
    got = port.imitate(s, actions, epochs=3, lr=1e-3, batch_size=16)
    assert len(got) == len(want) == 6
    np.testing.assert_allclose(got, want, atol=DQN_TOL, rtol=0)
    assert_agents_close(ref, port, len(got), 1e-3)
    for k, p in port.params.items():         # target = the pretrained net
        assert torch.equal(p, port.target_params[k])
