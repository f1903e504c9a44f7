"""The port's supervised training and permutation importance against the JAX
package's, on the CPU, at bridged weights of a ``SMALL_DNN`` (window 8).

- ``supervised_loss`` (Huber + cross entropy, as the reference writes them):
  the loss, its two parts, the new BatchNorm state and every parameter's
  gradient within 1e-5, in training and evaluation mode, with distinct
  deployment vectors and with one in every row (in training mode there,
  the deployment stream's gradients are rounding noise on each side: held
  below 1e-2 of the largest gradient, not against each other).
- ``fit`` on distinct deployment vectors, 20 AdamW steps: losses within
  1e-4, the parameters under ``test_torch_dnn``'s rule (1e-4; ``dep1.b``
  and ``dep2.b``, whose gradient is rounding noise, within Adam's step
  bound).  A dataset smaller than the batch takes one step an epoch.
- ``fit`` on one deployment vector in every row, as a recorded trace gives
  it.  There the deployment stream's leaves and ``bn2.bias`` get rounding
  noise for gradient; AdamW turns it into steps of up to 1.2·lr whose sign
  the noise picks, ``bn2.bias``'s ReLU passes the difference into the
  trunk, and the two sides' losses part by more than 1e-4 within a few
  steps.  So the port steps in lockstep with the reference's
  ``make_sgd_step``, taking the reference's values of those leaves (and
  BatchNorm state) after every step: every loss and every other leaf
  within 1e-4 over 20 steps.
- ``permutation_importance``: the same permutations; each group's raw
  increase of the evaluation loss (``test_torch_checks.raw_importance`` over
  each side's ``_eval_loss``) within 1e-4, and each side's normalised result
  equal to its raw increases over their sum.
"""
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.dnn import train as ref_train
from repro.core.dnn.model import DNNConfig as RefDNNConfig
from repro.core.dnn.model import MultiStreamDNN as RefDNN
from repro.core.dnn.traces import supervised_dataset as ref_dataset

from repro_torch.core.dnn import train
from repro_torch.core.dnn.features import deploy_vector
from repro_torch.core.dnn.model import DNNConfig, dnn_from_reference
from repro_torch.core.dnn.traces import supervised_dataset

from test_torch_dnn import (
    DQN_TOL, NET_TOL, UNDETERMINED_ONE_DEPLOYMENT, ZERO_GRAD_ONE_DEPLOYMENT,
    assert_agents_close, flat,
)
from test_torch_checks import raw_importance
from test_torch_traces import trace

CFG = DNNConfig(window=8)
LR = 1e-3
FIT = dict(epochs=10, batch_size=20, seed=3)     # 40 rows: 20 steps


def nets(seed=0):
    """The reference's (params, state) as JAX trees and the port's bridged
    copy, (net, state)."""
    params, state = RefDNN.init(jax.random.PRNGKey(seed),
                                RefDNNConfig(window=CFG.window))
    net, st = dnn_from_reference(jax.tree.map(np.asarray, params),
                                 jax.tree.map(np.asarray, state), CFG,
                                 device="cpu")
    return (params, state), (net, st)


def dataset(seed, n=40, same_deploy=False):
    rng = np.random.default_rng(seed)
    dep = rng.normal(size=(1 if same_deploy else n, CFG.n_deploy_features))
    return {
        "streams": {
            "resource": rng.normal(size=(n, CFG.window,
                                         CFG.n_resource_features)
                                   ).astype(np.float32),
            "perf": rng.normal(size=(n, CFG.window, CFG.n_perf_features)
                               ).astype(np.float32),
            "deploy": np.broadcast_to(dep, (n, CFG.n_deploy_features)
                                      ).astype(np.float32).copy()},
        # a spread past ±1 so both Huber branches are taken
        "alloc_target": (3 * rng.normal(size=(n, CFG.n_resources))
                         ).astype(np.float32),
        "strategy_target": rng.integers(0, CFG.n_strategies, n
                                        ).astype(np.int32),
    }


def ref_batch(ds, idx=None):
    take = (lambda v: v) if idx is None else (lambda v: v[idx])
    return {"streams": {k: jnp.asarray(take(v))
                        for k, v in ds["streams"].items()},
            "alloc_target": jnp.asarray(take(ds["alloc_target"])),
            "strategy_target": jnp.asarray(take(ds["strategy_target"]))}


def port_batch(ds, idx=None):
    return train._batch(ds, idx, torch.device("cpu"))


def sides(ref_params, ref_state, net, state):
    """What ``assert_agents_close`` reads, for a bare network on each side
    (no target net, no generator: both stand-ins equal)."""
    ref = types.SimpleNamespace(params=ref_params, target_params=ref_params,
                                bn_state=ref_state,
                                rng=np.random.default_rng(0))
    p = dict(net.named_parameters())
    port = types.SimpleNamespace(params=p, target_params=p, bn_state=state,
                                 rng=np.random.default_rng(0))
    return ref, port


# ------------------------------------------------------------------ loss


@pytest.mark.parametrize("same_deploy", [False, True])
@pytest.mark.parametrize("training", [True, False])
def test_supervised_loss_and_gradients_equal_reference(training,
                                                       same_deploy):
    (params, state), (net, st) = nets()
    net.requires_grad_(True)
    ds = dataset(1, n=16, same_deploy=same_deploy)
    (want, (rnew, rparts)), rgrads = jax.value_and_grad(
        ref_train.supervised_loss, has_aux=True)(params, state, ref_batch(ds),
                                                 training=training)
    loss, (new, parts) = train.supervised_loss(net, st, port_batch(ds),
                                               training=training)
    names = [n for n, _ in net.named_parameters()]
    grads = torch.autograd.grad(loss, list(net.parameters()),
                                allow_unused=True)
    assert abs(float(loss.detach()) - float(want)) <= NET_TOL
    for k in ("alloc_loss", "strategy_loss"):
        assert abs(float(parts[k].detach()) - float(rparts[k])) <= NET_TOL, k
    want_g = flat(jax.tree.map(np.asarray, rgrads))
    got_g = {n: np.zeros_like(want_g[n]) if g is None else g.numpy()
             for n, g in zip(names, grads)}
    # one deployment in training mode: the deployment stream's leaves have
    # rounding noise for gradient (each side its own: float32 rounding of
    # identical rows times BatchNorm's 1/sqrt(eps) = 316, about 1e-3 of the
    # largest gradient; held below 1e-2 of it), bn2.bias the
    # upstream gradient where that noise opens its ReLU, and the trunk's
    # deploy rows read the noise: not compared, the noise bounded
    loose = UNDETERMINED_ONE_DEPLOYMENT if (training and same_deploy) else {}
    top = max(float(np.abs(g).max()) for g in want_g.values())
    for n, want in want_g.items():
        got = got_g[n].copy()
        if n in loose:
            if n in ZERO_GRAD_ONE_DEPLOYMENT:
                assert np.abs(got).max() <= 1e-2 * top, n
                assert np.abs(want).max() <= 1e-2 * top, n
            got[loose[n]] = want[loose[n]]
        np.testing.assert_allclose(got, want, atol=NET_TOL, rtol=0,
                                   err_msg=n)
    for bn in ("bn1", "bn2"):
        for k in ("mean", "var", "count"):
            np.testing.assert_allclose(new[bn][k].numpy(),
                                       np.asarray(rnew[bn][k]),
                                       atol=NET_TOL, rtol=0)


# ------------------------------------------------------------------- fit


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_equals_reference(seed):
    (params, state), (net, st) = nets(seed)
    ds = dataset(seed)
    rparams, rstate, want = ref_train.fit(params, state, ds, **FIT)
    net, st, got = train.fit(net, st, ds, **FIT)
    assert len(got) == len(want) == 20
    np.testing.assert_allclose(got, want, atol=DQN_TOL, rtol=0)
    assert_agents_close(*sides(rparams, rstate, net, st), len(got), LR)


def test_fit_takes_steps_on_datasets_smaller_than_batch():
    """n = 7 < batch_size = 64: one full-dataset step per epoch, as the
    reference's clamp takes them."""
    (params, state), (net, st) = nets()
    ds = dataset(2, n=7)
    before = net.alloc.w.detach().clone()
    rparams, rstate, want = ref_train.fit(params, state, ds, epochs=2)
    net, st, got = train.fit(net, st, ds, epochs=2)
    assert len(got) == len(want) == 2
    assert not torch.equal(net.alloc.w, before)
    np.testing.assert_allclose(got, want, atol=DQN_TOL, rtol=0)
    assert_agents_close(*sides(rparams, rstate, net, st), 2, LR)


def test_fit_on_a_trace_dataset_clamps_and_steps():
    """The reference learning loop's trace: 7 rows, one deployment."""
    deploy = deploy_vector(model_params_b=1.0, family="dense", mesh_model=1,
                           mesh_data=1, region_idx=0, slo_ms=200.0,
                           cost_weight=0.5)
    ds = supervised_dataset(trace(8), deploy, window=CFG.window)
    want = ref_dataset(trace(8), deploy, window=CFG.window)
    assert len(ds["alloc_target"]) == 7
    (params, state), (net, st) = nets()
    _, _, rl = ref_train.fit(params, state, want, epochs=2, batch_size=64)
    net, st, got = train.fit(net, st, ds, epochs=2, batch_size=64)
    assert len(got) == len(rl) == 2
    assert abs(got[0] - rl[0]) <= DQN_TOL      # before any update


def undetermined(name):
    """The elements ``UNDETERMINED_ONE_DEPLOYMENT`` names for a leaf, or
    None."""
    return UNDETERMINED_ONE_DEPLOYMENT.get(name)


@pytest.mark.parametrize("seed", [0, 1])
def test_fit_one_deployment_in_lockstep_with_reference(seed):
    (params, state), (net, st) = nets(seed)
    ds = dataset(seed + 5, same_deploy=True)
    r_init, r_step = ref_train.make_sgd_step(LR)
    p_init, p_step = train.make_sgd_step(LR)
    r_opt, p_opt = r_init(params), p_init(net)
    rng = np.random.default_rng(FIT["seed"])
    n, bs = len(ds["alloc_target"]), FIT["batch_size"]
    steps = 0
    for _ in range(FIT["epochs"]):
        order = rng.permutation(n)
        for i in range(0, n - bs + 1, bs):
            idx = order[i:i + bs]
            params, state, r_opt, want, _ = r_step(params, state, r_opt,
                                                   ref_batch(ds, idx))
            net, st, p_opt, got, _ = p_step(net, st, p_opt,
                                            port_batch(ds, idx))
            assert abs(float(got) - float(want)) <= DQN_TOL, steps
            steps += 1
            # the undetermined elements and the BatchNorm state they feed
            # take the reference's values
            ref_leaves = flat(jax.tree.map(np.asarray, params))
            with torch.no_grad():
                for name, p in net.named_parameters():
                    rows = undetermined(name)
                    if rows is not None:
                        p[rows] = torch.tensor(ref_leaves[name][rows])
            st = {bn: {k: torch.tensor(np.asarray(v))
                       for k, v in d.items()} for bn, d in state.items()}
    assert steps == 20
    got = {n: p.detach().numpy() for n, p in net.named_parameters()}
    for name, want in flat(jax.tree.map(np.asarray, params)).items():
        np.testing.assert_allclose(got[name], want, atol=DQN_TOL, rtol=0,
                                   err_msg=name)


# ------------------------------------------------------ feature importance


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_permutation_importance_equals_reference(seed):
    (params, state), (net, st) = nets(seed)
    ds = dataset(seed + 10, n=32)
    assert train.FEATURE_GROUPS == ref_train.FEATURE_GROUPS
    want_raw = raw_importance(ref_train._eval_loss, ref_train.FEATURE_GROUPS,
                              params, state, ds, seed=seed)
    want = ref_train.permutation_importance(params, state, ds, seed=seed)
    total = sum(want_raw.values()) or 1.0
    assert {k: v / total for k, v in want_raw.items()} == want
    got_raw = raw_importance(train._eval_loss, train.FEATURE_GROUPS, net, st,
                             ds, seed=seed)
    assert got_raw.keys() == want_raw.keys()
    for k in want_raw:
        assert abs(got_raw[k] - want_raw[k]) <= DQN_TOL, k
    got = train.permutation_importance(net, st, ds, seed=seed)
    assert abs(sum(got.values()) - 1.0) < 1e-9 or not any(got.values())
    got_total = sum(got_raw.values()) or 1.0
    assert got == {k: v / got_total for k, v in got_raw.items()}
