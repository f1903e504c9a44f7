"""Check instrumentation that the port's tests and ``chip_smoke.py`` share,
with tests of its own.  It imports no JAX, so the smoke can import it on a
machine that has none; each test file keeps only its reference side.

- ``exact_deploy_stream``: the port's BatchNorm computing a feature whose
  batch rows are equal (to float32 rounding) as exact arithmetic would.
  A recorded trace carries one deployment vector in every row, so the
  deployment stream's BatchNorms see identical rows: exactly, their output
  is their bias and every leaf before them gets zero gradient; in float32
  each device or framework gets its own rounding noise there, which AdamW
  turns into steps of up to 1.2·lr.
- ``decision_margin`` and ``decision_log``: the hybrid allocator's
  Q-values per decision, and the gap between the two best among the
  actions its SLO envelope admits (what a rounding difference must cross
  to change the decision).
- ``raw_importance``: each feature group's raw increase of the evaluation
  loss, from any ``_eval_loss``, with the permutations drawn as
  ``permutation_importance`` draws them (which returns them normalised).
"""
import contextlib

import numpy as np
import pytest
import torch

from repro_torch.core.allocation.rl import ACTIONS
from repro_torch.core.dnn import train
from repro_torch.core.dnn.model import DNNConfig, MultiStreamDNN
from repro_torch.nn import BatchNorm

# rows of a BatchNorm input that agree to float32 rounding count as equal
# under exact_deploy_stream (the card's matmuls may round identical input
# rows differently)
SAME_RTOL, SAME_ATOL = 1e-5, 1e-7
# a hybrid trajectory is held up to the first tick whose decision margin is
# under MARGIN_FACTOR x the largest Q gap between the two sides
MARGIN_FACTOR = 10.0
_PLAIN_FORWARD = BatchNorm.forward


def exact_bn_forward(self, state, x, *, training, momentum=0.9, eps=1e-5):
    """``BatchNorm.forward`` with identical rows computed exactly: mean =
    the first row, variance 0, output = the bias, and no gradient through
    the centring (the gradients it would pass sum to zero over the rows,
    and every row of the layer before reads the same input).  Other
    features, and evaluation mode, compute as the plain forward does, bit
    for bit."""
    if not training:
        return _PLAIN_FORWARD(self, state, x, training=False,
                              momentum=momentum, eps=eps)
    dims = tuple(range(x.ndim - 1))
    rows = x.reshape(-1, x.shape[-1])
    same = torch.isclose(rows, rows[:1], rtol=SAME_RTOL,
                         atol=SAME_ATOL).all(dim=0)
    mean = torch.where(same, rows[0], x.mean(dim=dims))
    var = torch.where(same, 0.0, x.var(dim=dims, correction=0))
    new_state = {"mean": (momentum * state["mean"]
                          + (1 - momentum) * mean).detach(),
                 "var": (momentum * state["var"]
                         + (1 - momentum) * var).detach(),
                 "count": state["count"] + 1.0}
    y = torch.where(same, 0.0, x - mean) * torch.rsqrt(var + eps)
    return y * self.scale + self.bias, new_state


@contextlib.contextmanager
def exact_deploy_stream():
    """Every port BatchNorm runs ``exact_bn_forward`` inside the block."""
    BatchNorm.forward = exact_bn_forward
    try:
        yield
    finally:
        BatchNorm.forward = _PLAIN_FORWARD


def decision_margin(q, feasible) -> float:
    """The gap between the two best Q-values among the ``feasible`` action
    indices (inf when fewer than two are feasible)."""
    vals = sorted((float(q[i]) for i in feasible), reverse=True)
    return vals[0] - vals[1] if len(vals) > 1 else float("inf")


def decision_log(alloc, log):
    """Wrap ``alloc.decide`` (the reference's allocator or the port's: the
    action set is the same): append (Q-values, the indices of the actions
    the SLO envelope admits) for every decision."""
    decide, q_values = alloc.decide, alloc.agent.q_values
    seen = {}

    def q_logged(streams):
        seen["q"] = np.asarray(q_values(streams))
        return seen["q"]

    def logged(metrics):
        reps = alloc.replicas
        d = decide(metrics)
        c = alloc.constraints
        feasible = [ai for ai, a in enumerate(ACTIONS)
                    if c.min_replicas <= reps + a <= c.max_replicas
                    and alloc.perf_model(reps + a, d.predicted_load)[0]
                    <= c.slo_ms]
        log.append((seen.pop("q"), feasible))
        return d

    alloc.agent.q_values = q_logged
    alloc.decide = logged


def raw_importance(eval_loss, groups, model, state, dataset, *, seed):
    """{group: max(eval_loss(permuted) - eval_loss(dataset), 0)} for each
    of ``groups`` (``FEATURE_GROUPS``), the group's channels permuted
    across rows by ``np.random.default_rng(seed)`` in the order
    ``permutation_importance`` draws them."""
    rng = np.random.default_rng(seed)
    base = eval_loss(model, state, dataset)
    raw = {}
    for group, (stream, chans) in groups.items():
        streams = {k: v.copy() for k, v in dataset["streams"].items()}
        perm = rng.permutation(len(streams[stream]))
        arr = streams[stream].copy()
        arr[..., list(chans)] = arr[perm][..., list(chans)]
        streams[stream] = arr
        raw[group] = max(eval_loss(model, state,
                                   dict(dataset, streams=streams)) - base,
                         0.0)
    return raw


# ------------------------------------------------------------------ tests


def bn_input(seed, same, rows=6, dim=5):
    """(rows, dim) float32; the features in ``same`` hold one value in
    every row, up to a relative 1e-7 of rounding noise."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(rows, dim)).astype(np.float32)
    for f in same:
        x[:, f] = x[0, f] * (1 + 1e-7 * rng.normal(size=rows))
    return torch.tensor(x, requires_grad=True)


@pytest.mark.parametrize("training", [True, False])
def test_exact_bn_equals_plain_on_distinct_rows(training):
    bn = BatchNorm(5)
    with torch.no_grad():
        bn.scale.uniform_(0.5, 1.5)
        bn.bias.uniform_(-1, 1)
    state = {"mean": torch.full((5,), 0.1), "var": torch.full((5,), 0.7),
             "count": torch.tensor(3.0)}
    x = bn_input(0, same=())
    want, want_state = bn(state, x, training=training)
    with exact_deploy_stream():
        got, got_state = bn(state, x, training=training)
    assert torch.equal(got, want)
    for k in state:
        assert torch.equal(got_state[k], want_state[k]), k
    assert BatchNorm.forward is _PLAIN_FORWARD


def test_exact_bn_computes_identical_rows_exactly():
    bn = BatchNorm(5)
    with torch.no_grad():
        bn.bias.copy_(torch.arange(5.0))
    state = bn.init_state()
    x = bn_input(1, same=(1, 3))
    with exact_deploy_stream():
        y, new = bn(state, x, training=True)
    for f in (1, 3):
        assert torch.equal(y[:, f], torch.full((6,), float(f)))
        assert new["var"][f] == 0.9          # momentum x 1 + 0.1 x 0
        assert new["mean"][f] == 0.1 * x[0, f].detach()
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(g[:, [1, 3]], torch.zeros(6, 2))
    plain, _ = bn(state, x, training=True)
    assert not torch.equal(plain[:, 1], y[:, 1])   # plain keeps the noise
    assert torch.equal(plain[:, [0, 2, 4]], y[:, [0, 2, 4]])


def test_decision_margin_reads_only_feasible_actions():
    q = np.array([1.0, 5.0, 3.0, 9.0])
    assert decision_margin(q, [0, 1, 2]) == 2.0
    assert decision_margin(q, [2]) == float("inf")
    assert decision_margin(q, []) == float("inf")
    assert decision_margin(q, [3, 0]) == 8.0


@pytest.mark.parametrize("seed", [0, 1])
def test_raw_importance_normalises_to_permutation_importance(seed):
    cfg = DNNConfig(window=8)
    net = MultiStreamDNN(cfg, seed=seed, device="cpu")
    rng = np.random.default_rng(seed)
    n = 24
    ds = {"streams": {
        "resource": rng.normal(size=(n, cfg.window, cfg.n_resource_features)
                               ).astype(np.float32),
        "perf": rng.normal(size=(n, cfg.window, cfg.n_perf_features)
                           ).astype(np.float32),
        "deploy": rng.normal(size=(n, cfg.n_deploy_features)
                             ).astype(np.float32)},
        "alloc_target": rng.normal(size=(n, cfg.n_resources)
                                   ).astype(np.float32),
        "strategy_target": rng.integers(0, cfg.n_strategies, n
                                        ).astype(np.int32)}
    raw = raw_importance(train._eval_loss, train.FEATURE_GROUPS, net,
                         net.init_state(), ds, seed=seed)
    assert raw.keys() == train.FEATURE_GROUPS.keys()
    assert any(raw.values())
    total = sum(raw.values())
    assert train.permutation_importance(net, net.init_state(), ds,
                                        seed=seed) == \
        {k: v / total for k, v in raw.items()}
