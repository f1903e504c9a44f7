"""Training loop + feature-importance analysis for the multi-stream DNN
(``repro.core.dnn.train``).

Supervised path (paper §3.2): regress the alloc head onto realized next-window
resource utilization / required replicas and classify the retrospectively-best
deployment strategy; the Q head is trained by the DQN (core/allocation/rl.py)
sharing the same trunk.

Feature importance (paper §4.4): permutation importance over the four metric
groups (resource-utilization / performance / workload / network), evaluated
as the increase in validation loss when a group's channels are shuffled.

Where the reference threads a parameter tree, these functions take the
``MultiStreamDNN`` itself and update its parameters in place; the BatchNorm
state is threaded as in the reference.  One step is one autograd pass
through ``forward(state, streams, training=True)`` and one AdamW step
(``repro_torch.optim``, weight decay 1e-4); the heads the loss does not
reach (the Q head) take zero gradients and weight decay, as the
reference's.  Batches are built on the network's device, and the batch
order and the permutations come from numpy generators drawn in the
reference's order.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.optim import adamw, apply_updates


def supervised_loss(net, state, batch, *, training=True):
    out, new_state = net(state, batch["streams"], training=training)
    # Huber on allocation regression
    err = out["alloc"] - batch["alloc_target"]
    huber = torch.where(err.abs() < 1.0, 0.5 * err ** 2, err.abs() - 0.5)
    alloc_loss = huber.mean()
    # CE on strategy classification
    logp = F.log_softmax(out["strategy_logits"], dim=-1)
    strat_loss = -logp.gather(1, batch["strategy_target"][:, None]).mean()
    loss = alloc_loss + strat_loss
    return loss, (new_state, {"alloc_loss": alloc_loss,
                              "strategy_loss": strat_loss})


def make_sgd_step(lr: float = 1e-3):
    """→ (opt_init(net), step(net, state, opt_state, batch) → (net,
    new_state, opt_state, loss, metrics))."""
    opt_init, opt_update = adamw(lr, weight_decay=1e-4)

    def init(net):
        net.requires_grad_(True)
        return opt_init(dict(net.named_parameters()))

    def step(net, state, opt_state, batch):
        params = dict(net.named_parameters())
        loss, (new_state, metrics) = supervised_loss(net, state, batch)
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        updates, opt_state = opt_update(grads, opt_state, params)
        new = apply_updates(params, updates)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        return (net, new_state, opt_state, loss.detach(),
                {k: v.detach() for k, v in metrics.items()})

    return init, step


def _device(net) -> torch.device:
    return next(net.parameters()).device


def _batch(dataset, idx, device) -> dict:
    """Rows ``idx`` (all rows when None) of a numpy dataset, on ``device``."""
    take = (lambda v: v) if idx is None else (lambda v: v[idx])
    return {
        "streams": {k: torch.as_tensor(take(v), device=device)
                    for k, v in dataset["streams"].items()},
        "alloc_target": torch.as_tensor(take(dataset["alloc_target"]),
                                        device=device),
        "strategy_target": torch.as_tensor(
            take(dataset["strategy_target"]), device=device).long(),
    }


def fit(net, state, dataset, *, epochs: int = 5, lr: float = 1e-3,
        batch_size: int = 64, seed: int = 0, log_every: int = 0):
    """dataset: dict of stacked numpy arrays (streams + targets).
    → (net, state, losses); ``net``'s parameters are updated in place."""
    opt_init, step = make_sgd_step(lr)
    opt_state = opt_init(net)
    device = _device(net)
    n = len(dataset["alloc_target"])
    rng = np.random.default_rng(seed)
    losses = []
    # clamp the batch to the dataset: a short recorded trace (n < batch_size)
    # must still take one full-dataset step per epoch — the unclamped range
    # was empty, silently performing ZERO optimizer steps
    bs = max(1, min(batch_size, n))
    for ep in range(epochs):
        order = rng.permutation(n)
        for i in range(0, n - bs + 1, bs):
            batch = _batch(dataset, order[i:i + bs], device)
            net, state, opt_state, loss, _ = step(net, state, opt_state,
                                                  batch)
            losses.append(float(loss))
        if log_every and (ep % log_every == 0):
            print(f"epoch {ep}: loss={np.mean(losses[-8:]):.4f}")
    return net, state, losses


# ---------------------------------------------------------------------------
# permutation feature importance (paper §4.4.1)
# ---------------------------------------------------------------------------

# channel indices within the streams, by paper metric group
FEATURE_GROUPS = {
    "resource_utilization": ("resource", (0, 1, 2, 3)),   # flop/hbm/ici/mem
    "performance": ("perf", (0, 1, 2, 3)),                # latencies/tp/err
    "workload_patterns": ("perf", (4,)),                  # rps channel
    "network": ("resource", (4, 5)),                      # queue/replica frac
}


@torch.no_grad()
def _eval_loss(net, state, dataset):
    loss, _ = supervised_loss(net, state, _batch(dataset, None, _device(net)),
                              training=False)
    return float(loss)


def permutation_importance(net, state, dataset, *, seed: int = 0):
    """→ {group: normalized importance} (sums to 1)."""
    rng = np.random.default_rng(seed)
    base = _eval_loss(net, state, dataset)
    raw = {}
    for group, (stream, chans) in FEATURE_GROUPS.items():
        ds = {k: (v.copy() if k != "streams" else None)
              for k, v in dataset.items()}
        streams = {k: v.copy() for k, v in dataset["streams"].items()}
        perm = rng.permutation(len(streams[stream]))
        arr = streams[stream].copy()
        arr[..., list(chans)] = arr[perm][..., list(chans)]
        streams[stream] = arr
        ds["streams"] = streams
        raw[group] = max(_eval_loss(net, state, ds) - base, 0.0)
    total = sum(raw.values()) or 1.0
    return {k: v / total for k, v in raw.items()}
