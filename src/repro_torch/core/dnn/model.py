"""The paper's multi-stream DNN optimizer (§3.2.1) as an ``nn.Module``
(``repro.core.dnn.model``).

Three dedicated pathways process heterogeneous operational data before
fusion (paper Fig. 5):

  resource-metrics stream   (B, T, F_r) → temporal Conv1D ×2 (+ max/avg pool)
  performance stream        (B, T, F_p) → GRU, final hidden state
  deployment-params stream  (B, F_d)    → Dense ×2 + BatchNorm

Fusion trunk: concat → MLP(128) → shared features.  Decision heads: alloc
(regression), strategy (classification over the deployment-strategy
catalog) and q (Q-values over discrete scaling actions, the RL allocator).

The BatchNorm running statistics are not module state: they are a dict
threaded through every call, and ``features`` and ``forward`` (the
reference's ``MultiStreamDNN.apply``) return the new one.  The reference
runs these networks through ``lax.conv_general_dilated``, ``lax.scan`` and
dense products, none of them a Pallas kernel; here they are plain PyTorch
on ``device`` (cuda unless the caller asks for cpu).  Weights are drawn on
the CPU from a ``torch.Generator`` seeded with ``seed`` and then moved, so
one seed gives the same network on every device; ``dnn_from_reference``
loads the reference's instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.dnn.features import PERF_KEYS, RESOURCE_KEYS
from repro_torch.device import resolve_device
from repro_torch.nn import GRU, MLP, BatchNorm, Conv1D, Linear


@dataclasses.dataclass(frozen=True)
class DNNConfig:
    # stream widths default to the feature registry — adding a channel to
    # features.py widens every freshly-built model with it
    n_resource_features: int = len(RESOURCE_KEYS)
    n_perf_features: int = len(PERF_KEYS)
    n_deploy_features: int = 12
    window: int = 32              # T: sliding-window length fed to the nets
    conv_channels: int = 32
    gru_hidden: int = 32
    deploy_hidden: int = 32
    trunk_hidden: int = 128
    feature_dim: int = 64
    n_resources: int = 4          # alloc head: cpu/hbm/ici/replicas
    n_strategies: int = 6         # strategy head: catalog size
    n_actions: int = 7            # q head: replica deltas {-4,-2,-1,0,1,2,4}


class MultiStreamDNN(nn.Module):
    def __init__(self, cfg: DNNConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        g = torch.Generator().manual_seed(seed)
        lin = lambda i, o: Linear(i, o, dtype=None, generator=g)
        # resource stream: two temporal convs
        self.conv1 = Conv1D(cfg.n_resource_features, cfg.conv_channels, 5,
                            generator=g)
        self.conv2 = Conv1D(cfg.conv_channels, cfg.conv_channels, 3,
                            generator=g)
        # performance stream: GRU
        self.gru = GRU(cfg.n_perf_features, cfg.gru_hidden, generator=g)
        # deployment stream: dense + BN ×2
        self.dep1 = lin(cfg.n_deploy_features, cfg.deploy_hidden)
        self.bn1 = BatchNorm(cfg.deploy_hidden)
        self.dep2 = lin(cfg.deploy_hidden, cfg.deploy_hidden)
        self.bn2 = BatchNorm(cfg.deploy_hidden)
        # fusion trunk
        self.trunk = MLP((2 * cfg.conv_channels + cfg.gru_hidden
                          + cfg.deploy_hidden, cfg.trunk_hidden,
                          cfg.feature_dim), generator=g)
        # heads
        self.alloc = lin(cfg.feature_dim, cfg.n_resources)
        self.strategy = lin(cfg.feature_dim, cfg.n_strategies)
        self.q = lin(cfg.feature_dim, cfg.n_actions)
        self.to(dev)

    def init_state(self) -> dict:
        return {"bn1": self.bn1.init_state(), "bn2": self.bn2.init_state()}

    def features(self, state: dict, streams: dict, *, training: bool = False):
        """streams = {"resource": (B,T,F_r), "perf": (B,T,F_p),
        "deploy": (B,F_d)} → ((B, feature_dim), new_state)."""
        res, perf, dep = (streams["resource"], streams["perf"],
                          streams["deploy"])
        # resource: conv → relu → conv → relu → global max+avg pool over T
        h = F.relu(self.conv1(res, causal=True))
        h = F.relu(self.conv2(h, causal=True))
        r_feat = torch.cat([h.amax(dim=1), h.mean(dim=1)], dim=-1)
        # performance: GRU final hidden
        p_final, _ = self.gru(perf)
        # deployment: dense + BN ×2
        d, st1 = self.bn1(state["bn1"], self.dep1(dep), training=training)
        d = F.relu(d)
        d, st2 = self.bn2(state["bn2"], self.dep2(d), training=training)
        d = F.relu(d)
        fused = torch.cat([r_feat, p_final, d], dim=-1)
        feat = self.trunk(fused, act=F.relu, final_act=F.relu)
        return feat, {"bn1": st1, "bn2": st2}

    def forward(self, state: dict, streams: dict, *,
                training: bool = False):
        """→ (outputs dict, new_state)."""
        feat, new_state = self.features(state, streams, training=training)
        out = {
            "alloc": self.alloc(feat),
            "strategy_logits": self.strategy(feat),
            "q": self.q(feat),
            "features": feat,
        }
        return out, new_state


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_count_leaves(v) for v in tree)
    return 1


def dnn_from_reference(params_np, state_np, cfg: DNNConfig, device="cuda"):
    """The reference's ``MultiStreamDNN`` parameters and BatchNorm state
    (numpy trees, for example ``jax.tree.map(np.asarray, ...)``) → (the
    port's ``MultiStreamDNN``, its state dict) on ``device``.  The network
    stacks nothing: its fusion trunk is a *list* of layers (``{"layers":
    [{"w", "b"}, …]}``), so a name part that is a digit
    (``trunk.layers.1.w``) indexes that list.  Every leaf of the parameter
    tree must be consumed."""
    dev = resolve_device(device)
    model = MultiStreamDNN(cfg, device=dev)
    n_used = 0
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = params_np
            for part in name.split("."):
                leaf = leaf[int(part)] if part.isdigit() else leaf[part]
            value = np.asarray(leaf)
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference {value.shape} vs port "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(value, dtype=p.dtype))
            n_used += 1
    n_ref = _count_leaves(params_np)
    if n_used != n_ref:
        raise ValueError(f"bridge consumed {n_used} of the reference's "
                         f"{n_ref} DNN parameter leaves")
    state = {bn: {k: torch.tensor(np.asarray(v), dtype=torch.float32,
                                  device=dev)
                  for k, v in state_np[bn].items()}
             for bn in model.init_state()}
    return model, state
