"""Reinforcement-learning allocator core (paper §3.3.1): double DQN
(``repro.core.allocation.rl``).

  * Q-network = the multi-stream DNN's Q head (shared trunk with the other
    heads — the paper's single optimization engine);
  * replay buffer (uniform), target network with soft updates;
  * double-DQN target: argmax from the online net, value from the target net.

One train step is one autograd step, threaded as in the reference: the
gradient pass runs in training mode and returns the new BatchNorm state;
the two bootstrap passes (the online net on s2, then the target net) run in
evaluation mode with the OLD state; the loss is Huber (δ = 1), averaged;
AdamW (``repro_torch.optim``) updates every parameter, the unused heads
with zero gradients and weight decay; the target net then soft-updates by
τ.  One numpy generator drives exploration, replay sampling and the
imitation shuffles in the reference's order, so the sampled indices equal
its own.  The agent runs on the device it is given; the replay buffer stays
in host memory and each sampled batch is copied to the device.
"""
from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.dnn.model import (
    DNNConfig, MultiStreamDNN, dnn_from_reference,
)
from repro_torch.device import resolve_device
from repro_torch.optim import adamw, apply_updates

ACTIONS = (-4, -2, -1, 0, 1, 2, 4)      # replica deltas


@dataclasses.dataclass
class DQNConfig:
    gamma: float = 0.95
    lr: float = 5e-4
    buffer_size: int = 20_000
    batch_size: int = 64
    eps_start: float = 1.0
    eps_end: float = 0.05
    eps_decay_steps: int = 3_000
    target_tau: float = 0.01
    train_every: int = 4
    warmup: int = 200


class ReplayBuffer:
    """Uniform replay over numpy arrays (a copy of the reference's)."""

    def __init__(self, size: int, stream_shapes):
        self.size = size
        self.n = 0
        self.i = 0
        self.data = {
            k: np.zeros((size,) + tuple(s), np.float32)
            for k, s in stream_shapes.items()}
        self.data2 = {
            k: np.zeros((size,) + tuple(s), np.float32)
            for k, s in stream_shapes.items()}
        self.action = np.zeros(size, np.int32)
        self.reward = np.zeros(size, np.float32)
        self.done = np.zeros(size, np.float32)

    def push(self, s, a, r, s2, done):
        j = self.i
        for k in self.data:
            self.data[k][j] = s[k][0]
            self.data2[k][j] = s2[k][0]
        self.action[j] = a
        self.reward[j] = r
        self.done[j] = float(done)
        self.i = (self.i + 1) % self.size
        self.n = min(self.n + 1, self.size)

    def sample(self, rng: np.random.Generator, batch: int):
        """→ (s, a, r, s2, done) as numpy arrays (the agent moves them)."""
        idx = rng.integers(0, self.n, size=batch)
        s = {k: v[idx] for k, v in self.data.items()}
        s2 = {k: v[idx] for k, v in self.data2.items()}
        return s, self.action[idx], self.reward[idx], s2, self.done[idx]


def reward_fn(*, utilization: float, latency_ms: float, slo_ms: float,
              cost_per_tick: float, cost_scale: float,
              w_util: float = 1.0, w_lat: float = 1.0,
              w_cost: float = 1.0) -> float:
    """The paper's three-term reward: utilization up, SLO violations down,
    cost down.  Latency enters as a hinge on the SLO (violations dominate)."""
    r_util = utilization                       # ∈ [0, 1]
    r_lat = -max(latency_ms / slo_ms - 1.0, 0.0) * 4.0
    r_cost = -cost_per_tick / max(cost_scale, 1e-9)
    return w_util * r_util + w_lat * r_lat + w_cost * r_cost


def _huber(err: torch.Tensor) -> torch.Tensor:
    return torch.where(err.abs() < 1.0, 0.5 * err ** 2,
                       err.abs() - 0.5).mean()


class DQNAgent:
    def __init__(self, dnn_cfg: DNNConfig, cfg: DQNConfig = DQNConfig(), *,
                 seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.dnn_cfg = dnn_cfg
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.opt_init, self.opt_update = adamw(cfg.lr)
        net = MultiStreamDNN(dnn_cfg, seed=seed, device=self.device)
        self._set_net(net, net.init_state())
        shapes = {
            "resource": (dnn_cfg.window, dnn_cfg.n_resource_features),
            "perf": (dnn_cfg.window, dnn_cfg.n_perf_features),
            "deploy": (dnn_cfg.n_deploy_features,),
        }
        self.buffer = ReplayBuffer(cfg.buffer_size, shapes)
        self.step_count = 0

    def _set_net(self, net: MultiStreamDNN, bn_state: dict):
        """Online net, its BN state, target = params, a fresh optimizer."""
        self.net = net.requires_grad_(True)
        self.bn_state = bn_state
        self.target = copy.deepcopy(net).requires_grad_(False)
        self.opt_state = self.opt_init(self.params)

    def load_reference(self, params_np, state_np):
        """Take a reference agent's DNN parameters and BatchNorm state
        (numpy trees, for example ``jax.tree.map(np.asarray, ...)``) through
        the weight bridge; the target net starts equal to them."""
        self._set_net(*dnn_from_reference(params_np, state_np, self.dnn_cfg,
                                          device=self.device))

    @property
    def params(self) -> dict:
        return dict(self.net.named_parameters())

    @property
    def target_params(self) -> dict:
        return dict(self.target.named_parameters())

    def _tensors(self, streams) -> dict:
        return {k: torch.as_tensor(np.asarray(v, np.float32),
                                   device=self.device)
                for k, v in streams.items()}

    # ------------------------------------------------------------- acting

    def epsilon(self) -> float:
        c = self.cfg
        frac = min(self.step_count / max(c.eps_decay_steps, 1), 1.0)
        return c.eps_start + (c.eps_end - c.eps_start) * frac

    @torch.no_grad()
    def q_values(self, streams) -> np.ndarray:
        out, _ = self.net(self.bn_state, self._tensors(streams),
                          training=False)
        return out["q"][0].cpu().numpy()

    def act(self, streams, *, greedy: bool = False) -> int:
        """→ action index into ACTIONS."""
        if not greedy and self.rng.random() < self.epsilon():
            return int(self.rng.integers(len(ACTIONS)))
        return int(np.argmax(self.q_values(streams)))

    # ------------------------------------------------------------- learning

    def _step(self, loss: torch.Tensor, opt_update, opt_state):
        """One AdamW step of the online net on ``loss``; unused parameters
        (the heads the loss does not reach) take zero gradients."""
        params = self.params
        grads = torch.autograd.grad(loss, list(params.values()),
                                    allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        updates, opt_state = opt_update(grads, opt_state, params)
        new = apply_updates(params, updates)
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(new[k])
        return opt_state

    def _train_on_batch(self, batch) -> float:
        s, a, r, s2, done = batch
        s, s2 = self._tensors(s), self._tensors(s2)
        a = torch.as_tensor(a, device=self.device).long()
        r = torch.as_tensor(r, device=self.device)
        done = torch.as_tensor(done, device=self.device)
        gamma, tau = self.cfg.gamma, self.cfg.target_tau
        with torch.no_grad():
            q2_online, _ = self.net(self.bn_state, s2, training=False)
            a2 = q2_online["q"].argmax(dim=1)                  # double-DQN
            q2_target, _ = self.target(self.bn_state, s2, training=False)
            q2 = q2_target["q"].gather(1, a2[:, None])[:, 0]
            target = r + gamma * (1.0 - done) * q2
        q, new_bn = self.net(self.bn_state, s, training=True)
        q_sa = q["q"].gather(1, a[:, None])[:, 0]
        loss = _huber(q_sa - target)
        self.opt_state = self._step(loss, self.opt_update, self.opt_state)
        with torch.no_grad():
            for k, t in self.target_params.items():
                t.copy_((1 - tau) * t + tau * self.params[k])
        self.bn_state = new_bn
        return float(loss.detach())

    def observe(self, s, a, r, s2, done=False):
        self.buffer.push(s, a, r, s2, done)
        self.step_count += 1
        loss = None
        if (self.buffer.n >= self.cfg.warmup
                and self.step_count % self.cfg.train_every == 0):
            loss = self._train_on_batch(
                self.buffer.sample(self.rng, self.cfg.batch_size))
        return loss

    def train_offline(self, steps: int, *, batch_size: int = None) -> list:
        """Replay-only training (no new transitions): fits the Q head on a
        recorded trace before the agent ever acts live.  Ignores the online
        warmup/train_every gating — the buffer IS the dataset."""
        if self.buffer.n == 0:
            return []
        bs = min(batch_size or self.cfg.batch_size, self.buffer.n)
        return [self._train_on_batch(self.buffer.sample(self.rng, bs))
                for _ in range(steps)]

    def imitate(self, streams, actions, *, epochs: int = 20, lr: float = 1e-3,
                batch_size: int = 64) -> list:
        """Supervised pretraining of the Q head: cross-entropy of
        softmax(q) against recorded (planner) actions — the cold-start
        imitation the allocator's hybrid mode relies on (paper §5.3)."""
        opt_init, opt_update = adamw(lr)
        opt_state = opt_init(self.params)
        actions = np.asarray(actions, np.int32)
        n = len(actions)
        bs = max(1, min(batch_size, n))
        losses = []
        for _ in range(epochs):
            order = self.rng.permutation(n)
            for i in range(0, n - bs + 1, bs):
                idx = order[i:i + bs]
                s = self._tensors({k: np.asarray(v)[idx]
                                   for k, v in streams.items()})
                a = torch.as_tensor(actions[idx], device=self.device).long()
                out, new_bn = self.net(self.bn_state, s, training=True)
                logp = F.log_softmax(out["q"], dim=-1)
                loss = -logp.gather(1, a[:, None])[:, 0].mean()
                opt_state = self._step(loss, opt_update, opt_state)
                self.bn_state = new_bn
                losses.append(float(loss.detach()))
        # the pretrained policy is the starting point for bootstrapping too
        self.target.load_state_dict(self.net.state_dict())
        return losses
