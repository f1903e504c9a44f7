"""Elastic re-mesh: restore a checkpoint onto a different mesh topology
(``repro.launch.elastic``).

When the control plane's allocator grows or shrinks a training job (or a
node fails and the slice is rebuilt smaller), the mesh changes: (data=2,
model=2) → (data=1, model=4).  Every leaf's placement comes from the
logical axis rules (``repro_torch.sharding``), and a checkpoint holds
whole leaves, so re-meshing is: build the new mesh → recompute the
``NamedSharding`` of each leaf from the same rules →
``CheckpointManager.restore(..., shardings=new)`` → the train step under
the new mesh's shard context.  Nothing about the model or the step
changes.

This is also the surface the control plane's scaling actions call: a
``ReMesh`` maps one to one onto ``elastic_restore``.  The port's one
addition is ``devices``: a mesh may lay several positions on one card or
on the CPU (``launch.mesh.make_mesh``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.steps import (
    ShapeDtypeStruct, TrainState, make_train_step, param_axes_and_structs,
)
from repro_torch.optim.adamw import AdamWState
from repro_torch.sharding import TRAIN_RULES, shard_ctx, spec_for
from repro_torch.sharding.shard_map import NamedSharding


@dataclasses.dataclass(frozen=True)
class ReMesh:
    """A control-plane scaling action on a training job."""
    data_axis: int
    model_axis: int
    pods: int = 1

    def mesh(self, devices=None):
        """The mesh over ``cuda:0 ..`` (raising with fewer cards) or over
        ``devices``, which may repeat a device."""
        if self.pods > 1:
            return make_mesh((self.pods, self.data_axis, self.model_axis),
                             ("pod", "data", "model"), devices)
        return make_mesh((self.data_axis, self.model_axis),
                         ("data", "model"), devices)


def state_shardings(cfg, mesh, rules=TRAIN_RULES):
    """(a ``TrainState`` of ``NamedSharding`` for every tensor leaf, ``None``
    for the step counters; the ``TrainState`` of ``ShapeDtypeStruct`` it
    places): the port's state, {parameter name: leaf}, laid out by
    ``spec_for`` on each leaf's shape."""
    axes, structs = param_axes_and_structs(cfg)
    placed = {k: NamedSharding(mesh, spec_for(axes[k], rules, mesh, s.shape))
              for k, s in structs.items()}
    moments = {k: ShapeDtypeStruct(s.shape, torch.float32)
               for k, s in structs.items()}
    return (TrainState(params=placed, opt_state=AdamWState(
                step=None, mu=placed, nu=placed), step=None),
            TrainState(params=structs, opt_state=AdamWState(
                step=0, mu=moments, nu=dict(moments)), step=0))


def elastic_restore(ckpt_root: str, cfg, action: ReMesh, *, lr=3e-4,
                    rules=TRAIN_RULES, step: int | None = None,
                    devices=None):
    """→ (the state restored onto the new mesh, the train step for that
    mesh, the mesh)."""
    mesh = action.mesh(devices)
    shardings, structs = state_shardings(cfg, mesh, rules)
    state, _ = CheckpointManager(ckpt_root).restore(structs, step=step,
                                                    shardings=shardings)
    step_fn, _ = make_train_step(cfg, lr=lr)

    def sharded_step(st, batch):
        with shard_ctx(rules, mesh):
            return step_fn(st, batch)

    return state, sharded_step, mesh
