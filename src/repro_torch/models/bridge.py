"""Weight bridge: the JAX reference's parameter tree → the port's ``LM``.

PyTorch cannot reproduce ``LM.init(jax.random.PRNGKey(seed))``, so parity
tests hand the reference's parameters over as numpy arrays (for example
``jax.tree.map(np.asarray, params)``).  The reference stacks repeated
modules on leading axes; here each is its own module in a ``ModuleList``,
and the list indices of a port name index those axes: ``blocks.<i>.<path>``
loads ``blocks/<path>[i]``, a hybrid's ``blocks.<g>.<i>.<path>`` loads
``blocks/<path>[g, i]`` of the ``(G, A, …)`` stack, ``shared.<s>.<path>``
loads ``shared/<path>[s]``, ``down.<g>.w`` loads ``down/w[g]``, and an
encoder-decoder's ``enc_blocks.<i>.<path>`` and ``dec_blocks.<i>.<path>``
load ``enc_blocks/<path>[i]`` and ``dec_blocks/<path>[i]``.  Every other
parameter keeps its path.  Every leaf of the reference's tree must be
consumed.  This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM


def _leaf(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _count_leaves(tree) -> int:
    if isinstance(tree, dict):
        return sum(_count_leaves(v) for v in tree.values())
    return 1


def from_reference(params_np, cfg: ModelConfig, device="cuda") -> LM:
    """Build the port's model holding the reference's weights, on cuda
    unless ``device="cpu"`` is asked for."""
    model = LM(cfg, device=device)
    used = set()
    with torch.no_grad():
        for name, p in model.named_parameters():
            parts = name.split(".")
            path = tuple(p for p in parts if not p.isdigit())
            index = tuple(int(p) for p in parts if p.isdigit())
            value = np.asarray(_leaf(params_np, path))[index]
            if tuple(value.shape) != tuple(p.shape):
                raise ValueError(f"{name}: reference {value.shape} vs port "
                                 f"{tuple(p.shape)}")
            p.copy_(torch.tensor(value, dtype=p.dtype))
            used.add(path)
    n_ref = _count_leaves(params_np)
    if len(used) != n_ref:
        raise ValueError(f"bridge consumed {len(used)} of the reference's "
                         f"{n_ref} parameter leaves")
    model.recast()
    return model
