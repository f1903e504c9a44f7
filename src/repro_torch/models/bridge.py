"""Weight bridge: the JAX reference's parameter tree → the port's ``LM``,
and back (``to_reference``).

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
consumed.  ``to_reference`` stacks tensors keyed by the port's names
(parameters, gradients, AdamW moments) into the reference's tree, and
``stack_depth`` says how many stacking axes the reference puts before a
name's leaf.  This module imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM


def _split(name: str):
    """A port name → (the reference's path, the index into its stack)."""
    parts = name.split(".")
    return (tuple(p for p in parts if not p.isdigit()),
            tuple(int(p) for p in parts if p.isdigit()))


def stack_depth(name: str) -> int:
    """How many leading stacking axes the reference's leaf of ``name`` has
    beyond the port's tensor: ``blocks.3.ln1.scale`` is a row of the
    ``(L, d)`` stack, depth 1; a hybrid's ``blocks.1.2.…`` depth 2."""
    return len(_split(name)[1])


def _stacks(cfg: ModelConfig) -> dict:
    """The stacking axes the reference gives each top-level module."""
    if cfg.enc_dec:
        return {"enc_blocks": (cfg.n_enc_layers,),
                "dec_blocks": (cfg.n_layers,)}
    if cfg.hybrid is not None:
        G = cfg.n_layers // cfg.hybrid.attn_every
        return {"blocks": (G, cfg.hybrid.attn_every), "down": (G,),
                "shared": (cfg.hybrid.n_shared_blocks,)}
    return {"blocks": (cfg.n_layers,)}


def to_reference(tensors: dict, cfg: ModelConfig) -> dict:
    """{port name: tensor} → the reference's nested tree of stacked numpy
    arrays (float32 for a bfloat16 tensor, which numpy cannot hold).  Every
    stack must be complete: the config says how deep each one is."""
    stacks = _stacks(cfg)
    groups: dict = {}
    for name, t in tensors.items():
        path, index = _split(name)
        groups.setdefault(path, {})[index] = t.detach().float().cpu() \
            if t.dtype == torch.bfloat16 else t.detach().cpu()
    tree: dict = {}
    for path, rows in groups.items():
        lead = stacks.get(path[0], ())
        if len(rows) != int(np.prod(lead)) or any(
                len(i) != len(lead) or any(a >= n for a, n in zip(i, lead))
                for i in rows):
            raise ValueError(f"{'/'.join(path)}: stack {sorted(rows)} is not "
                             f"the reference's {lead}")
        first = next(iter(rows.values()))
        arr = np.zeros(lead + tuple(first.shape), first.numpy().dtype)
        for index, t in rows.items():
            arr[index] = t.numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = arr
    return tree


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
            path, index = _split(name)
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
