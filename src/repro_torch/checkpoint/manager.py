"""Async, preemption-safe checkpointing (``repro.checkpoint.manager``).

Layout (one directory per step), the reference's:
  <root>/step_<N>.tmp/        — written first
    manifest.json             — step, tree structure, each leaf's shape and
                                dtype, meta
    <leaf-key>.npy            — one file per leaf, "/" in its key → "__"
  <root>/step_<N>/            — atomic rename commit (crash ⇒ no partial ckpt)

A tree is nested dicts, NamedTuples, lists and tuples over tensors, numpy
arrays and Python numbers; an ``nn.Module`` in it stands for its
parameters, keyed by their names (``params/blocks.0.attn.wq.w``).  The
host copy is taken on the caller's thread, so training may update the
tensors in place while a worker thread writes them; ``wait()`` joins the
writer and raises its error.  numpy holds no bfloat16: such a leaf is
saved as float32 and restored to the dtype its manifest names.
``restore`` puts each tensor on the device of ``like``'s leaf, and loads
a module's parameters into it in place (then refreshes its cached casts,
``recast``).

Over a mesh a leaf is a ``sharding.ShardedArray``: ``save`` writes it
whole, so a mesh checkpoint has the files, names, shapes and dtypes of a
one-device one, and either restores into the other.  ``like`` may hold
``ShapeDtypeStruct`` leaves (a shape and a dtype, no data), and
``restore(like, shardings=...)`` places each leaf by the
``NamedSharding`` at its place in ``shardings`` (``shard_map.device_put``):
a restore onto any mesh, the elastic re-mesh's.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch
from torch import nn

from repro_torch.sharding import shard_map as sm


def _items(node):
    """The children of a tree node as (key, child), or None for a leaf (a
    tensor, a ``ShardedArray``, a struct: anything with a shape)."""
    if hasattr(node, "shape"):
        return None
    if isinstance(node, nn.Module):
        return list(node.named_parameters())
    if isinstance(node, dict):
        return [(str(k), v) for k, v in node.items()]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/b/c": leaf} in the tree's order."""
    items = _items(tree)
    if items is None:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}/{k}" if prefix else k))
    return out


def _structure(tree):
    """A JSON-able skeleton of the tree: containers by type, leaves
    elided."""
    items = _items(tree)
    if items is None:
        return None
    return {"type": type(tree).__name__,
            "children": {k: _structure(v) for k, v in items}}


def _dtype_name(leaf) -> str:
    if isinstance(getattr(leaf, "dtype", None), torch.dtype):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _host(leaf) -> np.ndarray:
    """A host copy the caller may not change under the writer (a sharded
    leaf gathered whole on the host)."""
    if isinstance(leaf, sm.ShardedArray):
        leaf = leaf.full("cpu")
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.array(leaf)


def _rebuild(like, vals: dict, prefix: str = ""):
    """``like``'s structure over the restored leaves ``vals``."""
    if isinstance(like, nn.Module):
        with torch.no_grad():
            for k, p in like.named_parameters():
                p.copy_(vals[f"{prefix}/{k}" if prefix else k])
        if hasattr(like, "recast"):
            like.recast()
        return like
    items = _items(like)
    if items is None:
        return vals[prefix]
    kids = [_rebuild(v, vals, f"{prefix}/{k}" if prefix else k)
            for k, v in items]
    if isinstance(like, dict):
        return dict(zip(like.keys(), kids))
    if hasattr(like, "_fields"):
        return type(like)(*kids)
    return type(like)(kids)


def _as_like(arr: np.ndarray, dtype: str, like):
    """A loaded array as ``like``'s kind of leaf, in the saved dtype: a
    tensor on ``like``'s device, or on the host for a struct."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(device=like.device,
                                        dtype=getattr(torch, dtype))
    if isinstance(getattr(like, "dtype", None), torch.dtype):
        return torch.from_numpy(arr).to(getattr(torch, dtype))
    if isinstance(like, (bool, int, float)):
        return type(like)(arr)
    return arr


class CheckpointManager:
    def __init__(self, root: str | os.PathLike, *, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: list[BaseException] = []

    # ----------------------------------------------------------- save

    def save(self, step: int, state, *, meta: dict | None = None,
             blocking: bool = False):
        """Host copy now, write on a worker thread; returns at once unless
        ``blocking``."""
        self.wait()
        flat = _flatten(state)
        host = {k: _host(v) for k, v in flat.items()}
        manifest = {
            "step": int(step),
            "treedef": json.dumps(_structure(state)),
            "leaves": {k: {"shape": list(host[k].shape),
                           "dtype": _dtype_name(v)}
                       for k, v in flat.items()},
            "meta": meta or {},
        }

        def _write():
            try:
                tmp = self.root / f"step_{step}.tmp"
                final = self.root / f"step_{step}"
                if tmp.exists():
                    shutil.rmtree(tmp)
                tmp.mkdir(parents=True)
                for k, v in host.items():
                    np.save(tmp / (k.replace("/", "__") + ".npy"), v)
                (tmp / "manifest.json").write_text(
                    json.dumps(manifest, indent=1))
                if final.exists():
                    shutil.rmtree(final)
                os.replace(tmp, final)          # atomic commit
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error.append(e)

        if blocking:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error:
            raise self._error.pop()

    def _gc(self):
        for s in self.steps()[:-self.keep]:
            shutil.rmtree(self.root / f"step_{s}", ignore_errors=True)

    # ----------------------------------------------------------- restore

    def steps(self):
        out = []
        for p in self.root.glob("step_*"):
            if p.is_dir() and not p.name.endswith(".tmp"):
                try:
                    out.append(int(p.name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, like, *, step: int | None = None, shardings=None):
        """→ (a tree like ``like`` holding step ``step``'s values (the
        latest by default), the manifest).  ``like`` gives the structure,
        the devices and the modules to load into.  ``shardings``: a tree
        over ``like``'s leaves of ``NamedSharding`` (or ``None``): each
        such leaf comes back a ``ShardedArray`` on its mesh."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step}"
        manifest = json.loads((d / "manifest.json").read_text())
        vals = {}
        for k, leaf in _flatten(like).items():
            arr = np.load(d / (k.replace("/", "__") + ".npy"))
            want = manifest["leaves"].get(k)
            if want is not None and list(arr.shape) != want["shape"]:
                raise ValueError(f"shape mismatch for {k}")
            if (hasattr(leaf, "shape")
                    and tuple(arr.shape) != tuple(leaf.shape)):
                raise ValueError(f"shape mismatch for {k}: saved "
                                 f"{arr.shape}, restoring into "
                                 f"{tuple(leaf.shape)}")
            dtype = want["dtype"] if want is not None else str(arr.dtype)
            vals[k] = _as_like(arr, dtype, leaf)
        if shardings is not None:
            placed = _flatten(shardings)
            vals = {k: sm.device_put(v, placed[k]) for k, v in vals.items()}
        return _rebuild(like, vals), manifest


def save_checkpoint(root, step, state, **kw):
    CheckpointManager(root).save(step, state, blocking=True, **kw)


def restore_checkpoint(root, like, **kw):
    return CheckpointManager(root).restore(like, **kw)
