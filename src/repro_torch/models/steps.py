"""Step functions: train, prefill and decode (``repro.models.steps``).

Each ``make_*`` returns a plain function whose ``params`` is the ``LM``
module.  Nothing is jitted.  The serve steps run eagerly under
``torch.no_grad`` and update the cache in place.

The train step differentiates the model's train route (``LM.forward(...,
train=True)``: no kernel runs, and every weight is cast inside the
autograd graph), as the reference's jitted step differentiates its plain
path.  Its state holds the model, whose parameters are the float32
masters, and AdamW's moments keyed by parameter name; the step updates
them in place, where the reference's jit donates the old state, and
leaves the model's compute-dtype copies fresh (``LM.recast``) for serving.

Over a mesh (every family) the state's parameters and moments are
{name: ``ShardedArray``} laid out by the rules of the shard context the
step runs under (``TRAIN_RULES``: FSDP over "data" on each weight's
"embed" dim, tensor parallelism over "model"), and the step is the
partition that layout implies, written shard by shard
(``sharding.shard_map``): each input the family takes is split over the
batch axes; each position casts its blocks to the compute dtype (the
reference's ``cast_params_sharded``), all-gathers them over "data" (whose
backward reduce-scatters their gradients), runs its heads, columns, SSM
channels or heads and vocabulary range, and psums over "model"; the loss
is the token-weighted mean over the batch axes; each leaf's gradient is
psummed over the axes it is replicated on; the global norm counts each
distinct block once, and AdamW updates each block in place.
Under ``cfg.remat`` ("full", the default) each layer, or hybrid group,
of the train route is one checkpoint (``transformer.remat``): it keeps its
input alone and runs again, collectives included, in the backward.

The serve steps have one route over a mesh.  Under
``shard_ctx(serve_rules(B), mesh)`` the prefill and decode of every family
run the partition the rules lay out, shard by shard, over weights laid
out by ``serve_shardings`` ({name: ``ShardedArray``}; an ``LM`` given
under the context is laid out so once, as views, and the layout kept for
later steps): tokens, patches and frames split over the batch axes, the
vocabulary-parallel embedding and readout, each "model" rank's heads (K4
on them at prefill), MLP columns and rows, experts, Mamba1 channels or
Mamba2 heads (K7 on them at prefill), a psum over "model" after each;
decode over every cache layout the rules give — the sequence over
"model" (split-K), the KV heads over "model" or neither (K1's write
instance on the rank's heads), the paged pool (K5's), one index for every
row or one a row — and cross attention over the rank's KV heads of the
encoder output; the logits come back whole, every cache leaf laid out by
``cache_axes`` (``cache_specs``), the index and block table whole.  The
fused-decode, verify and chunked-prefill steps run on one device: under a
shard context they raise.
The axes helpers (``input_sharding_axes``, ``params_axes_and_structs``,
``train_state_axes``, ``cache_axes``) give the reference's trees of logical
axes, and the struct helpers (``cache_structs``, ``input_structs``) its
trees of ``ShapeDtypeStruct``, from a model built on the ``meta`` device:
nothing is allocated, the 72B config included.
"""
from __future__ import annotations

import copy
import functools
import weakref
from typing import NamedTuple

import torch
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.bridge import _split, _stacks, stack_depth
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import LM, map_spec
from repro_torch.optim import AdamWState, adamw, global_norm
from repro_torch.optim.adamw import global_norm_blocks, update_blocks
from repro_torch.sharding import current_ctx, spec_for, tree_specs
from repro_torch.sharding import shard_map as sm


class ShapeDtypeStruct(NamedTuple):
    """``jax.ShapeDtypeStruct``: a shape and a dtype, no data."""
    shape: tuple
    dtype: torch.dtype


class TrainState(NamedTuple):
    params: object      # the LM (its parameters are the masters), or over
                        # a mesh {parameter name: ShardedArray}
    opt_state: object   # AdamWState, moments keyed by parameter name
    step: int


def _ce_terms(logits, labels, ignore_id: int):
    """(sum of -log p(label), count) over the labels that are not
    ``ignore_id``, in float32."""
    logits = logits.float()
    keep = labels != ignore_id
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1,
                      torch.where(keep, labels, 0).long()[..., None])[..., 0]
    mask = keep.float()
    return ((logz - ll) * mask).sum(), mask.sum()


def cross_entropy(logits, labels, ignore_id: int = -1):
    """logits: (B, S, V); labels: (B, S) → the mean CE over labels that
    are not ``ignore_id``, in float32."""
    num, den = _ce_terms(logits, labels, ignore_id)
    return num / torch.clamp(den, min=1.0)


CE_CHUNK = 1024


def chunked_cross_entropy(params: LM, h, labels, cfg: ModelConfig, *,
                          ignore_id: int = -1, chunk: int = CE_CHUNK):
    """CE from the final-norm hidden states with the logits made one
    sequence chunk at a time, so the (B, S, V) float32 logits never exist
    whole; the same value as ``cross_entropy(params._logits(h))``.  S must
    be a multiple of ``chunk``."""
    terms = [_ce_terms(params._logits(h[:, i:i + chunk], train=True),
                       labels[:, i:i + chunk], ignore_id)
             for i in range(0, h.shape[1], chunk)]
    num, den = (torch.stack(t).sum() for t in zip(*terms))
    return num / torch.clamp(den, min=1.0)


def model_inputs(cfg: ModelConfig, batch: int, seq: int, *,
                 with_labels: bool):
    """The inputs of one step as {name: (shape, dtype)}, family-aware."""
    specs = {"tokens": ((batch, seq), torch.int32)}
    if cfg.family == "vlm" and seq > 1:
        specs["patches"] = ((batch, cfg.n_vision_patches, cfg.d_model),
                            cfg.cdtype)
    if cfg.enc_dec:
        specs["frames"] = ((batch, seq, cfg.d_model), cfg.cdtype)
    if with_labels:
        specs["labels"] = ((batch, seq), torch.int32)
    return specs


def input_sharding_axes(cfg: ModelConfig, *, with_labels: bool):
    """Logical axes of a step's inputs, family-aware."""
    axes = {"tokens": ("batch", "seq")}
    if cfg.family == "vlm":
        axes["patches"] = ("batch", None, "embed_act")
    if cfg.enc_dec:
        axes["frames"] = ("batch", "seq", "embed_act")
    if with_labels:
        axes["labels"] = ("batch", "seq")
    return axes


# the logical axes of each module's parameters, as the reference's
# ``init``s return them; a module's table claims its children's parameters
# (Mamba2's norm is "d_inner", every other norm "embed_act")
_ATTN = {"wq.w": ("embed", "heads"), "wq.b": ("heads",),
         "wk.w": ("embed", "kv_heads"), "wk.b": ("kv_heads",),
         "wv.w": ("embed", "kv_heads"), "wv.b": ("kv_heads",),
         "wo.w": ("heads", "embed")}
_NORM = {"scale": ("embed_act",), "bias": ("embed_act",)}
_PARAM_AXES = {
    "LM": {"embed.table": ("vocab", "embed"), "lm_head.w": ("embed", "vocab"),
           "down.w": ("embed", "embed")},
    "Attention": _ATTN,
    "SwiGLU": {"gate.w": ("embed", "ff"), "up.w": ("embed", "ff"),
               "down.w": ("ff", "embed")},
    "MoE": {"router.w": ("embed", "experts"),
            "gate": ("experts", "embed", "expert_ff"),
            "up": ("experts", "embed", "expert_ff"),
            "down": ("experts", "expert_ff", "embed")},
    "Mamba1": {"in_proj.w": ("embed", "d_inner"),
               "conv.w": (None, None, "d_inner"), "conv.b": ("d_inner",),
               "x_proj.w": ("d_inner", None), "dt_proj.w": (None, "d_inner"),
               "dt_proj.b": ("d_inner",), "A_log": ("d_inner", "d_state"),
               "D": ("d_inner",), "out_proj.w": ("d_inner", "embed")},
    "Mamba2": {"in_proj.w": ("embed", "d_inner"),
               "conv.w": (None, None, "d_inner"), "conv.b": ("d_inner",),
               "A_log": (None,), "dt_bias": (None,), "D": (None,),
               "norm.scale": ("d_inner",), "out_proj.w": ("d_inner", "embed")},
    "RMSNorm": _NORM,
    "LayerNorm": _NORM,
}


def _nest(tree: dict, path: tuple, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _leaf_axes(model: LM) -> dict:
    """{parameter name: the logical axes of its (unstacked) leaf}."""
    leaf_axes: dict[str, tuple] = {}
    for prefix, mod in model.named_modules():
        table = _PARAM_AXES.get(type(mod).__name__, {})
        for name, _ in mod.named_parameters():
            full = f"{prefix}.{name}" if prefix else name
            key = ".".join(p for p in name.split(".") if not p.isdigit())
            if full not in leaf_axes and key in table:
                leaf_axes[full] = table[key]
    return leaf_axes


def param_axes_and_structs(cfg: ModelConfig):
    """({parameter name: logical axes}, {parameter name:
    ``ShapeDtypeStruct``}) of the port's own leaves, one a layer, from a
    model built on the ``meta`` device: the layout a mesh state takes."""
    model = LM(cfg, device="meta")
    return _leaf_axes(model), {k: ShapeDtypeStruct(tuple(p.shape), p.dtype)
                               for k, p in model.named_parameters()}


def params_axes_and_structs(cfg: ModelConfig):
    """(logical-axes tree, ``ShapeDtypeStruct`` tree) of the reference's
    parameter tree — its stacked leaves, ``"layers"`` once per stacking
    axis — from a model built on the ``meta`` device."""
    model = LM(cfg, device="meta")
    leaf_axes = _leaf_axes(model)
    stacks = _stacks(cfg)
    axes: dict = {}
    structs: dict = {}
    for name, p in model.named_parameters():
        if name not in leaf_axes:
            raise KeyError(f"no logical axes for parameter {name}")
        path, _ = _split(name)
        lead = stacks.get(path[0], ())
        _nest(axes, path, ("layers",) * len(lead) + leaf_axes[name])
        _nest(structs, path, ShapeDtypeStruct(lead + tuple(p.shape), p.dtype))
    return axes, structs


def train_state_axes(cfg: ModelConfig):
    """Logical-axes tree mirroring the reference's TrainState (params and
    AdamW moments)."""
    params_axes, _ = params_axes_and_structs(cfg)
    return TrainState(
        params=params_axes,
        opt_state=AdamWState(step=(), mu=params_axes, nu=params_axes),
        step=())


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def decay_mask(name: str, p: torch.Tensor) -> bool:
    """The reference's AdamW mask, ``ndim >= 2`` on its stacked leaves: a
    layer's norm scale or bias, ``(L, d)`` there, is decayed; the final
    norm's ``(d,)`` is not."""
    return p.ndim + stack_depth(name) >= 2


class _TrainLoss(nn.Module):
    """The reference's ``loss_fn`` as a module over the LM, so that one
    ``functional_call`` puts the cast parameters under the forward and the
    chunked readout alike."""

    def __init__(self, model: LM):
        super().__init__()
        self.lm = model

    def forward(self, batch):
        cfg = self.lm.cfg
        labels = batch["labels"]
        S = labels.shape[1]
        if S > CE_CHUNK and S % CE_CHUNK == 0:
            h, aux = self.lm(batch, train=True, return_hidden=True)
            ce = chunked_cross_entropy(self.lm, h, labels, cfg,
                                       chunk=CE_CHUNK)
        else:
            logits, aux = self.lm(batch, train=True)
            ce = cross_entropy(logits, labels)
        loss = ce
        if cfg.moe is not None:
            loss = (loss + cfg.moe.router_aux_coef * aux["lb_loss"]
                    + cfg.moe.router_z_coef * aux["z_loss"])
        return loss, (ce, aux)


def loss_and_grads(model: LM, batch):
    """((loss, (ce, aux)), {name: gradient}) at the model's parameters, as
    ``jax.value_and_grad(loss_fn, has_aux=True)`` gives them in the
    reference's step.  When the compute dtype differs from float32, every
    float32 master is cast to it inside the graph first (the reference's
    ``cast_params_sharded``): the embedding table, norm scales and SSM
    leaves too, not only the matrices."""
    cdtype = model.cfg.cdtype
    leaves = {k: p.detach().requires_grad_()
              for k, p in model.named_parameters()}
    cast = {"lm." + k: (p.to(cdtype) if p.dtype == torch.float32 else p)
            for k, p in leaves.items()}
    with torch.enable_grad():
        loss, (ce, aux) = torch.func.functional_call(
            _TrainLoss(model), cast, (batch,))
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
    grads = {k: torch.zeros_like(p) if g is None else g
             for (k, p), g in zip(leaves.items(), grads)}
    return (loss.detach(), (ce.detach(), {k: v.detach() for k, v in
                                          aux.items()})), grads


# ---------------------------------------------------------------------------
# train over a mesh
# ---------------------------------------------------------------------------

class MeshParams:
    """A mesh train step's parameters as the model's ``forward_mesh``
    reads them.  Each position holds one autograd leaf over each of its
    blocks (``leaves``); ``self(name, keep)`` is that block cast to the
    compute dtype where it is a float32 master (the reference's
    ``cast_params_sharded``: the gathers move the compute dtype), then
    all-gathered over every mesh axis its spec splits it on except
    ``keep``: ``("model",)``, the default, undoes FSDP alone, ``()``
    gives each position the whole leaf.  Each gather is one
    ``all_gather``, whose backward reduce-scatters the gradient (none over
    axes of one position); each (name, keep) is gathered once a step, or
    once a checkpointed block under ``remat`` (``scoped``).
    ``sub(prefix)`` is the view a submodule reads.  The serve steps pass
    ``cdtype=None`` (the weights as laid out, cast where they are used)
    and ``grad=False``."""

    def __init__(self, params: dict, mesh, cdtype, *, grad: bool = True,
                 remat: bool = False):
        self.mesh = mesh
        self.prefix = ""
        self.specs = {k: a.spec for k, a in params.items()}
        self.leaves = {k: {p: b.detach().requires_grad_(grad)
                           for p, b in a.blocks.items()}
                       for k, a in params.items()}
        self._cdtype = cdtype
        self.remat = remat
        self._memo: dict = {}

    def sub(self, prefix: str) -> "MeshParams":
        view = copy.copy(self)
        view.prefix = f"{self.prefix}{prefix}."
        return view

    def scoped(self, prefix: str | None = None) -> "MeshParams":
        """``sub(prefix)`` (or this view) with a memo of its own, under
        ``remat``: a checkpointed block gathers its weights inside, so that
        they are freed after its forward and gathered again in its
        recompute, where the reference's recompute gathers them again."""
        view = copy.copy(self) if prefix is None else self.sub(prefix)
        if self.remat:
            view._memo = {}
        return view

    def axes(self, name: str, dim: int) -> tuple:
        """The mesh axes splitting dim ``dim`` of leaf ``name``."""
        spec = self.specs[self.prefix + name]
        return sm.axes_of(spec[dim] if dim < len(spec) else None)

    def struct(self, name: str) -> ShapeDtypeStruct:
        """Leaf ``name``'s whole shape and the dtype its gathers move."""
        blk = next(iter(self.leaves[self.prefix + name].values()))
        dt = (self._cdtype if self._cdtype is not None
              and blk.dtype == torch.float32 else blk.dtype)
        return ShapeDtypeStruct(tuple(
            n * sm.axis_size(self.mesh, self.axes(name, d))
            for d, n in enumerate(blk.shape)), dt)

    def __call__(self, name: str, keep=("model",)) -> dict:
        name = self.prefix + name
        key = (name, tuple(keep))
        if key not in self._memo:
            cast = lambda t: (t.to(self._cdtype) if self._cdtype is not None
                              and t.dtype == torch.float32 else t)
            vals = {p: cast(t) for p, t in self.leaves[name].items()}
            for d, entry in enumerate(self.specs[name]):
                axes = sm.axes_of(entry)
                if sm.axis_size(self.mesh, axes) > 1 and not set(
                        axes) <= set(keep):
                    if set(axes) & set(keep):
                        raise ValueError(f"{name}: dim {d} splits over "
                                         f"{axes}; cannot keep {keep} alone")
                    vals = sm.all_gather(vals, axes, self.mesh, dim=d)
            self._memo[key] = vals
        return self._memo[key]


def _mesh_ce_terms(model: LM, w: MeshParams, h: dict, labels: dict,
                   ignore_id: int = -1):
    """Per position (Σ -log p(label), count) over the batch shard's labels
    that are not ``ignore_id``, from vocab-split logits: ``pmax`` and
    ``psum`` over the vocabulary's axes give the log-sum-exp, and the
    label's logit comes from the rank that owns it.  The logits are made
    one sequence chunk at a time where the one-device step chunks them."""
    mesh = w.mesh
    S = next(iter(labels.values())).shape[1]
    chunk = CE_CHUNK if S > CE_CHUNK and S % CE_CHUNK == 0 else S
    num = {p: 0.0 for p in labels}
    den = {p: 0.0 for p in labels}
    for i in range(0, S, chunk):
        logits, start, vocab = model.logits_mesh(
            w, {p: x[:, i:i + chunk] for p, x in h.items()})
        lab = {p: t[:, i:i + chunk] for p, t in labels.items()}
        top = {p: t.detach().amax(dim=-1) for p, t in logits.items()}
        ll = {}
        for p, t in logits.items():
            idx = torch.where(lab[p] != ignore_id, lab[p], 0).long() - start[p]
            own = (idx >= 0) & (idx < t.shape[-1])
            picked = torch.gather(t, -1, idx.clamp(0, t.shape[-1] - 1)[
                ..., None])[..., 0]
            ll[p] = torch.where(own, picked, 0.0)
        if vocab:
            top = sm.pmax(top, vocab, mesh)
        se = {p: torch.exp(t - top[p][..., None]).sum(dim=-1)
              for p, t in logits.items()}
        if vocab:
            se, ll = sm.psum(se, vocab, mesh), sm.psum(ll, vocab, mesh)
        for p in labels:
            keep = (lab[p] != ignore_id).float()
            logz = top[p] + torch.log(se[p])
            num[p] = num[p] + ((logz - ll[p]) * keep).sum()
            den[p] = den[p] + keep.sum()
    return num, den


def _mesh_train_step(model: LM, state: TrainState, batch, opt_update,
                     grad_clip: float):
    """The train step over the shard context's mesh (module docstring)."""
    ctx = current_ctx()
    if ctx is None:
        raise ValueError("a sharded train state steps under the shard "
                         "context (rules, mesh) it is laid out on")
    rules, mesh = ctx
    cfg = model.cfg
    inputs, batch_axes = _mesh_inputs(cfg, batch, rules, mesh)
    w = MeshParams(state.params, mesh, cfg.cdtype,
                   remat=cfg.remat != "none")
    first = sm.positions(mesh)[0]
    labels = inputs.pop("labels")
    with torch.enable_grad():
        h, aux = model.forward_mesh(w, inputs, batch_axes)
        num, den = _mesh_ce_terms(model, w, h, labels)
        ce = sm.token_mean(num, den, batch_axes, mesh)[first]
        loss = ce
        if cfg.moe is not None:
            loss = (loss + cfg.moe.router_aux_coef * aux["lb_loss"]
                    + cfg.moe.router_z_coef * aux["z_loss"])
        flat = [(k, p, t) for k, d in w.leaves.items() for p, t in d.items()]
        got = torch.autograd.grad(loss, [t for *_, t in flat],
                                  allow_unused=True)
    specs = w.specs
    del h, w        # the gathered weights go before the update
    grads: dict = {}
    for (k, p, t), g in zip(flat, got):
        grads.setdefault(k, {})[p] = torch.zeros_like(t) if g is None else g
    del flat, got
    with torch.no_grad():
        for k, spec in specs.items():
            rep = sm.replicated_axes(spec, mesh)
            if rep:
                grads[k] = sm.psum(grads[k], rep, mesh)
        gnorm = global_norm_blocks(grads, specs, mesh)
        scale = {p: torch.clamp(grad_clip / (n + 1e-9), max=1.0)
                 for p, n in gnorm.items()}
        opt = update_blocks(opt_update, grads, state.opt_state, state.params,
                            scale)
    metrics = {"loss": loss.detach(), "ce": ce.detach(),
               "grad_norm": gnorm[first], "lb_loss": aux["lb_loss"].detach(),
               "drop_frac": aux["drop_frac"].detach()}
    return TrainState(state.params, opt, state.step + 1), metrics


def make_train_step(cfg: ModelConfig, *, lr=3e-4, weight_decay: float = 0.1,
                    grad_clip: float = 1.0):
    """→ (train_step, (opt_init, opt_update)).  ``train_step(state, batch)
    → (state, metrics)``: the loss and its gradients, clipped by their
    global norm, then AdamW with the reference's decay mask, one leaf at a
    time so that no second copy of the gradients or moments is held.
    ``batch`` is {"tokens", "labels"} plus the family's extras, on the
    model's device; metrics are 0-d tensors ``loss``, ``ce``,
    ``grad_norm``, ``lb_loss``, ``drop_frac``.  A state whose parameters
    are sharded (``device_put`` by ``launch.elastic.state_shardings``)
    steps over the mesh of the shard context the call runs under, with
    the whole batch given (it is split over the batch axes here)."""
    opt_init, opt_update = adamw(lr, weight_decay=weight_decay,
                                 mask=decay_mask)

    def train_step(state: TrainState, batch):
        if not isinstance(state.params, LM):
            return _mesh_train_step(meta_model(cfg), state, batch,
                                    opt_update, grad_clip)
        model = state.params
        (loss, (ce, aux)), grads = loss_and_grads(model, batch)
        gnorm = global_norm(grads)
        scale = torch.clamp(grad_clip / (gnorm + 1e-9), max=1.0)
        opt = state.opt_state
        mu, nu = dict(opt.mu), dict(opt.nu)
        with torch.no_grad():
            for k, p in model.named_parameters():
                g = grads.pop(k)
                g = (g.float() * scale).to(g.dtype)
                upd, new = opt_update({k: g}, AdamWState(
                    opt.step, {k: mu[k]}, {k: nu[k]}), {k: p})
                mu[k], nu[k] = new.mu[k], new.nu[k]
                p.add_(upd[k].to(p.dtype))
        model.recast()
        metrics = {"loss": loss, "ce": ce, "grad_norm": gnorm,
                   "lb_loss": aux["lb_loss"], "drop_frac": aux["drop_frac"]}
        return TrainState(model, AdamWState(opt.step + 1, mu, nu),
                          state.step + 1), metrics

    return train_step, (opt_init, opt_update)


def init_train_state(seed: int, cfg: ModelConfig, opt_init,
                     device="cuda") -> TrainState:
    """A seeded model (on cuda unless ``device="cpu"``), its optimizer
    state and step 0."""
    model = LM(cfg, device=resolve_device(device), seed=seed)
    return TrainState(params=model,
                      opt_state=opt_init(dict(model.named_parameters())),
                      step=0)


# ---------------------------------------------------------------------------
# serve (prefill + decode)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def meta_model(cfg: ModelConfig) -> LM:
    """The model built on the ``meta`` device: the modules a step over
    laid-out weights runs, with no parameter allocated."""
    return LM(cfg, device="meta")


def serve_shardings(cfg: ModelConfig, mesh, rules) -> dict:
    """{parameter name: ``NamedSharding``}: the layout of the weights the
    serve steps take over ``mesh`` under ``rules`` (``spec_for`` on each
    leaf's shape; ``device_put(model, serve_shardings(...))`` lays an
    ``LM``'s parameters out as {name: ``ShardedArray``}, views on their
    own device)."""
    axes, structs = param_axes_and_structs(cfg)
    return {k: sm.NamedSharding(mesh, spec_for(axes[k], rules, mesh,
                                               s.shape))
            for k, s in structs.items()}


def _serve_ctx():
    ctx = current_ctx()
    if ctx is None:
        raise ValueError("laid-out serve weights step under the shard "
                         "context (rules, mesh) they are laid out on")
    return ctx


def cache_specs(cfg: ModelConfig, shapes, rules, mesh):
    """The cache's tree of specs: ``cache_axes`` through ``spec_for`` at
    each leaf's shape (``shapes``: a tree like the cache's whose leaves
    have a ``shape``, as ``cache_structs`` or a cache itself).  Where
    ``shapes`` has a "block_tbl", the self-attention K/V are block pools,
    ("layers", "cache_blocks", None, "kv_heads", None) as
    ``serving.slots.paged_cache_spec`` lays them out; the index and the
    table take no spec (they stay whole)."""
    axes = cache_axes(cfg, 1, 1)
    if "block_tbl" in shapes:
        axes = map_spec(lambda ax: ax if "cache_seq" not in ax else (
            ax[:ax.index("batch")] + ("cache_blocks", None)
            + ax[ax.index("cache_seq") + 1:]), axes)
    return tree_specs({k: v for k, v in axes.items()
                       if k in shapes and k != "index"}, rules, mesh,
                      shapes_tree=shapes)


def _mesh_inputs(cfg, batch, rules, mesh):
    """({name: {position: its block}} of every input of ``batch``, each
    laid out by ``input_sharding_axes``, the axes splitting the batch)."""
    specs = {k: spec_for(ax, rules, mesh, tuple(batch[k].shape))
             for k, ax in input_sharding_axes(
                 cfg, with_labels=True).items() if k in batch}
    inputs = {k: sm.place(batch[k], spec, mesh).blocks
              for k, spec in specs.items()}
    return inputs, sm.axes_of(specs["tokens"][0]) if specs["tokens"] else ()


def _mesh_prefill(cfg, params: dict, batch, max_seq: int):
    """The prefill over the shard context's mesh (``make_prefill_step``)."""
    rules, mesh = _serve_ctx()
    inputs, batch_axes = _mesh_inputs(cfg, batch, rules, mesh)
    B, S = batch["tokens"].shape
    structs = cache_structs(cfg, B, max_seq)
    if cfg.enc_dec:         # the cross K/V at the encoder's length
        Se = batch["frames"].shape[1]
        structs["cross"] = {n: ShapeDtypeStruct(
            s.shape[:2] + (Se,) + s.shape[3:], s.dtype)
            for n, s in structs["cross"].items()}
    w = MeshParams(params, mesh, None, grad=False)
    logits, cache = meta_model(cfg).prefill_mesh(
        w, inputs, batch_axes, max_seq,
        cache_specs(cfg, structs, rules, mesh))
    first = mesh.devices[sm.positions(mesh)[0]]
    return logits, {"index": torch.tensor(S, dtype=torch.int32,
                                          device=first), **cache}


def _place_cache(cache, specs, mesh):
    """Every leaf of ``cache`` but the index and the block table placed by
    its spec."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out[k] = _place_cache(v, specs[k], mesh)
        else:
            out[k] = (v if k in ("index", "block_tbl")
                      else sm.place(v, specs[k], mesh))
    return out


def _mesh_decode(cfg, params: dict, tokens, cache):
    """The decode over the shard context's mesh (``make_decode_step``)."""
    rules, mesh = _serve_ctx()
    toks, batch_axes = _mesh_inputs(cfg, {"tokens": tokens}, rules, mesh)
    specs = cache_specs(cfg, cache, rules, mesh)
    w = MeshParams(params, mesh, None, grad=False)
    return meta_model(cfg).decode_mesh(w, toks["tokens"],
                                       _place_cache(cache, specs, mesh),
                                       batch_axes, specs)


# an LM's layout under the (mesh, rules) it last stepped under: views of
# its parameters, kept while the model lives
_LAYOUTS: "weakref.WeakKeyDictionary[LM, tuple]" = weakref.WeakKeyDictionary()


def _laid_out(cfg, params):
    """``params`` as the partition takes them under the current shard
    context: an ``LM`` laid out by ``serve_shardings`` (views of its
    parameters, no copy where the mesh's devices are its own), once for a
    mesh and rules a decode loop keeps; laid-out weights as they are."""
    if not isinstance(params, LM):
        return params
    rules, mesh = _serve_ctx()
    held = _LAYOUTS.get(params)
    if (held is None or not sm.same_mesh(held[0], mesh)
            or held[1].rules != rules.rules):
        held = (mesh, rules, sm.device_put(params, serve_shardings(
            cfg, mesh, rules)))
        _LAYOUTS[params] = held
    return held[2]


def make_prefill_step(cfg: ModelConfig, max_seq: int):
    """``prefill_step(params, batch) → (last-position logits, cache)``.
    ``params`` an ``LM``: its ``prefill`` on one device.  Under a shard
    context (``shard_ctx(serve_rules(B), mesh)``) the weights — laid out
    by ``serve_shardings`` ({name: ``ShardedArray``}), or an ``LM`` laid
    out so once (``_laid_out``) — prefill over the mesh shard by shard, as
    the reference's partition under ``serve_rules``: tokens, patches and
    frames split over the batch axes, the vocabulary, heads, MLP columns,
    experts and SSM channels or heads over "model", K4 on each rank's
    heads, K7 on each rank's Mamba2 heads; the logits come back whole, the
    cache as the one-device tree with ``ShardedArray`` leaves laid out by
    ``cache_axes``."""
    @torch.no_grad()
    def prefill_step(params, batch):
        if current_ctx() is None and isinstance(params, LM):
            return params.prefill(batch, max_seq)
        return _mesh_prefill(cfg, _laid_out(cfg, params), batch, max_seq)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``decode_step(params, tokens, cache) → (logits, cache)``.  ``params``
    an ``LM``: its ``decode`` on one device.  Under a shard context the
    weights (an ``LM`` laid out once, as ``make_prefill_step``'s) decode
    over the mesh: the cache's leaves (``ShardedArray``, or whole tensors,
    placed by ``cache_specs``) are written in place, whatever the layout
    the rules give them — the ring's sequence over "model" (split-K), its
    KV heads over "model" or neither, the paged pool of a "block_tbl" —
    with a 0-d index or a (B,) one."""
    @torch.no_grad()
    def decode_step(params, tokens, cache):
        if current_ctx() is None and isinstance(params, LM):
            return params.decode(tokens, cache)
        return _mesh_decode(cfg, _laid_out(cfg, params), tokens, cache)
    return decode_step


def make_verify_step(cfg: ModelConfig):
    """Speculative verify: feed a (B, W) window — per row, the committed
    next input token and up to W-1 draft tokens — through W chained
    ``params.decode`` calls, the same decode the plain tick runs, so the
    logits at lane j equal the plain path's given the same fed prefix.
    Returns the per-lane greedy tokens (B, W) int32, the logits (B, W, V)
    and the cache, advanced W positions for every row; the engine rewinds
    each row to its true position afterwards (``pool.set_index``).  One
    device: under a shard context ``LM.decode`` raises."""
    @torch.no_grad()
    def verify_step(params: LM, tokens, cache):
        lanes = []
        for j in range(tokens.shape[1]):
            logits, cache = params.decode(tokens[:, j:j + 1], cache)
            lanes.append(logits[:, 0])
        logits = torch.stack(lanes, dim=1)                  # (B, W, V)
        toks = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        return toks, logits, cache
    return verify_step


def make_fused_decode_step(cfg: ModelConfig):
    """One decode step with sampling fused into the tail: returns the
    per-row sampled tokens (B,) int32 alongside the logits, so a greedy
    serving tick moves B int32s to the host instead of (B, 1, V) floats.

    seed/rid/pos are (B,) int32 stateless RNG counters; temperature is (B,)
    float32, 0 → greedy argmax (first index of the float32 maximum).  The
    sampler is the fused-sample kernel on the card and its plain version on
    the CPU.  One device: under a shard context ``LM.decode`` raises."""
    @torch.no_grad()
    def fused_decode_step(params: LM, tokens, cache, seed, rid, pos,
                          temperature):
        logits, cache = params.decode(tokens, cache)
        rows = logits[:, 0].float()
        toks = kernel_ops.fused_sample(rows, seed, rid, pos, temperature)
        return toks, logits, cache
    return fused_decode_step


def make_chunked_prefill_step(cfg: ModelConfig, max_seq: int, chunk: int):
    """Prefill with bounded per-step work: a one-shot prefill of the first
    ``chunk`` tokens builds the cache, then the rest of the prompt streams
    through the decode path one token per step.  Produces the same
    (last-position logits, cache) as ``make_prefill_step``.

    An encoder-decoder prefills in one shot (the encoder needs every
    frame); a VLM needs ``chunk > n_vision_patches``, so that the patch
    prefix lands in the one-shot part.  One device: under a shard context
    ``LM.prefill`` raises."""
    if cfg.family == "vlm" and chunk <= cfg.n_vision_patches:
        raise ValueError(
            f"vlm chunked prefill needs chunk > n_vision_patches "
            f"({chunk} <= {cfg.n_vision_patches})")

    @torch.no_grad()
    def chunked_prefill(params: LM, inputs):
        tokens = inputs["tokens"]
        S = tokens.shape[1]
        if S <= chunk or cfg.enc_dec:
            return params.prefill(inputs, max_seq)
        logits, cache = params.prefill({**inputs, "tokens": tokens[:, :chunk]},
                                       max_seq)
        for j in range(chunk, S):
            logits, cache = params.decode(tokens[:, j:j + 1], cache)
        return logits, cache
    return chunked_prefill


def cache_axes(cfg: ModelConfig, batch: int, max_seq: int):
    """Logical-axes tree of the decode cache."""
    return map_spec(lambda s: s[2], LM.cache_spec(cfg, batch, max_seq))


def cache_structs(cfg: ModelConfig, batch: int, max_seq: int):
    """``ShapeDtypeStruct`` tree of the decode cache — no allocation."""
    return map_spec(lambda s: ShapeDtypeStruct(s[0], s[1]),
                    LM.cache_spec(cfg, batch, max_seq))


def input_structs(cfg: ModelConfig, shape):
    """``ShapeDtypeStruct`` stand-ins for one dry-run cell's inputs (no
    allocation): the tokens (and labels, patches, frames) of a train or
    prefill cell; one token and the cache at ``seq_len`` of a decode cell."""
    if shape.kind in ("train", "prefill"):
        t = model_inputs(cfg, shape.global_batch, shape.seq_len,
                         with_labels=shape.kind == "train")
        return {k: ShapeDtypeStruct(s, d) for k, (s, d) in t.items()}
    return {"tokens": ShapeDtypeStruct((shape.global_batch, 1), torch.int32),
            "cache": cache_structs(cfg, shape.global_batch, shape.seq_len)}
