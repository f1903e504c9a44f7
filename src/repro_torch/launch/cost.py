"""FLOPs, bytes and memory of an eager program: the port's counterpart of
``repro.launch.hlo_cost``.

The reference reads XLA's ``cost_analysis()`` from a compiled jit.  The
port has no compiled program, so ``CostCounter`` counts the eager one as it
runs: a ``TorchDispatchMode`` sees every aten op and charges it by shape,
under the conventions of XLA's ``HloCostAnalysis`` so that the numbers
compare with the reference's:

* a matmul-class op (``mm``, ``addmm``, ``bmm``, ``baddbmm``, what
  ``linear``, ``matmul`` and ``einsum`` decompose to) counts 2·M·N·K, a
  convolution 2 a multiply-add;
* an elementwise op counts 1 a output element; ``exp``, ``log``,
  ``rsqrt``, ``tanh``, ``sigmoid`` and the like count under
  ``transcendentals`` instead, and composites their parts (``silu`` one of
  each, ``softmax`` 4 FLOPs and one exp an element);
* a reduction counts 1 a input element;
* copies, gathers, fills and dtype-preserving moves count no FLOP, a dtype
  conversion 1 an element.

Bytes are each op's operand bytes plus its output bytes: the traffic of the
unfused eager program, which is what the card moves.  An operand counts its
distinct elements (a broadcast view's stride-0 axes once); a gather counts
the rows it reads, not its whole source; a copy or fill writes without
reading its destination; an in-place op counts its read and its write.
Views and metadata ops (``view``, ``reshape`` without a copy, ``expand``,
``slice``, ``as_strided``, ``t``) count 0, and so does a copy between
devices (a host transfer, not the device's traffic).

A hand-written kernel is one region (``kernel_region``): its wrapper
records the kernel's own ``cost(...)`` and nothing it runs inside is
counted, whether it launches the kernel or runs the plain version, so a
program counts the same on the CPU as on the card.

There are no collectives on one card: records carry ``collective_bytes``
0.0 and an empty ``collective_detail``; the ring formulas wait for the
multi-device slice.
"""
from __future__ import annotations

import contextlib
import math
from collections import defaultdict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

# ops that return an alias of an input (``OpOverload.is_view`` marks most)
_ALIASES = {aten._unsafe_view, aten.alias, aten.detach, aten.lift_fresh,
            aten._reshape_alias, aten.split, aten.split_with_sizes,
            aten.unbind, aten.chunk}
# ops that allocate without writing
_ALLOCS = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty,
           aten.new_empty_strided, aten._local_scalar_dense, aten.set_}
_MATMULS = {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
# count no FLOP: moves, gathers, scatters, fills, layout changes
_MOVES = {aten.clone, aten.cat, aten.stack, aten.index, aten.index_select,
          aten.gather, aten.embedding, aten.index_put, aten.index_put_,
          aten.scatter, aten.scatter_, aten.index_copy, aten.index_copy_,
          aten.roll, aten.constant_pad_nd, aten.repeat,
          aten.repeat_interleave, aten.flip, aten.zeros, aten.zeros_like,
          aten.ones, aten.ones_like, aten.full, aten.full_like,
          aten.new_zeros, aten.new_ones, aten.new_full, aten.fill,
          aten.fill_, aten.zero_, aten.arange, aten.scalar_tensor,
          aten.slice_scatter, aten.select_scatter, aten.tril, aten.triu}
# gathers read the rows they gather, not their whole source
_GATHERS = {aten.index, aten.index_select, aten.gather, aten.embedding}
# (FLOPs, transcendentals) an output element
_TRANSCENDENTAL = {
    aten.exp: (0, 1), aten.exp_: (0, 1), aten.log: (0, 1), aten.log_: (0, 1),
    aten.log1p: (0, 1), aten.expm1: (0, 1), aten.rsqrt: (0, 1),
    aten.rsqrt_: (0, 1), aten.sqrt: (0, 1), aten.tanh: (0, 1),
    aten.sigmoid: (0, 1), aten.sin: (0, 1), aten.cos: (0, 1),
    aten.erf: (0, 1), aten.silu: (1, 1), aten.silu_: (1, 1), aten.softplus: (1, 2),
    aten.gelu: (7, 1), aten._softmax: (4, 1), aten._log_softmax: (4, 2),
    aten.logsumexp: (3, 1), aten.logaddexp: (1, 2),
}
# two FLOPs an output element
_FUSED_MULTIPLY_ADDS = {aten.addcmul, aten.addcmul_}
# scatters that add: one FLOP an element added
_SCATTER_ADDS = {aten.scatter_add, aten.scatter_add_, aten.index_add,
                 aten.index_add_}
# one FLOP an input element
_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max,
               aten.min, aten.argmax, aten.argmin, aten.prod, aten.any,
               aten.all, aten.cumsum, aten.var, aten.std,
               aten.linalg_vector_norm, aten.norm}
# in-place scatters: they write the rows they address, not all of self
_SCATTERS = {aten.index_put_, aten.index_copy_, aten.scatter_,
             aten.scatter_add_, aten.index_add_}
_LAYER_NORMS = {aten.native_layer_norm}
_SORTS = {aten.sort, aten.topk, aten.argsort}


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def distinct_numel(t: torch.Tensor) -> int:
    """Elements an op reads from ``t``: a stride-0 (broadcast) axis once."""
    return math.prod(n for n, s in zip(t.shape, t.stride()) if s != 0)


def nbytes(t: torch.Tensor) -> int:
    return distinct_numel(t) * t.element_size()


def _matmul_flops(func, args) -> int:
    if func in (aten.mm, aten.addmm):
        a, b = (args[0], args[1]) if func is aten.mm else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    a, b = (args[0], args[1]) if func is aten.bmm else (args[1], args[2])
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _conv_flops(args, out: torch.Tensor) -> int:
    w, groups = args[1], args[8]
    return 2 * out.numel() * (w.shape[1] * math.prod(w.shape[2:]))


class CostCounter(TorchDispatchMode):
    """Counts the FLOPs, transcendentals and bytes of the ops run under
    it (``with CostCounter() as c: step(...)``), and each kernel region's
    cost by kernel (``c.kernels``: name → {"calls", "flops", "bytes",
    "transcendentals"}).  ``c.by_op`` keeps the totals by op."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.transcendentals = 0
        self.bytes = 0
        self.by_op: dict[str, list[int]] = defaultdict(lambda: [0, 0, 0, 0])
        self.kernels: dict[str, dict[str, int]] = {}
        self._hidden = 0

    @contextlib.contextmanager
    def kernel_region(self, name: str, cost_of):
        """Hide every op inside; record ``cost_of()`` (computed inside,
        so that its host reads are hidden too) under ``name``."""
        self._hidden += 1
        try:
            c = cost_of()
            k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                               "bytes": 0,
                                               "transcendentals": 0})
            k["calls"] += 1
            for key, v in zip(("flops", "bytes", "transcendentals"), c):
                k[key] += v
            self._add(f"kernel:{name}", c.flops, c.transcendentals, c.bytes)
            yield
        finally:
            self._hidden -= 1

    def _add(self, name, flops, trans, nbytes_):
        self.flops += flops
        self.transcendentals += trans
        self.bytes += nbytes_
        row = self.by_op[name]
        row[0] += 1
        row[1] += flops
        row[2] += trans
        row[3] += nbytes_

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._hidden:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        packet = func.overloadpacket
        if func.is_view or packet in _ALIASES or packet in _ALLOCS:
            return
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if not outs:
            return
        devices = {t.device for t in ins + outs}
        if len(devices) > 1:                # a host <-> device copy
            return
        flops = trans = 0
        if packet in _MATMULS:
            flops = _matmul_flops(packet, args)
        elif packet is aten.convolution:
            flops = _conv_flops(args, outs[0])
        elif packet in _TRANSCENDENTAL:
            f, t = _TRANSCENDENTAL[packet]
            flops, trans = f * outs[0].numel(), t * outs[0].numel()
        elif packet in _FUSED_MULTIPLY_ADDS:
            flops = 2 * outs[0].numel()
        elif packet in _SCATTER_ADDS:
            flops = ins[-1].numel()
        elif packet in _REDUCTIONS:
            flops = ins[0].numel()
        elif packet in _LAYER_NORMS:      # mean, centre, square, var, scale
            flops = 7 * ins[0].numel()
            trans = outs[1].numel() if len(outs) > 2 else 0
        elif packet in _SORTS:
            n = ins[0].numel()
            flops = n * max(1, math.ceil(math.log2(max(ins[0].shape[-1],
                                                       2))))
        elif packet in (aten._to_copy, aten.copy_, aten.copy):
            src = ins[1] if packet is not aten._to_copy else ins[0]
            flops = outs[0].numel() if src.dtype != outs[0].dtype else 0
        elif packet is aten.pow and not isinstance(args[1], torch.Tensor) \
                and float(args[1]).is_integer():
            flops = outs[0].numel() * max(1, abs(int(args[1])) - 1)
        elif packet is aten.pow:
            trans = outs[0].numel()
        elif packet not in _MOVES:          # elementwise
            flops = outs[0].numel()
        self._add(str(packet), flops, trans, self._bytes(packet, ins, outs))

    @staticmethod
    def _bytes(packet, ins, outs) -> int:
        written = sum(nbytes(t) for t in outs)
        if packet in (aten.copy_, aten.fill_, aten.zero_):
            # the destination is written, not read
            return sum(nbytes(t) for t in ins[1:]) + nbytes(ins[0])
        if packet in _SCATTERS:
            # what goes in is read; the rows it lands on are written (and
            # read first where it adds)
            dest, rest = ins[0], ins[1:]
            rows = distinct_numel(rest[-1]) * dest.element_size()
            return (sum(nbytes(t) for t in rest)
                    + rows * (2 if packet in _SCATTER_ADDS else 1))
        if packet in _GATHERS:
            src, idx = ins[0], ins[1:]
            return sum(nbytes(t) for t in idx) + 2 * written
        return sum(nbytes(t) for t in ins) + written


def cost_summary(counter: CostCounter) -> dict:
    """The counted totals under the reference's key names."""
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "transcendentals": float(counter.transcendentals)}


def tree_bytes(tree) -> int:
    """Bytes of the distinct storages among a tree's tensors."""
    seen, total = set(), 0
    for t in _tensors(tree):
        key = (t.device, t.untyped_storage().data_ptr())
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def weight_bytes(model: torch.nn.Module) -> int:
    """Bytes of the weights a serve step reads: every parameter and buffer,
    a Linear's compute-dtype copy ``w_c`` in place of its ``w`` where the
    two differ."""
    superseded = set()
    for m in model.modules():
        w_c = getattr(m, "w_c", None)
        if isinstance(w_c, torch.Tensor) and w_c.data_ptr() != m.w.data_ptr():
            superseded.add(m.w.data_ptr())
    return tree_bytes([t for t in (*model.parameters(), *model.buffers())
                       if t.data_ptr() not in superseded])


def memory_summary(params, cache, inputs, peak_bytes: int | None) -> dict:
    """The reference's memory keys for one step: ``argument_size_in_bytes``
    the weights the step reads, the cache and the inputs;
    ``temp_size_in_bytes`` the device's peak over the step
    (``torch.cuda.max_memory_allocated`` after a reset) less the arguments,
    0 where there is no peak (the CPU)."""
    args = weight_bytes(params) + tree_bytes(cache) + tree_bytes(inputs)
    temp = 0 if peak_bytes is None else max(0, peak_bytes - args)
    return {"argument_size_in_bytes": int(args),
            "temp_size_in_bytes": int(temp)}
