"""Kernel regions: what a cost counter sees of a kernel call.

A kernel's launch goes through ctypes, which PyTorch's dispatcher never
sees, and its plain version on the CPU is a string of small ops that the
card does not run.  So every kernel wrapper is wrapped by ``counted``: when
a cost counter (``repro_torch.launch.cost.CostCounter``) is active, the
call opens a region in it that records the kernel's own ``cost(...)`` at
the call's shapes and hides every op the wrapper runs inside, the kernel's
launch or the plain version alike.  A program therefore counts the same on
the CPU as on the card.  Outside a counter the wrapper runs as it is.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode_stack


class Cost(NamedTuple):
    """FLOPs, HBM bytes and transcendentals of one kernel call."""
    flops: int
    bytes: int
    transcendentals: int = 0


def active_counter():
    """The innermost active dispatch mode that takes kernel regions, or
    None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if hasattr(mode, "kernel_region"):
            return mode
    return None


def counted(name: str, cost_of):
    """Decorate a kernel wrapper: under an active counter its call is a
    region named ``name`` that records ``cost_of(*args, **kwargs)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            counter = active_counter()
            if counter is None:
                return fn(*args, **kwargs)
            with counter.kernel_region(name,
                                       lambda: cost_of(*args, **kwargs)):
                return fn(*args, **kwargs)
        return wrapper
    return wrap


def per_row_list(x, B: int) -> list:
    """A scalar or a (B,)-broadcastable tensor as B Python numbers (a host
    read: cost counting only)."""
    return torch.as_tensor(x).reshape(-1).expand(B).tolist()
