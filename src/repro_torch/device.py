"""Device selection for the port's entry points.

Entry points run on ``cuda`` unless the caller asks for ``cpu``.  Asking for
``cuda`` where no card is present raises: nothing quietly carries on on the
CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but no CUDA device "
                               "is available (pass device='cpu' to run the "
                               "plain PyTorch path)")
        # float32 products stay full float32, as in the JAX reference: TF32
        # keeps ~3 decimal digits and would break parity on float32 configs
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether two devices are one: an index-less "cuda" is the current
    card, so a model built on "cuda" (which lands on cuda:0) matches it."""
    if a.type != b.type:
        return False
    if a.type != "cuda":
        return True
    index = lambda d: torch.cuda.current_device() if d.index is None \
        else d.index
    return index(a) == index(b)
