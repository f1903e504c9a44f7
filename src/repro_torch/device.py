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
