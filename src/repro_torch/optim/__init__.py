"""Optimizers (the counterpart of ``repro.optim``): AdamW over dicts of
tensors, for the control plane's DNN."""
from repro_torch.optim.adamw import (
    AdamWState, adamw, apply_updates, clip_by_global_norm, global_norm,
)

__all__ = ["AdamWState", "adamw", "apply_updates", "clip_by_global_norm",
           "global_norm"]
