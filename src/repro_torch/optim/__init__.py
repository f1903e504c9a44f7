"""Optimizers (the counterpart of ``repro.optim``) over dicts of tensors:
AdamW and SGD, learning-rate schedules, and error-feedback int8 gradient
compression."""
from repro_torch.optim.adamw import (
    AdamWState, adamw, apply_updates, clip_by_global_norm, global_norm, sgd,
)
from repro_torch.optim.compression import (
    compress_int8, decompress_int8, decompress_tree, error_feedback_compress,
    init_error_feedback,
)
from repro_torch.optim.schedule import (
    constant_schedule, cosine_schedule, linear_warmup_cosine, wsd_schedule,
)

__all__ = ["AdamWState", "adamw", "sgd", "apply_updates", "global_norm",
           "clip_by_global_norm", "constant_schedule", "cosine_schedule",
           "linear_warmup_cosine", "wsd_schedule", "compress_int8",
           "decompress_int8", "decompress_tree", "error_feedback_compress",
           "init_error_feedback"]
