"""Checkpointing (``repro.checkpoint``)."""
from repro_torch.checkpoint.manager import (
    CheckpointManager, restore_checkpoint, save_checkpoint,
)

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint"]
