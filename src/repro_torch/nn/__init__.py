"""Layers and initializers (the counterpart of ``repro.nn``)."""
from repro_torch.nn.init import (
    lecun_normal, normal_init, ones_init, truncated_normal, zeros_init,
)
from repro_torch.nn.layers import (
    Conv1D, Embedding, LayerNorm, Linear, RMSNorm,
)

__all__ = ["lecun_normal", "normal_init", "truncated_normal", "zeros_init",
           "ones_init", "Conv1D", "Linear", "Embedding", "RMSNorm", "LayerNorm"]
