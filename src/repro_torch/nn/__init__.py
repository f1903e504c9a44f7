"""Layers and initializers (the counterpart of ``repro.nn``)."""
from repro_torch.nn.init import (
    lecun_normal, normal_init, ones_init, truncated_normal, zeros_init,
)
from repro_torch.nn.layers import Embedding, LayerNorm, Linear, RMSNorm

__all__ = ["lecun_normal", "normal_init", "truncated_normal", "zeros_init",
           "ones_init", "Linear", "Embedding", "RMSNorm", "LayerNorm"]
