from repro_torch.models.config import (
    HybridCfg,
    ModelConfig,
    MoECfg,
    SHAPES,
    ShapeCfg,
    SSMCfg,
    applicable_shapes,
)
from repro_torch.models.transformer import LM

__all__ = [
    "ModelConfig",
    "MoECfg",
    "SSMCfg",
    "HybridCfg",
    "ShapeCfg",
    "SHAPES",
    "applicable_shapes",
    "LM",
]
