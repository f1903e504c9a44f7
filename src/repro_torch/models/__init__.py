from repro_torch.models.config import HybridCfg, ModelConfig, MoECfg, SSMCfg
from repro_torch.models.transformer import LM

__all__ = ["ModelConfig", "MoECfg", "SSMCfg", "HybridCfg", "LM"]
