"""Zamba2-2.7B — Mamba2 backbone + shared attention blocks [arXiv:2411.15242].

54L d_model=2560 32H (kv=32) d_ff=10240 vocab=32000 ssm_state=64.
"""
from repro_torch.models.config import HybridCfg, ModelConfig, SSMCfg

ARCH_ID = "zamba2-2.7b"


def config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID, family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
        vocab=32000, head_dim=80, rope_theta=1e4, tie_embeddings=True,
        ssm=SSMCfg(d_state=64, version=2, headdim=64, n_groups=1),
        hybrid=HybridCfg(attn_every=6, n_shared_blocks=2),
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke", family="hybrid",
        n_layers=4, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64, vocab=128,
        head_dim=8, tie_embeddings=True, dtype="float32",
        ssm=SSMCfg(d_state=8, version=2, headdim=8, n_groups=1),
        hybrid=HybridCfg(attn_every=2, n_shared_blocks=2),
    )
    base.update(kw)
    return ModelConfig(**base)
