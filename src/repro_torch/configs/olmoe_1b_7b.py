"""OLMoE-1B-7B — 64-expert top-8 MoE [arXiv:2409.02060].

16L d_model=2048 16H (kv=16) expert d_ff=1024 vocab=50304, MoE 64e top-8,
normalized top-k routing.
"""
from repro_torch.models.config import ModelConfig, MoECfg

ARCH_ID = "olmoe-1b-7b"


def config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID, family="moe",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
        vocab=50304, rope_theta=1e4,
        moe=MoECfg(n_experts=64, top_k=8, d_ff_expert=1024, norm_topk=True),
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, d_ff=32, vocab=128,
        dtype="float32",
        moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32, norm_topk=True),
    )
    base.update(kw)
    return ModelConfig(**base)
