"""Phi-3.5-MoE (42B total / 6.6B active) — 16-expert top-2 MoE
[hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) expert d_ff=6400 vocab=32064, MoE 16e top-2.
"""
from repro_torch.models.config import ModelConfig, MoECfg

ARCH_ID = "phi3.5-moe-42b-a6.6b"


def config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID, family="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=6400,
        vocab=32064, rope_theta=1e4,
        moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=6400, norm_topk=False),
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
        dtype="float32",
        moe=MoECfg(n_experts=4, top_k=2, d_ff_expert=64, norm_topk=False),
    )
    base.update(kw)
    return ModelConfig(**base)
