"""Qwen2.5-3B — dense GQA with QKV bias, tied embeddings [hf:Qwen/Qwen2.5].

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen2.5-3b"


def config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID, family="dense",
        n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2, d_ff=11008,
        vocab=151936, qkv_bias=True, rope_theta=1e6, tie_embeddings=True,
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
        qkv_bias=True, tie_embeddings=True, dtype="float32",
    )
    base.update(kw)
    return ModelConfig(**base)
