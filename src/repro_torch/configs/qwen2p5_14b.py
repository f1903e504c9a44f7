"""Qwen2.5-14B — dense GQA with QKV bias [hf:Qwen/Qwen2.5].

48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen2.5-14b"


def config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID, family="dense",
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=13824,
        vocab=152064, qkv_bias=True, rope_theta=1e6,
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=40, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
        qkv_bias=True, head_dim=10, dtype="float32",
    )
    base.update(kw)
    return ModelConfig(**base)
