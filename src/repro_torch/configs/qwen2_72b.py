"""Qwen2-72B — dense GQA with QKV bias [arXiv:2407.10671].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen2-72b"


def config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID, family="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
        vocab=152064, qkv_bias=True, rope_theta=1e6,
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=32, n_heads=8, n_kv_heads=2, d_ff=64, vocab=128,
        qkv_bias=True, dtype="float32",
    )
    base.update(kw)
    return ModelConfig(**base)
