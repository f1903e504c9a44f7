"""Qwen2-VL-7B backbone — M-RoPE, dynamic resolution [arXiv:2409.12191].

28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.  The vision
frontend is a stub per the assignment: input_specs() provides precomputed
patch embeddings; M-RoPE runs on the backbone with a synthetic patch grid.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "qwen2-vl-7b"


def config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID, family="vlm",
        n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
        vocab=152064, qkv_bias=True, rope_theta=1e6,
        m_rope=True, m_rope_sections=(16, 24, 24), n_vision_patches=1024,
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke", family="vlm",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
        qkv_bias=True, m_rope=True, m_rope_sections=(2, 1, 1),
        n_vision_patches=4, dtype="float32",
    )
    base.update(kw)
    return ModelConfig(**base)
