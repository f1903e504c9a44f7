"""Falcon-Mamba-7B — pure Mamba1 SSM, attention-free [arXiv:2410.05355].

64L d_model=4096 (attn-free) vocab=65024 ssm_state=16.  Decode state is O(1)
in sequence length (h: d_inner×16 + conv tail) ⇒ long_500k runs; seq_len
enters only through prefill.
"""
from repro_torch.models.config import ModelConfig, SSMCfg

ARCH_ID = "falcon-mamba-7b"


def config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID, family="ssm",
        n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, d_ff=0,
        vocab=65024, tie_embeddings=True,
        ssm=SSMCfg(d_state=16, version=1, expand=2),
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke", family="ssm",
        n_layers=2, d_model=32, n_heads=0, n_kv_heads=0, d_ff=0, vocab=128,
        tie_embeddings=True, dtype="float32",
        ssm=SSMCfg(d_state=4, version=1, expand=2),
    )
    base.update(kw)
    return ModelConfig(**base)
