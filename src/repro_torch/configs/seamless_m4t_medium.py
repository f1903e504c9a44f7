"""SeamlessM4T-medium backbone — enc-dec, multimodal [arXiv:2308.11596].

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206.  The audio frontend is
a stub per the assignment: input_specs() provides precomputed frame
embeddings for the encoder; decode shapes run on the decoder with
cross-attention to the encoder output.
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "seamless-m4t-medium"


def config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID, family="audio",
        n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
        vocab=256206, enc_dec=True, n_enc_layers=12, tie_embeddings=True,
        norm_eps=1e-5,
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke", family="audio",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=4, d_ff=64, vocab=128,
        enc_dec=True, n_enc_layers=2, tie_embeddings=True, dtype="float32",
    )
    base.update(kw)
    return ModelConfig(**base)
