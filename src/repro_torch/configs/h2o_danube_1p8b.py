"""H2O-Danube-1.8B — llama+mistral mix with sliding-window attention
[arXiv:2401.16818].

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000, window 4096.
The bounded window is why this dense arch still runs long_500k decode
(ring-buffer KV of 4096 slots — see models/attention.py).
"""
from repro_torch.models.config import ModelConfig

ARCH_ID = "h2o-danube-1.8b"


def config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID, family="dense",
        n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, d_ff=6912,
        vocab=32000, head_dim=80, rope_theta=1e4, sliding_window=4096,
    )
    base.update(kw)
    return ModelConfig(**base)


def smoke_config(**kw) -> ModelConfig:
    base = dict(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64, vocab=128,
        head_dim=8, sliding_window=8, dtype="float32",
    )
    base.update(kw)
    return ModelConfig(**base)
