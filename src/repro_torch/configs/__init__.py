"""Assigned-architecture registry: ``--arch <id>`` resolves here.

Each module defines ``config()`` (the exact published configuration) and
``smoke_config()`` (a reduced same-family variant for CPU smoke tests).
"""
from repro_torch.configs import (
    falcon_mamba_7b,
    h2o_danube_1p8b,
    olmoe_1b_7b,
    phi3p5_moe_42b,
    qwen2_72b,
    qwen2_vl_7b,
    qwen2p5_3b,
    qwen2p5_14b,
    seamless_m4t_medium,
    zamba2_2p7b,
)

_MODULES = [
    zamba2_2p7b,
    qwen2_vl_7b,
    qwen2p5_3b,
    h2o_danube_1p8b,
    qwen2_72b,
    qwen2p5_14b,
    olmoe_1b_7b,
    phi3p5_moe_42b,
    falcon_mamba_7b,
    seamless_m4t_medium,
]

REGISTRY = {m.ARCH_ID: m.config for m in _MODULES}
SMOKE_REGISTRY = {m.ARCH_ID: m.smoke_config for m in _MODULES}
ARCH_IDS = list(REGISTRY)


def get_config(arch_id: str, **kw):
    return REGISTRY[arch_id](**kw)


def get_smoke_config(arch_id: str, **kw):
    return SMOKE_REGISTRY[arch_id](**kw)
