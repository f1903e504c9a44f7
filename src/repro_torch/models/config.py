"""Model configuration covering all assigned architecture families.

The same frozen dataclasses as the JAX package's ``repro.models.config``,
field for field, so a config round-trips through the JSON codec of the
serving wire protocol (``dataclasses.asdict`` out, keyword construction in).
Only the dtype table differs: names map to torch dtypes.

``use_pallas`` is kept as a field for that round trip, but nothing in this
package reads it: a tensor's device picks between a hand-written kernel
(CUDA tensors) and its plain PyTorch version (CPU tensors).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    # True → normalize the top-k probabilities to sum to 1 (OLMoE / Mixtral);
    # False → use raw softmax values (Switch-style).
    norm_topk: bool = True


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    d_state: int
    version: int = 1            # 1 = Mamba (falcon-mamba), 2 = Mamba2/SSD (zamba2)
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64           # mamba2 only
    n_groups: int = 1           # mamba2 only (B/C groups)
    dt_rank: int = 0            # mamba1; 0 → ceil(d_model / 16)
    chunk: int = 128            # SSD chunk length


@dataclasses.dataclass(frozen=True)
class HybridCfg:
    """Zamba2-style: SSM backbone with a shared attention+MLP block applied
    every ``attn_every`` layers; ``n_shared_blocks`` parameter sets alternate
    round-robin across applications."""
    attn_every: int = 6
    n_shared_blocks: int = 2
    first_attn_layer: int = 5   # 0-based index of first layer followed by attn


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0           # 0 → d_model // n_heads
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    rope_theta: float = 1e6
    m_rope: bool = False        # Qwen2-VL multimodal RoPE
    m_rope_sections: tuple[int, ...] = (16, 24, 24)
    n_vision_patches: int = 0   # vlm: prefix length of precomputed patch embeds

    sliding_window: Optional[int] = None

    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
    hybrid: Optional[HybridCfg] = None

    # enc-dec (seamless): n_layers = decoder layers
    enc_dec: bool = False
    n_enc_layers: int = 0

    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    use_scan: bool = True
    remat: str = "full"         # none | full
    use_pallas: bool = False    # wire-compatible only; the device picks kernels

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        assert self.ssm is not None and self.ssm.version == 2
        return self.d_inner // self.ssm.headdim

    @property
    def dt_rank(self) -> int:
        assert self.ssm is not None
        return self.ssm.dt_rank or math.ceil(self.d_model / 16)

    @property
    def cdtype(self) -> torch.dtype:
        return DTYPES[self.dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return DTYPES[self.param_dtype]

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded state?"""
        return (self.family in ("ssm", "hybrid")
                or self.sliding_window is not None)
