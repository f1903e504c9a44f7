"""Model configuration covering all assigned architecture families.

The same frozen dataclasses as the JAX package's ``repro.models.config``,
field for field, so a config round-trips through the JSON codec of the
serving wire protocol (``dataclasses.asdict`` out, keyword construction in),
and the same dry-run shape cells (``ShapeCfg``, ``SHAPES``,
``applicable_shapes``).  Only the dtype table differs: names map to torch
dtypes.

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

    def n_params(self) -> int:
        """Analytic parameter count (embedding + blocks + head), the
        reference's formula; the control loop's deploy vector reads it."""
        d, L = self.d_model, self.n_layers
        n = self.vocab * d                       # embedding
        if not self.tie_embeddings:
            n += self.vocab * d                  # lm head
        per_layer = 0
        if self.ssm is not None:
            di, N = self.d_inner, self.ssm.d_state
            if self.ssm.version == 1:
                per_layer += d * 2 * di                       # in_proj
                per_layer += self.ssm.d_conv * di             # conv
                per_layer += di * (self.dt_rank + 2 * N)      # x_proj
                per_layer += self.dt_rank * di + di           # dt_proj
                per_layer += di * N + 2 * di                  # A, D, etc
                per_layer += di * d                           # out_proj
            else:
                H, G = self.ssm_heads, self.ssm.n_groups
                per_layer += d * (2 * di + 2 * G * N + H)     # in_proj
                per_layer += self.ssm.d_conv * (di + 2 * G * N)
                per_layer += 2 * H + di                       # A_log, dt_bias, D
                per_layer += di * d                           # out_proj
            per_layer += d                                    # norm
        attn_params = 0
        if self.n_heads and self.family != "ssm":
            hd = self.hd
            attn_params = d * (self.n_heads * hd) * 2         # q, o
            attn_params += d * (self.n_kv_heads * hd) * 2     # k, v
        if self.family in ("dense", "vlm", "moe", "audio"):
            per_layer += attn_params + 2 * d                  # + norms
            if self.moe is not None:
                per_layer += d * self.moe.n_experts           # router
                per_layer += self.moe.n_experts * 3 * d * self.moe.d_ff_expert
            else:
                per_layer += 3 * d * self.d_ff
        n += L * per_layer
        if self.hybrid is not None:
            n_apps = self.hybrid.n_shared_blocks
            d2 = 2 * d
            shared = d2 * (self.n_heads * self.hd) * 2
            shared += d2 * (self.n_kv_heads * self.hd) * 2
            shared += 3 * d2 * self.d_ff + self.d_ff * 0
            shared += d2 * d                                  # down proj to d
            n += n_apps * shared
        if self.enc_dec:
            # encoder layers: self-attn + mlp
            enc = (attn_params + 3 * 0 + 2 * d * self.d_ff + d * self.d_ff
                   + 2 * d)
            # decoder adds cross-attn per layer
            n += self.n_enc_layers * enc + L * attn_params
        return int(n)

    def active_params(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.moe is None:
            return self.n_params()
        d, L = self.d_model, self.n_layers
        dense = self.n_params() - L * self.moe.n_experts * 3 * d * self.moe.d_ff_expert
        return int(dense + L * self.moe.top_k * 3 * d * self.moe.d_ff_expert)


@dataclasses.dataclass(frozen=True)
class ShapeCfg:
    """One assigned input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str        # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeCfg("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCfg("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCfg("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCfg("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """Which of the four assigned shapes run for this arch.

    long_500k requires sub-quadratic attention (SSM/hybrid/SWA); pure
    full-attention archs skip it per the assignment rule."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return out
