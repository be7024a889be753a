"""Config system: the architecture config record and its registry.

``ModelConfig`` carries the same fields as the JAX package's, so a
configuration reads the same in both; ``torch_dtype`` takes the place of
``jdtype``.  Only the paper's CIFAR supernet is ported so far: any other
architecture name raises.
"""
from __future__ import annotations

import dataclasses
import importlib

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters for every model family in the zoo."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio | cnn
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    # --- attention ---
    head_dim: int = 0               # 0 -> d_model // num_heads
    rope_style: str = "1d"          # 1d | 2d (chatglm) | none
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    sliding_window: int = 8192      # used when a shape requests the sliding variant
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0               # expert hidden size (0 -> d_ff)
    shared_expert: bool = False     # llama4-style always-on shared expert
    capacity_factor: float = 1.25
    # --- SSM (mamba2 / SSD) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    # --- hybrid (zamba2) ---
    attn_every: int = 0             # shared attention block applied every k layers
    # --- encoder-decoder / multimodal frontend stubs ---
    encoder_layers: int = 0
    num_prefix: int = 0             # stub frontend tokens (audio frames / image patches)
    # --- supernet (the paper's technique) ---
    supernet: bool = False
    num_branches: int = 4
    # --- numerics ---
    dtype: str = "bfloat16"
    # --- citation ---
    source: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.num_heads, 1))

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# CLI ids -> module names of the architectures ported so far
ARCH_ALIASES = {
    "cifar-supernet": "cifar_supernet",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    """Load ``config()`` (or ``smoke_config()``) from the arch module."""
    mod_name = ARCH_ALIASES.get(arch)
    if mod_name is None:
        raise ValueError(
            f"architecture {arch!r} is not yet ported to repro_torch "
            f"(ported: {sorted(ARCH_ALIASES)}; the LM/MoE/SSM configs "
            "follow, ROADMAP queue 1: LM/MoE/SSM supernet path)")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke_config() if smoke else mod.config()
