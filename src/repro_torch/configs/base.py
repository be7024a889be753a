"""Config system: the architecture config record and its registry.

``ModelConfig`` carries the same fields as the JAX package's, so a
configuration reads the same in both; ``torch_dtype`` takes the place of
``jdtype``.  Every architecture of the JAX package: the paper's CIFAR
supernet; the dense models ``qwen1.5-0.5b``, ``chatglm3-6b`` (2d RoPE, 2
KV heads), ``starcoder2-3b`` (sliding window 4096) and ``deepseek-67b``
(too large for one card at full depth); ``mamba2-780m`` (SSM);
``granite-moe-1b-a400m`` (MoE) and ``llama4-scout-17b-a16e`` (MoE with a
shared expert; too large for one card, run at smoke size);
``zamba2-2.7b`` (hybrid: SSM layers and one shared attention block);
``internvl2-1b`` (VLM: a projected prefix of 256 stub patch embeddings
before the tokens) and ``whisper-large-v3`` (audio: a bidirectional
encoder over 1500 stub frame embeddings, and a decoder with cross
attention).  ``InputShape`` and ``SHAPES`` are the four workload points
the dry run (``launch/dryrun.py``) reckons every architecture at, with
the JAX package's numbers.
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


@dataclasses.dataclass(frozen=True)
class InputShape:
    """One of the four assigned (seq_len, global_batch) workload points."""

    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int
    sliding: bool = False  # force the sliding-window attention variant


SHAPES = {
    "train_4k": InputShape("train_4k", "train", 4_096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32_768, 128),
    "long_500k": InputShape("long_500k", "decode", 524_288, 1, sliding=True),
}

# module names of the language models, in the JAX package's order
ARCH_IDS = (
    "whisper_large_v3",
    "llama4_scout_17b_a16e",
    "chatglm3_6b",
    "deepseek_67b",
    "zamba2_2p7b",
    "starcoder2_3b",
    "granite_moe_1b_a400m",
    "qwen1p5_0p5b",
    "internvl2_1b",
    "mamba2_780m",
)

# CLI ids -> module names of the architectures
ARCH_ALIASES = {
    "cifar-supernet": "cifar_supernet",
    "qwen1.5-0.5b": "qwen1p5_0p5b",
    "chatglm3-6b": "chatglm3_6b",
    "starcoder2-3b": "starcoder2_3b",
    "deepseek-67b": "deepseek_67b",
    "mamba2-780m": "mamba2_780m",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "zamba2-2.7b": "zamba2_2p7b",
    "internvl2-1b": "internvl2_1b",
    "whisper-large-v3": "whisper_large_v3",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    """Load ``config()`` (or ``smoke_config()``) from the arch module.
    ``arch`` is a CLI id (``qwen1.5-0.5b``) or a module name
    (``qwen1p5_0p5b``), which the JAX package also resolves (its CLI id
    with ``-`` as ``_`` and ``.`` as ``p``)."""
    mod_name = ARCH_ALIASES.get(arch,
                                arch.replace("-", "_").replace(".", "p"))
    if mod_name not in ARCH_ALIASES.values():
        raise ValueError(f"unknown architecture {arch!r} (known: "
                         f"{sorted(ARCH_ALIASES)})")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.smoke_config() if smoke else mod.config()


def get_shape(name: str) -> InputShape:
    return SHAPES[name]
