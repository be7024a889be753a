"""starcoder2-3b [dense]: 30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152.  GQA, RoPE, (starcoder2 also ships a 4k sliding window, which we
use for the long_500k shape).  [arXiv:2402.19173]

The port mirrors the JAX package's layers, whose MLP is gated (SwiGLU)
for every dense config, where starcoder2 ships a plain GELU MLP: by
``core/flops.py::model_params`` this config has 4,161,985,536
parameters, not the published model's 3 B.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        d_ff=12288,
        vocab_size=49152,
        rope_style="1d",
        qkv_bias=True,
        sliding_window=4096,
        source="arXiv:2402.19173",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
        vocab_size=512, sliding_window=64, dtype="float32",
    )
