"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024.
RoPE applied to half the head dim (chatglm 2D-style), GQA.  [arXiv:2406.12793]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="chatglm3-6b",
        family="dense",
        num_layers=28,
        d_model=4096,
        num_heads=32,
        num_kv_heads=2,
        d_ff=13696,
        vocab_size=65024,
        rope_style="2d",
        qkv_bias=True,
        source="arXiv:2406.12793",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
        vocab_size=512, dtype="float32",
    )
