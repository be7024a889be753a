"""qwen1.5-0.5b [dense]: 24L d_model=1024 16H (GQA kv=16) d_ff=2816
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-0.5B]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=2816,
        vocab_size=151936,
        rope_style="1d",
        qkv_bias=True,
        source="hf:Qwen/Qwen1.5-0.5B",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
        vocab_size=512, dtype="float32",
    )
