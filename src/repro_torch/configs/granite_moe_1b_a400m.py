"""granite-moe-1b-a400m [moe]: 24L d_model=1024 16H (GQA kv=8) d_ff=512
vocab=49155, MoE 32 experts top-8.  [hf:ibm-granite/granite-3.0-1b-a400m-base]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m",
        family="moe",
        num_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=8,
        d_ff=512,
        vocab_size=49155,
        num_experts=32,
        top_k=8,
        moe_d_ff=512,
        rope_style="1d",
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=64,
        moe_d_ff=64, vocab_size=512, num_experts=4, top_k=2, dtype="float32",
    )
