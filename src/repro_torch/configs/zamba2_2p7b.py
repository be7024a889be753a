"""zamba2-2.7b [hybrid]: 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64.  Mamba2 backbone + shared attention block applied
periodically (zamba2 style).  [arXiv:2411.15242]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        family="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        d_ff=10240,
        vocab_size=32000,
        ssm_state=64,
        ssm_head_dim=80,
        attn_every=6,            # shared attn+mlp block every 6th mamba layer
        rope_style="1d",
        source="arXiv:2411.15242",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=4, d_ff=256,
        vocab_size=512, ssm_state=16, ssm_head_dim=32, attn_every=2,
        dtype="float32",
    )
