"""mamba2-780m [ssm]: 48L d_model=1536 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m",
        family="ssm",
        num_layers=48,
        d_model=1536,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=50280,
        ssm_state=128,
        ssm_head_dim=64,
        rope_style="none",
        source="arXiv:2405.21060",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, vocab_size=512, ssm_state=16,
        ssm_head_dim=32, dtype="float32",
    )
