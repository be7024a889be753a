"""deepseek-67b [dense]: 95L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=102400, llama-style architecture.  [arXiv:2401.02954]

About 134 GB in bf16: one card serves it at full width with its depth
cut (``chip_smoke.py`` runs 8 of its 95 layers).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-67b",
        family="dense",
        num_layers=95,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22016,
        vocab_size=102400,
        rope_style="1d",
        source="arXiv:2401.02954",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
        vocab_size=512, dtype="float32",
    )
