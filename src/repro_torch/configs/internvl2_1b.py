"""internvl2-1b [vlm]: 24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655.
InternViT vision encoder + projector are a STUB: ``input_specs`` supplies
precomputed patch embeddings (256 patches) that the LM decoder consumes
(early-fusion prefix).  LM backbone is Qwen2-0.5B-like.  [arXiv:2404.16821]
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-1b",
        family="vlm",
        num_layers=24,
        d_model=896,
        num_heads=14,
        num_kv_heads=2,
        d_ff=4864,
        vocab_size=151655,
        rope_style="1d",
        qkv_bias=True,
        num_prefix=256,          # ViT patch embeddings from the stub frontend
        source="arXiv:2404.16821",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
        vocab_size=512, num_prefix=8, dtype="float32",
    )
