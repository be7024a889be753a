"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 (+ llama4 shared expert), early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]

At full width its experts alone take about 190 GB, more than one card
holds; the port runs it at smoke size only.
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=202048,
        num_experts=16,
        top_k=1,
        moe_d_ff=8192,
        shared_expert=True,
        rope_style="1d",
        rope_theta=500000.0,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, d_model=128, num_heads=4, num_kv_heads=2, d_ff=256,
        moe_d_ff=256, vocab_size=512, num_experts=4, top_k=1, dtype="float32",
    )
