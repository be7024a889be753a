"""whisper-large-v3 [audio]: enc-dec transformer backbone, conv/mel frontend stubbed.

32L d_model=1280 20H (GQA kv=20) d_ff=5120 vocab=51866.  [arXiv:2212.04356]
The mel-spectrogram + conv feature extractor is a STUB: ``input_specs`` supplies
precomputed frame embeddings (1500 frames, the fixed 30 s Whisper window).
"""
from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="audio",
        num_layers=32,            # decoder layers
        encoder_layers=32,
        d_model=1280,
        num_heads=20,
        num_kv_heads=20,
        d_ff=5120,
        vocab_size=51866,
        rope_style="none",        # whisper uses learned/sinusoidal positions
        qkv_bias=True,
        num_prefix=1500,          # audio frame embeddings from the stub frontend
        source="arXiv:2212.04356",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        num_layers=2, encoder_layers=2, d_model=128, num_heads=4, num_kv_heads=4,
        d_ff=256, vocab_size=512, num_prefix=16, dtype="float32",
    )
