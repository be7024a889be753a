"""The paper's own master model: CIFAR CNN supernet (Fig. 3).

Conv stem + 12 choice blocks (4 branches each: identity / residual /
inverted-residual / depthwise-separable) + FC head.  Channels
[64,64,64,128,128,128,256,256,256,512,512,512]; blocks 3, 6, 9 are
reduction blocks (channels double, spatial quartered).  BatchNorm affine
params and moving statistics are DISABLED per the paper (Section IV.C).
"""
from repro_torch.configs.base import ModelConfig

# Output channels of the 12 choice blocks (paper Section IV.C).
CHANNELS = (64, 64, 64, 128, 128, 128, 256, 256, 256, 512, 512, 512)
IMAGE_SIZE = 32
NUM_CLASSES = 10
STEM_CHANNELS = 64


def config() -> ModelConfig:
    return ModelConfig(
        name="cifar-supernet",
        family="cnn",
        num_layers=12,           # choice blocks
        d_model=STEM_CHANNELS,
        num_heads=0,
        num_kv_heads=0,
        d_ff=0,
        vocab_size=NUM_CLASSES,
        supernet=True,
        num_branches=4,
        dtype="float32",
        source="this paper, Fig. 3 / Section IV.C",
    )


def smoke_config() -> ModelConfig:
    # 4 choice blocks, narrow channels — the size of the CPU parity tests
    return config().replace(num_layers=4)


# Reduced channel plan used when num_layers < 12 (smoke / CPU federation).
def channels_for(num_blocks: int):
    if num_blocks == 12:
        return CHANNELS
    plan = []
    c = 16
    for i in range(num_blocks):
        if i > 0 and i % 2 == 0:
            c *= 2
        plan.append(c)
    return tuple(plan)


def stem_channels_for(num_blocks: int) -> int:
    return STEM_CHANNELS if num_blocks == 12 else 16
