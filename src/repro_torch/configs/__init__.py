from repro_torch.configs.base import (
    ARCH_ALIASES,
    ARCH_IDS,
    SHAPES,
    InputShape,
    ModelConfig,
    get_config,
    get_shape,
)

__all__ = [
    "ARCH_ALIASES",
    "ARCH_IDS",
    "SHAPES",
    "InputShape",
    "ModelConfig",
    "get_config",
    "get_shape",
]
