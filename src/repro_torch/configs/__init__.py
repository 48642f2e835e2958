from repro_torch.configs.base import (
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    all_configs,
    get_config,
    register,
)

__all__ = [
    "INPUT_SHAPES",
    "InputShape",
    "ModelConfig",
    "all_configs",
    "get_config",
    "register",
]
