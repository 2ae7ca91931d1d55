from repro_torch.configs.base import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.configs.registry import (ARCH_IDS, applicable,
                                          get_config, get_shape,
                                          get_smoke_config, shape_variant)

__all__ = ["INPUT_SHAPES", "InputShape", "ModelConfig", "ARCH_IDS",
           "applicable", "get_config", "get_shape", "get_smoke_config",
           "shape_variant"]
