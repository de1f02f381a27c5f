from repro_torch.configs.base import (SHAPES, LayerKind, ModelConfig,
                                      ShapeSpec, torch_dtype)
from repro_torch.configs.registry import ARCHS, ASSIGNED, get_config
