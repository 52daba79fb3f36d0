"""Architecture configs: one module per assigned architecture."""
from repro_torch.configs.base import (ModelConfig, ShapeConfig, SHAPES,
                                cell_is_applicable)
from repro_torch.configs.registry import ARCH_IDS, get_config
