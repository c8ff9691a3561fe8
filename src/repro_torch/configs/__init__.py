from .base import SHAPES, ModelConfig, ShapeCell, input_specs, torch_dtype
from .registry import ARCHS, all_configs, get_config, get_smoke_config
