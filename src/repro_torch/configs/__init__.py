"""Architecture configs of the port (one module per arch) + shape suite."""

from .shapes import SHAPES, ShapeSpec, cache_specs, input_specs, shape_applicable
from .registry import ARCHS, get_config, smoke_config

__all__ = ["ARCHS", "get_config", "smoke_config", "SHAPES", "ShapeSpec",
           "cache_specs", "input_specs", "shape_applicable"]
