"""Architecture configs of the port (one module per arch)."""

from .registry import ARCHS, get_config, smoke_config

__all__ = ["ARCHS", "get_config", "smoke_config"]
