"""Convenience re-export: model registry lives in repro_torch.configs."""

from ..configs.registry import ARCHS, get_config, smoke_config

__all__ = ["ARCHS", "get_config", "smoke_config"]
