"""Sharding rules on DTensor and the compressed cross-pod gradient mean."""

from .sharding import (ShardingRules, constrain, current_rules, param_shardings,
                       use_rules)

__all__ = ["ShardingRules", "constrain", "current_rules", "param_shardings",
           "use_rules"]
