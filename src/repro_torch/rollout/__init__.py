"""Rollout plane: bounded-disruption updates for template workloads.

The paper's §II critique of imperative CNI wiring is that *any* change
is an outage: reconfiguration tears down and rebuilds the data path.
This package is the declarative answer for the replica-set shape —
spec changes roll through the claim set one bounded step at a time,
node maintenance drains claims without violating disruption budgets,
and bad configs are canaried on a replica subset and rolled back
automatically on SLO regression.

* :mod:`strategy` — pure rollout math: revision hashing and the
  per-reconcile :func:`~repro_torch.rollout.strategy.plan_rollout` step,
  bounded by ``max_surge`` / ``max_unavailable`` at every store state.
* :mod:`budget` — :class:`~repro_torch.api.objects.DisruptionBudget`
  accounting and the voluntary-eviction path every drain/canary
  teardown goes through.
* :mod:`canary` — the CanaryController: overlay a config on a replica
  subset, watch SLO telemetry, promote or roll back byte-identically.
* :mod:`monitor` — a store journal hook asserting the surge /
  availability / budget invariants at every observable store state
  (the chaos tests' always-on witness).

The port's own copy of the JAX package's ``rollout/__init__.py`` (pure
Python; the port imports nothing of that package).
"""

from .budget import (DisruptionBudgetController, disruption_allowed,
                     evict_claim, evict_claim_locked, matching_budgets)
from .canary import CanaryController
from .monitor import RolloutMonitor, RolloutViolation
from .strategy import (RolloutPlan, claim_ready, claim_revision,
                       desired_revisions, plan_rollout, revision_hash)

__all__ = [
    "RolloutPlan", "claim_ready", "claim_revision", "desired_revisions",
    "plan_rollout", "revision_hash",
    "DisruptionBudgetController", "disruption_allowed", "evict_claim",
    "evict_claim_locked", "matching_budgets",
    "CanaryController",
    "RolloutMonitor", "RolloutViolation",
]
