"""RolloutMonitor: invariant witness over every observable store state.

The rolling-update guarantees are claims about *every* intermediate
store state, not just fixpoints — so the chaos tests do not sample
state, they attach this monitor as a store journal hook: it runs under
the store lock inside ``ApiStore._bump``, sees every write in order,
and records a violation the instant any bound is broken:

* **surge** — a claim ADDED for a template workload never takes the
  workload's claim count past ``replicas + max_surge``;
* **availability** — a rolling *deletion* of a ready claim never takes
  the workload's ready count below ``replicas - max_unavailable``
  (involuntary losses — node SIGKILL, lease expiry — are device
  withdrawals, not deletions, and are exempt exactly as in
  Kubernetes);
* **budget** — a voluntary disruption (rolling delete of a ready
  claim, or a drain/canary eviction, recognized by its ``Evicted``
  condition) never takes any matching DisruptionBudget below
  ``min_available`` ready claims.

The monitor never calls back into the store (it would deadlock the
write path); it mirrors just enough state from the event stream.

The port's own copy of the JAX package's ``rollout/monitor.py`` (pure
Python; the port imports nothing of that package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..api.objects import ApiObject
from ..api.store import ADDED, DELETED, WatchEvent
from .strategy import claim_ready

__all__ = ["RolloutMonitor", "RolloutViolation"]


@dataclass
class RolloutViolation:
    invariant: str            # 'surge' | 'availability' | 'budget'
    subject: str              # workload or budget name
    detail: Dict[str, Any] = field(default_factory=dict)

    def __str__(self) -> str:
        return f"{self.invariant}[{self.subject}]: {self.detail}"


class RolloutMonitor:
    """Attach with ``store.add_journal(monitor)`` (or :meth:`attach`)."""

    def __init__(self) -> None:
        # workload name -> (replicas, max_surge, max_unavailable)
        self._workloads: Dict[str, tuple] = {}
        # claim name -> {"workload", "ready", "labels"}
        self._claims: Dict[str, Dict[str, Any]] = {}
        # budget name -> (selector, min_available)
        self._budgets: Dict[str, tuple] = {}
        self.violations: List[RolloutViolation] = []
        self.events_seen = 0

    # -- wiring ------------------------------------------------------------
    def attach(self, plane) -> "RolloutMonitor":
        """Seed from current contents, then hook the write path. Attach
        before starting any informer runtime (the seed scan is not
        synchronized against concurrent writers)."""
        for obj in plane.store.list_objects("Workload"):
            self._track_workload(obj)
        for obj in plane.store.list_objects("DisruptionBudget"):
            self._track_budget(obj)
        for obj in plane.store.list_objects("ResourceClaim"):
            self._claims[obj.meta.name] = self._claim_state(obj)
        plane.store.add_journal(self)
        return self

    # -- state mirroring ---------------------------------------------------
    def _track_workload(self, obj: ApiObject) -> None:
        wl = obj.spec
        if getattr(wl, "claim_template", ""):
            self._workloads[obj.meta.name] = (
                wl.replicas, wl.max_surge, wl.max_unavailable)

    def _track_budget(self, obj: ApiObject) -> None:
        self._budgets[obj.meta.name] = (dict(obj.spec.selector),
                                        obj.spec.min_available)

    @staticmethod
    def _claim_state(obj: ApiObject) -> Dict[str, Any]:
        return {"workload": obj.meta.labels.get("workload", ""),
                "ready": claim_ready(obj),
                "labels": dict(obj.meta.labels)}

    def _counts(self, workload: str) -> tuple:
        total = ready = 0
        for st in self._claims.values():
            if st["workload"] == workload:
                total += 1
                ready += bool(st["ready"])
        return total, ready

    def _budget_ready(self, selector: Dict[str, str]) -> int:
        return sum(1 for st in self._claims.values()
                   if st["ready"] and all(st["labels"].get(k) == v
                                          for k, v in selector.items()))

    # -- checks ------------------------------------------------------------
    def _check_surge(self, workload: str) -> None:
        spec = self._workloads.get(workload)
        if spec is None:
            return
        replicas, max_surge, _ = spec
        total, _ready = self._counts(workload)
        if total > replicas + max_surge:
            self.violations.append(RolloutViolation(
                "surge", workload,
                {"total": total, "replicas": replicas,
                 "max_surge": max_surge}))

    def _check_availability(self, workload: str) -> None:
        spec = self._workloads.get(workload)
        if spec is None:
            return
        replicas, _, max_unavailable = spec
        _total, ready = self._counts(workload)
        if ready < replicas - max_unavailable:
            self.violations.append(RolloutViolation(
                "availability", workload,
                {"ready": ready, "replicas": replicas,
                 "max_unavailable": max_unavailable}))

    def _check_budgets(self, labels: Dict[str, str]) -> None:
        for name, (selector, min_available) in self._budgets.items():
            if all(labels.get(k) == v for k, v in selector.items()):
                ready = self._budget_ready(selector)
                if ready < min_available:
                    self.violations.append(RolloutViolation(
                        "budget", name,
                        {"ready": ready, "min_available": min_available}))

    # -- the journal hook --------------------------------------------------
    def __call__(self, event: WatchEvent) -> None:
        self.events_seen += 1
        kind = event.kind
        if kind == "Workload":
            if event.type == DELETED:
                self._workloads.pop(event.name, None)
            else:
                self._track_workload(event.object)
            return
        if kind == "DisruptionBudget":
            if event.type == DELETED:
                self._budgets.pop(event.name, None)
            else:
                self._track_budget(event.object)
            return
        if kind != "ResourceClaim":
            return
        prior = self._claims.get(event.name)
        if event.type == DELETED:
            self._claims.pop(event.name, None)
            if prior is not None and prior["ready"]:
                # a rolling/scale deletion of a ready replica: both the
                # workload floor and every matching budget must survive
                if prior["workload"]:
                    self._check_availability(prior["workload"])
                self._check_budgets(prior["labels"])
            return
        state = self._claim_state(event.object)
        self._claims[event.name] = state
        if event.type == ADDED:
            if state["workload"]:
                self._check_surge(state["workload"])
            return
        if prior is not None and prior["ready"] and not state["ready"]:
            cond = event.object.condition("Allocated")
            if cond is not None and cond.reason == "Evicted":
                # voluntary eviction (drain / canary teardown): budget
                # floors apply; the workload floor does not (that bound
                # governs the rolling path, budgets govern drains)
                self._check_budgets(state["labels"])

    # -- verdict -----------------------------------------------------------
    def assert_clean(self) -> None:
        if self.violations:
            raise AssertionError(
                f"rollout invariant violations "
                f"({len(self.violations)}): "
                + "; ".join(str(v) for v in self.violations[:8]))

    def summary(self) -> Dict[str, Any]:
        return {"events_seen": self.events_seen,
                "violations": [str(v) for v in self.violations]}
