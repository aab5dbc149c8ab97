"""DisruptionBudget accounting + the voluntary-eviction path.

Voluntary disruptions (node drains, canary teardowns) go through
:func:`evict_claim_locked`, which deallocates and unprepares a claim —
the claim *object* survives and the scheduler re-places it onto a
schedulable node, exactly the healing path an involuntary node failure
takes. The difference is the gate: a voluntary eviction of a ready
claim is refused whenever any matching
:class:`~repro_torch.api.objects.DisruptionBudget` would drop below its
``min_available`` ready claims. Involuntary failures (lease expiry)
never consult budgets, as in Kubernetes.

The port's own copy of the JAX package's ``rollout/budget.py`` (pure
Python; the port imports nothing of that package).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Tuple

from ..api.chaos import sync_point
from ..api.controllers import Controller
from ..api.objects import (ApiObject, Condition, FALSE,
                           CONDITION_ALLOCATED, CONDITION_READY)
from .strategy import claim_ready

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..api.controllers import ControlPlane

__all__ = ["matching_budgets", "disruption_allowed", "evict_claim_locked",
           "evict_claim", "DisruptionBudgetController"]


def matching_budgets(plane: "ControlPlane",
                     claim_obj: ApiObject) -> List[ApiObject]:
    """Every DisruptionBudget whose selector matches the claim's labels."""
    labels = claim_obj.meta.labels
    return [b for b in plane.store.list_objects("DisruptionBudget")
            if all(labels.get(k) == v
                   for k, v in b.spec.selector.items())]


def disruption_allowed(plane: "ControlPlane",
                       claim_obj: ApiObject) -> Tuple[bool, str]:
    """May this claim be voluntarily evicted right now?

    Evicting a claim that is not ready never reduces availability, so
    it is always allowed. A ready claim is allowed only if every
    matching budget keeps >= ``min_available`` ready claims after it.
    Returns (allowed, name of the first refusing budget).
    """
    if not claim_ready(claim_obj):
        return True, ""
    for budget in matching_budgets(plane, claim_obj):
        matched = plane.store.list_objects("ResourceClaim",
                                           selector=budget.spec.selector)
        ready = sum(1 for m in matched if claim_ready(m))
        if ready - 1 < budget.spec.min_available:
            return False, budget.meta.name
    return True, ""


def evict_claim_locked(plane: "ControlPlane", name: str) -> bool:
    """Voluntarily evict one claim (caller holds the reconcile lock).

    Teardown only — the claim object stays: its devices are released
    and its node-local prepare undone, then an ``Evicted`` Allocated
    condition re-triggers the scheduler/allocator healing chain, which
    re-places the claim onto a schedulable (non-draining) node. Does
    NOT consult budgets; gate with :func:`disruption_allowed` first.
    """
    obj = plane.store.try_get("ResourceClaim", name)
    if obj is None:
        return False
    sync_point("rollout.evict", killable=True, claim=name)
    claim = obj.spec
    plane.unprepare(claim)
    if claim.allocated:
        plane.allocator.deallocate(claim)
    plane.store.set_condition(
        "ResourceClaim", name,
        Condition(CONDITION_ALLOCATED, FALSE, reason="Evicted",
                  message="voluntarily evicted; awaiting re-placement",
                  observed_generation=obj.meta.generation))
    return True


def evict_claim(plane: "ControlPlane", name: str) -> bool:
    """Out-of-band voluntary eviction (takes the reconcile lock)."""
    with plane.mutate():
        return evict_claim_locked(plane, name)


class DisruptionBudgetController(Controller):
    """Publish each budget's live accounting as status.

    The analogue of the PDB status subresource: ``matched`` /
    ``ready`` / ``disruptions_allowed`` in outputs, and a Ready
    condition that is True exactly while the budget is satisfied —
    drains blocked on the budget surface the causality here.
    """

    kind = "DisruptionBudget"
    name = "disruption-budget-controller"

    def reconcile(self, plane: "ControlPlane", obj: ApiObject) -> bool:
        budget = obj.spec
        matched = plane.store.list_objects("ResourceClaim",
                                           selector=budget.selector)
        ready = sum(1 for m in matched if claim_ready(m))
        status = {
            "matched": len(matched),
            "ready": ready,
            "disruptions_allowed": max(0, ready - budget.min_available),
        }
        changed = False
        if obj.status.outputs.get("budget") != status:
            plane.store.set_output(self.kind, obj.meta.name, "budget",
                                   status)
            changed = True
        satisfied = ready >= budget.min_available
        changed |= self._set(
            plane, obj, CONDITION_READY, satisfied,
            "BudgetSatisfied" if satisfied else "BudgetShortfall",
            "ready claims at or above min_available" if satisfied
            else "fewer ready claims than min_available")
        return changed
