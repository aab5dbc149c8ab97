"""NodeLifecycleController: lease freshness -> Node Ready -> eviction.

The kube node-lifecycle loop, reduced to its load-bearing core: a node
is Ready exactly while its :class:`~repro_torch.api.objects.Lease` is fresh.
A missed heartbeat window flips the node NotReady, withdraws its
ResourceSlices from the pool and prunes the mirrored slice objects —
which is all it takes: the existing AllocationController healing path
sees the lost devices, deallocates, and (via the SchedulerController)
re-places the evicted claims onto surviving nodes. Eviction is therefore
*not* a special code path; it is the same level-triggered convergence a
spec edit or a withdrawn pool takes.

Time base: leases carry wall-clock stamps (``ControlPlane.node_clock``,
injectable for deterministic tests) so a recovered control plane sees
pre-crash leases as stale until their agents re-register.

The port's own copy of the JAX package's ``node/lifecycle.py`` (pure
Python; the port imports nothing of that package). It counts evictions
in a plain integer.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Tuple

from ..api.controllers import Controller
from ..api.objects import (ApiObject, CONDITION_READY, Lease, Node)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..api.controllers import ControlPlane

__all__ = ["DrainController", "NodeLifecycleController", "lease_state"]

# Condition the DrainController maintains on draining nodes.
CONDITION_DRAINED = "Drained"


def lease_state(plane: "ControlPlane", node: str,
                now: Optional[float] = None) -> Tuple[bool, str]:
    """(fresh, detail) for ``node``'s lease against the plane's clock.

    A missing lease, a lapsed renew window, or a renew stamp from the
    future (a clock that moved backwards across a restart) all read as
    stale — only a recent, plausible heartbeat keeps a node alive.
    ``detail`` is deliberately age-free: condition messages must be
    stable across re-evaluations or the reconcile loop never fixpoints.
    """
    lobj = plane.store.try_get("Lease", node)
    if lobj is None:
        return False, "no lease"
    lease: Lease = lobj.spec
    now = plane.node_clock() if now is None else now
    renew = lobj.status.outputs.get("renew_time", lease.acquired)
    age = now - renew
    if age > lease.duration_s:
        return False, f"lease lapsed (window {lease.duration_s}s)"
    if -age > lease.duration_s:
        return False, "lease renewed in the future (clock skew)"
    return True, f"lease held by {lease.holder!r} (window {lease.duration_s}s)"


class NodeLifecycleController(Controller):
    """Node Ready roll-up + dead-node inventory withdrawal."""

    kind = "Node"
    name = "node-lifecycle-controller"

    def __init__(self) -> None:
        # dead-node inventory withdrawals (lease lapsed)
        self.evictions = 0

    def reconcile(self, plane: "ControlPlane", obj: ApiObject) -> bool:
        node: Node = obj.spec
        fresh, detail = lease_state(plane, node.name)
        if fresh:
            changed = False
            if node.drain:
                # draining: cordon plus budget-aware eviction (the
                # DrainController's job); the node stays Ready so its
                # inventory survives until the claims have moved
                changed |= self._set(plane, obj, CONDITION_READY, True,
                                     "Draining", f"drain requested; {detail}")
            elif node.unschedulable:
                # cordoned: inventory stays (running claims keep their
                # devices) but the scheduler filters the node out
                changed |= self._set(plane, obj, CONDITION_READY, True,
                                     "Cordoned", f"unschedulable; {detail}")
            else:
                changed |= self._set(plane, obj, CONDITION_READY, True,
                                     "HeartbeatFresh", detail)
            return changed
        changed = self._set(plane, obj, CONDITION_READY, False,
                            "LeaseExpired", detail)
        pool = plane.registry.pool
        if any(s.node == node.name for s in pool.slices):
            # withdrawal bumps the inventory generation; the next
            # sync_inventory prunes the mirrored ResourceSlice objects
            # and their DELETED events requeue every claim holding (or
            # waiting on) devices of this node — the eviction edge
            pool.withdraw_node(node.name)
            plane.sync_inventory()
            self.evictions += 1
            changed = True
        return changed


def claims_on_node(plane: "ControlPlane", node: str) -> List[ApiObject]:
    """Claims currently holding allocated devices on ``node``."""
    out = []
    for obj in plane.store.list_objects("ResourceClaim"):
        claim = obj.spec
        if claim.allocated and any(a.ref.node == node
                                   for a in claim.allocation.devices):
            out.append(obj)
    return out


class DrainController(Controller):
    """Budget-aware voluntary eviction for ``Node.drain`` spec edits.

    ``kubectl drain`` as a declarative controller: while a node's spec
    asks for a drain, every claim holding its devices is evicted
    through the rollout plane's voluntary path — one
    :func:`~repro_torch.rollout.budget.disruption_allowed` check per claim,
    so a DisruptionBudget can hold evictions back until replacement
    replicas (re-placed onto schedulable nodes by the scheduler, which
    filters draining nodes out) are ready. A blocked drain reports
    ``BudgetBlocked`` — a retryable reason, so readmission rides the
    jittered per-object backoff instead of hammering every claim event
    — and finishes with ``Drained=True`` once nothing holds the node's
    devices.
    """

    kind = "Node"
    name = "drain-controller"

    def reconcile(self, plane: "ControlPlane", obj: ApiObject) -> bool:
        from ..rollout.budget import disruption_allowed, evict_claim_locked
        node: Node = obj.spec
        if not node.drain:
            if obj.condition(CONDITION_DRAINED) is None:
                return False
            return self._set(plane, obj, CONDITION_DRAINED, False,
                             "NotRequested", "node spec does not ask "
                             "for a drain")
        holding = claims_on_node(plane, node.name)
        if not holding:
            return self._set(plane, obj, CONDITION_DRAINED, True, "Drained",
                             "no claims hold devices on this node")
        changed = False
        blocked_by = ""
        for cobj in holding:
            allowed, budget = disruption_allowed(plane, cobj)
            if allowed:
                changed |= evict_claim_locked(plane, cobj.meta.name)
                plane.queue.add("ResourceClaim", cobj.meta.name)
            else:
                blocked_by = blocked_by or budget
        if blocked_by:
            changed |= self._set(
                plane, obj, CONDITION_DRAINED, False, "BudgetBlocked",
                f"eviction blocked by DisruptionBudget {blocked_by!r}")
        else:
            changed |= self._set(
                plane, obj, CONDITION_DRAINED, False, "Evicting",
                "claims are being evicted and re-placed")
        return changed
