"""Reconciler controllers: converge the cluster onto the API objects.

This is the paper's control loop made explicit. Users *submit objects*
(ResourceClaims, Workloads) to the :class:`~repro_torch.api.store.ApiStore`;
the controllers below watch the store and drive each claim through

    allocate -> NodePrepareResources -> NRI hooks -> OCI AttachmentSpec
             -> MeshRuntime

recording a condition per phase (``Allocated`` -> ``Prepared`` ->
``Attached`` -> ``Ready``) and the latency of each transition. The old
imperative classes (StructuredAllocator, DriverRegistry, MeshPlanner,
MeshRuntime) survive unchanged as the controllers' *internals* — the
refactor moves the sequencing out of every launch script and into one
reusable reconciliation loop.

Reconciliation is level-triggered: controllers look at current state,
not at edit deltas, so a spec edit, a lost device, or a scale-up all
converge through the same code path (the elastic story of the paper's
§II critique — no imperative per-event reconfiguration).

The port's own copy of the JAX package's ``api/controllers.py``: the
attachment's ``MeshRuntime`` builds a torch ``DeviceMesh``, and the
rolling-update pressure is kept in plain integers.
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Set, Tuple

from ..core.allocator import AllocationError, StructuredAllocator
from ..core.claims import ResourceClaim
from ..core.drivers import DriverRegistry
from ..core.nri import Events
from ..core.oci import AttachmentSpec, MeshRuntime
from ..core.planner import MeshPlanner
from .chaos import sync_point
from .objects import (ApiObject, Condition, FALSE, TRUE, Workload,
                      CONDITION_ALLOCATED, CONDITION_ATTACHED,
                      CONDITION_PREPARED, CONDITION_READY,
                      CONDITION_SCHEDULED, PHASE_ORDER)
from .store import AdmissionError, ApiStore, DELETED, WatchEvent
from .workqueue import WorkQueue

__all__ = ["Controller", "AllocationController", "PrepareController",
           "AttachmentController", "WorkloadController", "ControlPlane",
           "RETRYABLE_REASONS"]

# Condition reasons that mark a reconcile *failure* the controller will
# retry (as opposed to a normal "waiting for an upstream phase" state).
# The event loop applies per-object exponential backoff to these, so a
# claim the inventory can never satisfy stops being re-examined on every
# slice event.
RETRYABLE_REASONS = frozenset({
    "Unsatisfiable", "PlanFailed", "NoPlanner",
    "TemplateMissing", "ClaimMissing", "AdmissionRejected",
    "NoFeasibleNode", "Unschedulable", "PrepareFailed",
    "BudgetBlocked",
})


class Controller:
    """Base reconciler: examines one object, returns True iff it acted."""

    kind: str = ""
    name: str = "controller"

    def reconcile(self, plane: "ControlPlane", obj: ApiObject) -> bool:
        raise NotImplementedError

    # -- helpers -----------------------------------------------------------
    @staticmethod
    def _set(plane: "ControlPlane", obj: ApiObject, type_: str, ok: bool,
             reason: str, message: str = "",
             transition: Optional[float] = None) -> bool:
        cond = Condition(type_, TRUE if ok else FALSE, reason=reason,
                         message=message,
                         observed_generation=obj.meta.generation)
        if transition is not None:
            cond.last_transition = transition
        return plane.store.set_condition(obj.meta.kind, obj.meta.name, cond)


class AllocationController(Controller):
    """ResourceClaim -> structured allocation (+ healing).

    Re-allocates when the spec generation moved (user edited the claim)
    or when allocated devices vanished from the pool (node failure) —
    the declarative self-healing the imperative wiring never had.
    """

    kind = "ResourceClaim"
    name = "allocation-controller"

    def reconcile(self, plane: "ControlPlane", obj: ApiObject) -> bool:
        claim: ResourceClaim = obj.spec
        changed = False
        if claim.allocated:
            lost = [a.ref.id for a in claim.allocation.devices
                    if plane.registry.pool.get(a.ref.id) is None]
            if not lost and obj.is_true(CONDITION_ALLOCATED, current=True):
                return False
            plane.unprepare(claim)
            plane.allocator.deallocate(claim)
            changed |= self._set(
                plane, obj, CONDITION_ALLOCATED, False,
                "DeviceLost" if lost else "SpecChanged",
                f"lost {len(lost)} device(s)" if lost
                else "claim spec edited; re-allocating")
        # node plane: schedulable claims allocate only within the node
        # set the SchedulerController placed them on (it runs earlier in
        # this kind's controller chain, so a fresh placement is already
        # recorded by the time we get here)
        nodes = None
        if (plane.store.count("Node") > 0
                and plane.scheduling_needs(claim) is not None):
            if not obj.is_true(CONDITION_SCHEDULED, current=True):
                return self._set(
                    plane, obj, CONDITION_ALLOCATED, False, "Unschedulable",
                    "waiting for a scheduler placement") or changed
            nodes = obj.status.outputs.get("scheduled_nodes")
        t0 = time.perf_counter()
        off_placement = False
        try:
            result = plane.allocator.allocate(claim, nodes=nodes)
        except AllocationError as e:
            if nodes is not None:
                # the placement proved infeasible against the allocator's
                # full semantics (MatchAttribute constraints, overlapping
                # requests) — fall back to the unconstrained search so a
                # satisfiable claim is never pinned Unsatisfiable by a
                # capacity-level scheduling decision
                try:
                    result = plane.allocator.allocate(claim)
                    off_placement = True
                except AllocationError:
                    return self._set(plane, obj, CONDITION_ALLOCATED, False,
                                     "Unsatisfiable", str(e)[:240]) or changed
            else:
                return self._set(plane, obj, CONDITION_ALLOCATED, False,
                                 "Unsatisfiable", str(e)[:240]) or changed
        dt = time.perf_counter() - t0
        self._set(plane, obj, CONDITION_ALLOCATED, True, "Allocated",
                  f"{len(result.devices)} device(s) in {dt * 1e3:.2f}ms"
                  + (" (off scheduled placement)" if off_placement else ""))
        plane.registry.bus.publish(Events.CLAIM_ALLOCATED, claim=claim)
        return True


class PrepareController(Controller):
    """Allocated claims -> NodePrepareResources (off the critical path)."""

    kind = "ResourceClaim"
    name = "prepare-controller"

    def reconcile(self, plane: "ControlPlane", obj: ApiObject) -> bool:
        claim: ResourceClaim = obj.spec
        if not (claim.allocated and obj.is_true(CONDITION_ALLOCATED,
                                                current=True)):
            if claim.prepared or plane.is_prepared(claim):
                plane.unprepare(claim)
                return self._set(plane, obj, CONDITION_PREPARED, False,
                                 "TornDown", "claim lost its allocation")
            cond = obj.condition(CONDITION_PREPARED)
            if cond is not None and cond.true:
                return self._set(plane, obj, CONDITION_PREPARED, False,
                                 "TornDown", "claim lost its allocation")
            return False
        if claim.prepared and obj.is_true(CONDITION_PREPARED, current=True):
            return False
        t0 = time.perf_counter()
        try:
            prepared = plane.registry.prepare(claim)
        except Exception as e:  # noqa: BLE001 - node-plane agent failures
            # a dead node agent cannot serve NodePrepareResources; the
            # failure is retryable — lease expiry withdraws the node and
            # the healed allocation prepares on a live one
            return self._set(plane, obj, CONDITION_PREPARED, False,
                             "PrepareFailed",
                             f"{type(e).__name__}: {e}"[:240])
        dt = time.perf_counter() - t0
        return self._set(plane, obj, CONDITION_PREPARED, True, "Prepared",
                         f"{sorted(prepared)} in {dt * 1e3:.2f}ms")


class AttachmentController(Controller):
    """Prepared mesh workloads -> plan -> NRI hooks -> AttachmentSpec.

    Emits the declarative attachment over the NRI bus (RunPodSandbox /
    CreateContainer) and, when the workload asks for it, executes it
    through the privileged MeshRuntime. A fingerprint of (workload
    generation, claim generation, allocated devices) guards against
    stale plans: any spec edit or re-allocation forces a re-plan.
    """

    kind = "Workload"
    name = "attachment-controller"

    @staticmethod
    def _fingerprint(obj: ApiObject, claim_obj: ApiObject) -> tuple:
        refs = tuple(a.ref.id for a in claim_obj.spec.allocation.devices)
        return (obj.meta.generation, claim_obj.meta.generation, refs)

    def reconcile(self, plane: "ControlPlane", obj: ApiObject) -> bool:
        wl: Workload = obj.spec
        if not (wl.claim and wl.axes):
            return False
        claim_obj = plane.store.try_get("ResourceClaim", wl.claim)
        if claim_obj is None or not (
                claim_obj.is_true(CONDITION_ALLOCATED, current=True)
                and claim_obj.is_true(CONDITION_PREPARED, current=True)):
            cond = obj.condition(CONDITION_ATTACHED)
            if cond is not None and cond.true:
                return self._set(plane, obj, CONDITION_ATTACHED, False,
                                 "ClaimNotReady",
                                 "waiting for claim to re-converge")
            return False
        fp = self._fingerprint(obj, claim_obj)
        if (obj.is_true(CONDITION_ATTACHED, current=True)
                and obj.status.outputs.get("attachment_fingerprint") == fp):
            return False
        if plane.planner is None:
            return self._set(plane, obj, CONDITION_ATTACHED, False,
                             "NoPlanner",
                             "control plane has no cluster/planner")
        t0 = time.perf_counter()
        try:
            plan = plane.planner.plan(list(wl.axes), wl.placement,
                                      claim_obj.spec, seed=wl.seed)
        except Exception as e:  # noqa: BLE001 - surfaced as a condition
            return self._set(plane, obj, CONDITION_ATTACHED, False,
                             "PlanFailed", f"{type(e).__name__}: {e}"[:240])
        # NRI hooks: independent drivers act on the pod-sandbox event; a
        # driver may emit the AttachmentSpec itself (DraNet's role), else
        # the plan's own declarative spec is used.
        results = plane.registry.bus.publish(Events.RUN_POD_SANDBOX,
                                             plan=plan, claim=claim_obj.spec)
        spec = next((r.value for r in results
                     if r.ok and isinstance(r.value, AttachmentSpec)), None)
        if spec is None:
            spec = plan.attachment()
        plane.registry.bus.publish(Events.CREATE_CONTAINER,
                                   plan=plan, claim=claim_obj.spec)
        store = plane.store
        store.set_output(self.kind, obj.meta.name, "plan", plan)
        store.set_output(self.kind, obj.meta.name, "attachment", spec)
        store.set_output(self.kind, obj.meta.name, "attachment_fingerprint", fp)
        if wl.build_mesh:
            mesh = plane.runtime.execute(spec)
            store.set_output(self.kind, obj.meta.name, "mesh", mesh)
        dt = time.perf_counter() - t0
        self._set(plane, obj, CONDITION_ATTACHED, True, "Attached",
                  f"{plan.summary()} in {dt * 1e3:.2f}ms")
        return True


class WorkloadController(Controller):
    """Workload replica management + condition roll-up + Ready.

    Template workloads are the serve replica-set shape: the controller
    stamps one claim per replica from the ResourceClaimTemplate and
    converges claim count on ``spec.replicas`` (scale up/down is a spec
    edit). Single-claim workloads roll up their claim's conditions and
    go Ready once (optionally) attached.
    """

    kind = "Workload"
    name = "workload-controller"

    def __init__(self) -> None:
        # workload name -> (surge, unavailable): how many replicas above
        # spec and how many below ready the current rolling step holds open
        self.pressure: Dict[str, Tuple[int, int]] = {}

    def _replica_claims(self, plane: "ControlPlane", obj: ApiObject
                        ) -> Tuple[Optional[List[ApiObject]], str, bool]:
        """One bounded rolling step -> (claims, admission msg, converged).

        ``claims`` is None when the template is missing; a non-empty
        second element reports an admission rejection that capped the
        replica set below spec (the workload stays not-Ready and retries
        under backoff — capacity may be published later).

        Replica management is *rolling*, not replace-on-edit: each
        claim carries the revision it was stamped for (template
        generation + runtime config, :mod:`repro_torch.rollout.strategy`) and
        a template/config edit replaces claims one bounded step per
        reconcile — at most ``max_surge`` claims beyond spec exist and
        ready replicas never drop below ``replicas - max_unavailable``
        through any single store write. Old-revision replicas keep
        serving until their replacements are ready.
        """
        from ..rollout.strategy import (REVISION_LABEL, claim_ready,
                                        claim_revision, desired_revisions,
                                        plan_rollout, revision_hash)
        wl: Workload = obj.spec
        store = plane.store
        tmpl = store.try_get("ResourceClaimTemplate", wl.claim_template)
        if tmpl is None:
            return None, "", False
        base_rev = revision_hash(tmpl.meta.generation, wl.runtime_config)
        desired = desired_revisions(wl, tmpl.meta.generation)
        owned = store.list_objects("ResourceClaim",
                                   selector={"workload": obj.meta.name})
        observed = [(o.meta.name, claim_revision(o, base_rev),
                     claim_ready(o)) for o in owned]
        plan = plan_rollout(observed, desired, replicas=wl.replicas,
                            max_surge=wl.max_surge,
                            max_unavailable=wl.max_unavailable)
        for name in plan.delete_free + plan.delete_bounded:
            extra = store.try_get("ResourceClaim", name)
            if extra is None:
                continue
            sync_point("rollout.delete", killable=True, claim=name)
            plane.unprepare(extra.spec)
            if extra.spec.allocated:
                plane.allocator.deallocate(extra.spec)
            store.delete("ResourceClaim", name)
        admission_msg = ""
        stamped = 0
        for rev in sorted(plan.stamp):
            for _ in range(plan.stamp[rev]):
                claim = tmpl.spec.instantiate(owner=obj.meta.name)
                sync_point("rollout.stamp", killable=True,
                           claim=claim.name, revision=rev)
                try:
                    store.create(claim, labels={"workload": obj.meta.name,
                                                REVISION_LABEL: rev})
                    # count *landed* stamps only: a rejected stamp would
                    # re-touch the template every retry and never fixpoint
                    stamped += 1
                except AdmissionError as e:
                    # strip the stamped claim's name (counter-suffixed) so
                    # the surfaced condition message is stable across
                    # retries — an ever-changing message would never
                    # reach a fixpoint
                    admission_msg = str(e).split(
                        "rejected at admission: ", 1)[-1][:240]
                    break
            if admission_msg:
                break
        if stamped:
            # stamping advanced the template's name counter *in memory*
            # only — without a status write the WAL's last record of the
            # template keeps the stale counter, and a recovered control
            # plane would stamp colliding replica names. The touch emits
            # a MODIFIED event so the journal re-captures the template
            # (counter included) at its next flush.
            store.update_status(
                "ResourceClaimTemplate", tmpl.meta.name,
                lambda st, n=stamped: st.outputs.__setitem__(
                    "stamped_total", st.outputs.get("stamped_total", 0) + n))
        claims = store.list_objects("ResourceClaim",
                                    selector={"workload": obj.meta.name})
        rollout = {
            "revisions": {},
            "ready": sum(1 for c in claims if claim_ready(c)),
            "converged": plan.converged,
            "base_revision": base_rev,
            "canary_revision": next(
                (r for r in desired if r != base_rev), ""),
        }
        for c in claims:
            rev = claim_revision(c, base_rev)
            rollout["revisions"][rev] = rollout["revisions"].get(rev, 0) + 1
        if obj.status.outputs.get("rollout") != rollout:
            store.set_output("Workload", obj.meta.name, "rollout", rollout)
        self.pressure[obj.meta.name] = (
            max(0, len(claims) - wl.replicas),
            max(0, wl.replicas - rollout["ready"]))
        return claims, admission_msg, plan.converged

    def reconcile(self, plane: "ControlPlane", obj: ApiObject) -> bool:
        wl: Workload = obj.spec
        store = plane.store
        changed = False
        admission_msg = ""
        converged = True
        if wl.claim_template:
            prior = store.resource_version
            claims, admission_msg, converged = self._replica_claims(
                plane, obj)
            if claims is None:
                return self._set(plane, obj, CONDITION_READY, False,
                                 "TemplateMissing",
                                 f"no ResourceClaimTemplate "
                                 f"{wl.claim_template!r}")
            changed |= store.resource_version != prior
        else:
            cobj = store.try_get("ResourceClaim", wl.claim)
            if cobj is None:
                return self._set(plane, obj, CONDITION_READY, False,
                                 "ClaimMissing",
                                 f"no ResourceClaim {wl.claim!r}")
            claims = [cobj]
        n = len(claims)
        # an empty replica set (admission rejected every stamp) has
        # nothing allocated, not vacuously everything
        all_alloc = n > 0 and all(c.is_true(CONDITION_ALLOCATED, current=True)
                                  for c in claims)
        all_prep = n > 0 and all(c.is_true(CONDITION_PREPARED, current=True)
                                 for c in claims)

        def mirror_ts(phase: str, ok: bool) -> Optional[float]:
            # a roll-up condition transitions when the LAST claim did,
            # not when this controller happened to observe it
            if not ok or n == 0:
                return None
            return max(c.condition(phase).last_transition for c in claims)

        changed |= self._set(plane, obj, CONDITION_ALLOCATED, all_alloc,
                             "AllClaimsAllocated" if all_alloc
                             else "WaitingForAllocation",
                             f"{sum(c.is_true(CONDITION_ALLOCATED, current=True) for c in claims)}/{n} claims",
                             transition=mirror_ts(CONDITION_ALLOCATED, all_alloc))
        changed |= self._set(plane, obj, CONDITION_PREPARED, all_prep,
                             "AllClaimsPrepared" if all_prep
                             else "WaitingForPrepare",
                             f"{sum(c.is_true(CONDITION_PREPARED, current=True) for c in claims)}/{n} claims",
                             transition=mirror_ts(CONDITION_PREPARED, all_prep))
        needs_attach = bool(wl.claim and wl.axes)
        attached = (obj.is_true(CONDITION_ATTACHED, current=True)
                    if needs_attach else all_prep)
        ready = (all_alloc and all_prep and attached and converged
                 and not admission_msg)
        was_ready = obj.is_true(CONDITION_READY, current=True)
        if admission_msg:
            reason, message = "AdmissionRejected", admission_msg
        elif not ready and all_alloc and all_prep and attached:
            # counts/revisions still rolling while every present claim
            # is healthy: surface the rollout, not a phase blocker
            reason, message = "RollingUpdate", "replica set converging"
        else:
            blocker = (CONDITION_ALLOCATED if not all_alloc else
                       CONDITION_PREPARED if not all_prep else
                       CONDITION_ATTACHED)
            reason = "Converged" if ready else f"Blocked:{blocker}"
            message = f"{n} claim(s), role={wl.role}" if ready else ""
        changed |= self._set(plane, obj, CONDITION_READY, ready,
                             reason, message)
        if ready and not was_ready:
            store.set_output(self.kind, obj.meta.name, "claims",
                             [c.meta.name for c in claims])
            lat = plane.record_phase_latencies(obj, claims)
            store.set_output(self.kind, obj.meta.name, "phase_latency_s", lat)
            plane.registry.bus.publish(Events.JOB_SUBMITTED,
                                       workload=obj.meta.name, role=wl.role)
        return changed


class ControlPlane:
    """The declarative control plane: one store, one reconciler set.

    Wraps a :class:`DriverRegistry` (drivers, pool, NRI bus) and exposes
    the API-centric workflow every scenario now uses::

        plane = ControlPlane(registry, cluster)
        plane.run_discovery()
        plane.submit(claim)
        plane.submit(Workload(claim=claim.name, axes=[...]))
        obj = plane.wait_for("Workload", name)       # reconcile -> Ready
        mesh = obj.status.outputs["mesh"]

    ``reconcile()`` runs the controllers level-triggered until the watch
    stream goes quiet (a fixpoint): every round first mirrors the
    driver-published ResourceSlices into the store, then lets each
    controller act on each object of its kind.
    """

    RECONCILE_MODES = ("event", "sweep", "inline")

    def __init__(self, registry: DriverRegistry, cluster: Any = None,
                 store: Optional[ApiStore] = None,
                 runtime: Optional[MeshRuntime] = None,
                 reconcile_mode: str = "event",
                 state_dir: Optional[str] = None,
                 admission: bool = True):
        if reconcile_mode not in self.RECONCILE_MODES:
            raise ValueError(f"unknown reconcile_mode {reconcile_mode!r}")
        self.registry = registry
        self.store = store or ApiStore()
        self.cluster = cluster
        self.planner = MeshPlanner(cluster) if cluster is not None else None
        self.allocator = StructuredAllocator(registry.pool, registry.classes)
        self.runtime = runtime or MeshRuntime()
        # node-plane controllers ride along unconditionally (both are
        # inert without Node objects); imported late — repro_torch.node builds
        # on this module's Controller base
        from ..node.lifecycle import DrainController, NodeLifecycleController
        from ..node.scheduler import SchedulerController
        from ..rollout.budget import DisruptionBudgetController
        from ..rollout.canary import CanaryController
        # Node lifecycle first (evictions land before claims reconcile),
        # the drain controller right behind it (budget-aware voluntary
        # eviction on the same Node chain), then the scheduler ahead of
        # allocation in the claim chain; rollout bookkeeping (budgets,
        # canaries) runs after workloads so it judges settled state
        self.controllers: List[Controller] = [
            NodeLifecycleController(), DrainController(),
            SchedulerController(), AllocationController(),
            PrepareController(),
            AttachmentController(), WorkloadController(),
            DisruptionBudgetController(), CanaryController(),
        ]
        # wall-clock for Node leases (injectable: deterministic tests
        # drive expiry by swapping the clock, not by sleeping)
        self.node_clock = time.time
        self.phase_latencies: Dict[str, Dict[str, float]] = {}
        self._watch = self.store.watch()
        self.reconcile_mode = reconcile_mode
        self.queue = WorkQueue()
        # serializes controller critical sections: the inline loop, any
        # threaded informer workers (repro.api.runtime), and out-of-band
        # pool/registry mutations (ControlPlane.mutate) all take it
        self.reconcile_lock = threading.RLock()
        # the running ControlPlaneRuntime, when one is attached (set by
        # runtime.start(); None in blocking/"inline" operation)
        self.informer = None
        # processing order: claims converge before the workloads rolling
        # them up (one fewer round per dependency hop)
        self._kind_order: List[str] = []
        self._by_kind: Dict[str, List[Controller]] = {}
        for ctl in self.controllers:
            if ctl.kind not in self._by_kind:
                self._kind_order.append(ctl.kind)
            self._by_kind.setdefault(ctl.kind, []).append(ctl)
        # dependency edges: claim name -> workload names referencing it
        self._claim_owners: Dict[str, Set[str]] = {}
        # template name -> workload names stamping from it
        self._template_owners: Dict[str, Set[str]] = {}
        # workload name -> (claim, template) it last referenced, so a
        # spec edit that repoints a workload drops the stale edge
        self._wl_refs: Dict[str, Tuple[str, str]] = {}
        # workload name -> canary names targeting it (slo telemetry and
        # workload edits wake the judging CanaryController)
        self._canary_refs: Dict[str, Set[str]] = {}
        # canary name -> workload it targets (edge cleanup on delete)
        self._canary_target: Dict[str, str] = {}
        # nodes whose spec asks for a drain: claim churn re-examines
        # them (evictions blocked on a budget retry when claims move)
        self._draining_nodes: Set[str] = set()
        # generation an object last failed at (stale-failure backoff reset)
        self._failure_gen: Dict[Tuple[str, str], int] = {}
        # incremental sync_inventory state
        self._synced_pool_gen: Optional[int] = None
        self._synced_classes: Set[str] = set()
        # freed-capacity edge state (see _requeue_on_released_capacity):
        # claims that settled in a not-Allocated state, maintained by the
        # event batch loop so the release edge is O(blocked), not O(store)
        self._seen_release_gen = registry.pool.release_generation
        self._blocked_claims: Set[str] = set()
        # telemetry: reconcile() calls per controller (the scale benchmark
        # and tests read this to prove rounds only touch dirty objects)
        self.reconcile_calls = 0
        # admission: reject claims that exceed a DeviceClass capacity
        # summary at create time (ROADMAP validation item)
        self._capacity_gen = -1
        self._capacity: Dict[str, int] = {}
        if admission:
            self.store.add_validator(self._admission_validate)
        # durability: WAL journal flushed at every reconcile fixpoint
        self.journal = None
        self.recovery_info = None
        if state_dir is not None:
            self.attach_journal(state_dir)

    # -- admission ---------------------------------------------------------
    def _class_capacity(self, class_name: str) -> Optional[int]:
        """Capacity summary: devices (allocated or not) matching a class.

        Recomputed per inventory generation; ``None`` when the class is
        unknown to the registry (it may be registered later — the
        level-triggered runtime path will report Unsatisfiable).
        """
        cls = self.registry.classes.get(class_name)
        if cls is None:
            return None
        gen = self.registry.pool.inventory_generation
        if gen != self._capacity_gen:
            self._capacity = {}
            self._capacity_gen = gen
        if class_name not in self._capacity:
            self._capacity[class_name] = sum(
                1 for d in self.registry.pool.devices(include_allocated=True)
                if cls.matches(d))
        return self._capacity[class_name]

    def _admission_validate(self, kind: str, spec: Any) -> None:
        """Reject statically infeasible claims at ``store.create`` time.

        Only fires when the class summary is positive: a zero summary is
        indistinguishable from "discovery has not run yet", and rejecting
        those would break submit-before-discovery (level-triggered)
        workflows.
        """
        if kind != "ResourceClaim":
            return
        for req in spec.spec.requests:
            if req.allocation_mode != "ExactCount":
                continue
            total = self._class_capacity(req.device_class)
            if total and req.count > total:
                raise AdmissionError(
                    f"claim {spec.name!r} rejected at admission: request "
                    f"{req.name!r} wants {req.count} × "
                    f"{req.device_class!r} but the class capacity summary "
                    f"is {total} device(s)")

    # -- durability --------------------------------------------------------
    def attach_journal(self, state_dir: str, **journal_kw: Any):
        """Journal this plane's store into ``state_dir`` (WAL + snapshots)."""
        from .persistence import StoreJournal
        self.journal = StoreJournal(self.store, state_dir, **journal_kw)
        self.journal.attach(resume=len(self.store) > 0)
        return self.journal

    @classmethod
    def open(cls, state_dir: Optional[str], registry: DriverRegistry,
             cluster: Any = None, announce=print,
             **kw: Any) -> "ControlPlane":
        """Recovered-or-fresh plane: the entry-point front door.

        A ``state_dir`` holding state is recovered (and announced);
        otherwise a fresh plane is built — journaled when ``state_dir``
        is set, plain when None — with discovery already run.
        """
        from .persistence import has_state
        if state_dir and has_state(state_dir):
            plane = cls.recover(state_dir, registry, cluster, **kw)
            if announce is not None:
                announce(f"[knd] recovered "
                         f"{plane.recovery_info.summary()}; "
                         f"adopted {plane.adoption_stats}")
            return plane
        plane = cls(registry, cluster, state_dir=state_dir, **kw)
        plane.run_discovery()
        return plane

    @classmethod
    def recover(cls, state_dir: str, registry: DriverRegistry,
                cluster: Any = None, runtime: Optional[MeshRuntime] = None,
                reconcile_mode: str = "event", admission: bool = True,
                resume_journal: bool = True,
                **journal_kw: Any) -> "ControlPlane":
        """Rebuild a control plane from a persisted state directory.

        Replays snapshot + WAL into a fresh store, constructs a plane
        around it (the new watch cursor re-seeds every dirty queue from
        the recovered objects), then runs :meth:`adopt` so in-flight
        workloads keep their allocations. With ``resume_journal`` the
        recovered plane immediately compacts into a new snapshot and
        keeps journaling to the same directory.
        """
        from .persistence import recover_store
        store, info = recover_store(state_dir)
        plane = cls(registry, cluster, store=store, runtime=runtime,
                    reconcile_mode=reconcile_mode, admission=admission)
        plane.recovery_info = info
        plane.adopt()
        if resume_journal:
            plane.attach_journal(state_dir, **journal_kw)
        return plane

    def adopt(self) -> Dict[str, int]:
        """Adopt persisted state against live driver inventory.

        Runs discovery, then re-derives the :class:`ResourcePool`'s
        allocation bookkeeping from persisted claim allocations (so the
        AllocationController sees them as healthy and never re-allocates),
        re-primes node drivers for claims recorded as prepared
        (NodePrepareResources is node-local state a restart loses), and
        strips :class:`~repro_torch.api.persistence.Unpersisted` output markers
        so derived artifacts (plan, mesh) are rebuilt by the
        AttachmentController — deterministically, from the same seed.

        Holds the reconcile lock: recovery normally runs before any
        informer exists, but the pool bookkeeping rebuilt here is the
        same state live reconciles guard, so adoption stays safe even
        against an already-attached runtime (the lock is reentrant for
        the inline path).
        """
        with self.reconcile_lock:
            return self._adopt_locked()

    def _adopt_locked(self) -> Dict[str, int]:
        from .persistence import Unpersisted, _count_value
        self.registry.run_discovery()
        self.sync_inventory()
        stats = {"adopted": 0, "lost": 0, "prepared": 0, "rederive": 0}
        pool = self.registry.pool
        for obj in self.store.list_objects("ResourceClaim"):
            claim: ResourceClaim = obj.spec
            self.queue.add("ResourceClaim", obj.meta.name)
            if not claim.allocated:
                continue
            devs = [pool.get(a.ref.id) for a in claim.allocation.devices]
            if (all(d is not None for d in devs)
                    and not any(pool.is_allocated(d.id) for d in devs)):
                pool.mark_allocated(devs, claim.uid)
                stats["adopted"] += 1
                if claim.prepared:
                    # refill the node drivers' prepared-config caches;
                    # touches no store state, so no condition churn
                    self.registry.prepare(claim)
                    stats["prepared"] += 1
            else:
                # devices vanished while we were down — leave the stale
                # allocation for the AllocationController to heal
                stats["lost"] += 1
        # re-derive template name counters from the claims that actually
        # exist: a crash can persist stamped claims whose ADDED events
        # flushed before the template's counter-touch did, and a stale
        # counter would stamp colliding replica names after adoption
        claim_names = [o.meta.name
                       for o in self.store.list_objects("ResourceClaim")]
        for tobj in self.store.list_objects("ResourceClaimTemplate"):
            tmpl = tobj.spec
            prefix = tmpl.name + "-"
            used = -1
            for name in claim_names:
                if name.startswith(prefix):
                    tail = name.rsplit("-", 1)[-1]
                    if tail.isdigit():
                        used = max(used, int(tail))
            if used >= 0 and _count_value(tmpl._counter) <= used:
                tmpl._counter = itertools.count(used + 1)
                stats["counter_healed"] = stats.get("counter_healed", 0) + 1
        for obj in self.store.list_objects("Workload"):
            self.queue.add("Workload", obj.meta.name)
            outputs = obj.status.outputs
            dropped = [k for k, v in outputs.items()
                       if isinstance(v, Unpersisted)]
            if dropped:
                for k in dropped:
                    outputs.pop(k)
                # the fingerprint guards a plan/mesh we no longer have;
                # removing it makes the AttachmentController re-derive
                outputs.pop("attachment_fingerprint", None)
                stats["rederive"] += 1
        self.adoption_stats = stats
        return stats

    # -- inventory ---------------------------------------------------------
    def run_discovery(self) -> int:
        """Drivers publish slices; mirror them + device classes as objects."""
        n = self.registry.run_discovery()
        self.sync_inventory()
        return n

    def sync_inventory(self) -> None:
        """Mirror device classes + pool ResourceSlices into the store.

        Incremental: the mirror loop only runs when the pool's inventory
        generation moved (slice publish / node withdrawal) or a new
        DeviceClass was registered — so the reconcile loop can call this
        every round at O(1) steady-state cost instead of re-walking every
        slice and every mirrored object.
        """
        class_names = self.registry.classes.keys()
        if class_names - self._synced_classes:
            for cls in self.registry.classes.values():
                if self.store.try_get("DeviceClass", cls.name) is None:
                    self.store.create(cls)
            self._synced_classes = set(class_names)
        gen = self.registry.pool.inventory_generation
        if gen == self._synced_pool_gen:
            return
        live = {}
        for sl in self.registry.pool.slices:
            name = f"{sl.driver}~{sl.pool}~{sl.node}".replace("/", "_")
            live[name] = sl
            obj = self.store.try_get("ResourceSlice", name)
            if obj is None:
                self.store.create(sl, name=name,
                                  labels={"node": sl.node, "driver": sl.driver})
            elif obj.spec is not sl:   # pool re-publication replaces slices
                self.store.update_spec("ResourceSlice", name,
                                       lambda _old, new=sl: new)
        for obj in self.store.list_objects("ResourceSlice"):
            if obj.meta.name not in live:
                self.store.delete("ResourceSlice", obj.meta.name)
        self._synced_pool_gen = gen

    # -- object submission -------------------------------------------------
    def submit(self, spec: Any, name: Optional[str] = None,
               labels: Optional[Dict[str, str]] = None) -> ApiObject:
        return self.store.create(spec, name=name, labels=labels)

    def edit(self, kind: str, name: str, mutate) -> ApiObject:
        """Spec edit: bumps generation; reconcilers converge on it."""
        return self.store.update_spec(kind, name, mutate)

    @contextmanager
    def mutate(self):
        """Serialize an out-of-band mutation against the reconcile loop.

        Store writes are already thread-safe; this is for mutations that
        bypass the store — ``pool.withdraw_node``, direct allocator
        calls, registry surgery — which must not interleave with a
        running informer worker's controller section. A no-op cost when
        nothing is running (uncontended RLock). Wakes the informer so
        level-triggered requeues (released capacity, inventory sync)
        happen promptly.
        """
        with self.reconcile_lock:
            yield
            # clear the idle flag BEFORE releasing the lock: a quiesce
            # check in the gap could otherwise settle-fail waiters whose
            # convergence this very mutation (e.g. freed capacity, which
            # emits no store event) is about to enable
            informer = self.informer   # single read: stop() may null it
            if informer is not None:
                informer._quiesced.clear()
        if informer is not None:
            informer._wake.set()

    # -- node plane ----------------------------------------------------------
    @staticmethod
    def scheduling_needs(claim: ResourceClaim) -> Optional[Dict[str, int]]:
        """Device-class -> count a scheduler placement must cover.

        ``None`` marks the claim unschedulable-by-design ('All'-mode
        requests take whatever matches wherever it is) — such claims
        bypass the scheduler and allocate unconstrained.
        """
        needs: Dict[str, int] = {}
        for req in claim.spec.requests:
            if req.allocation_mode != "ExactCount":
                return None
            needs[req.device_class] = needs.get(req.device_class, 0) + req.count
        return needs or None

    def _requeue_expired_leases(self) -> None:
        """Time-triggered Node dirt: a lapsed lease emits no store event.

        Only the Ready→expired edge needs the clock poll (recovery is
        event-driven: the returning agent's lease renewal is a store
        write that re-queues the node). Requeues exactly on the
        mismatch, so a settled NotReady node costs nothing per round.
        """
        if self.store.count("Node") == 0:
            return
        from ..node.lifecycle import lease_state
        now = self.node_clock()
        for obj in self.store.list_objects("Node"):
            if (obj.is_true(CONDITION_READY, current=True)
                    and not lease_state(self, obj.meta.name, now)[0]):
                self.queue.add("Node", obj.meta.name)

    def _lease_attention_needed(self) -> bool:
        """Any Ready node whose lease has lapsed? (quiesce guard: the
        runtime must not settle waiters while an eviction is due)"""
        if self.store.count("Node") == 0:
            return False
        from ..node.lifecycle import lease_state
        now = self.node_clock()
        return any(obj.is_true(CONDITION_READY, current=True)
                   and not lease_state(self, obj.meta.name, now)[0]
                   for obj in self.store.list_objects("Node"))

    # -- event routing (dependency edges) ------------------------------------
    def _requeue_claims_for_nodes(self, nodes: Set[str]) -> None:
        """Requeue claims a batch of slice changes can unblock or break.

        * claims holding devices on an affected node (loss -> heal);
        * claims not currently Allocated for their generation (new
          capacity may satisfy them).

        One claims pass per event pump, however many slices changed —
        node recovery republishes every slice at once, and a per-event
        scan would be O(slices x claims).
        """
        for obj in self.store.list_objects("ResourceClaim"):
            claim: ResourceClaim = obj.spec
            if claim.allocated and any(a.ref.node in nodes
                                       for a in claim.allocation.devices):
                self.queue.add("ResourceClaim", obj.meta.name)
            elif not obj.is_true(CONDITION_ALLOCATED, current=True):
                self.queue.add("ResourceClaim", obj.meta.name)
        # template workloads blocked at admission (no claims exist yet to
        # wake them) retry when new capacity is published
        for obj in self.store.list_objects("Workload"):
            if not obj.is_true(CONDITION_READY, current=True):
                self.queue.add("Workload", obj.meta.name)

    def _route_event(self, e: WatchEvent,
                     slice_nodes: Optional[Set[str]] = None) -> None:
        """Translate one watch event into dirty-queue entries.

        ResourceSlice events are *collected* into ``slice_nodes`` (the
        caller fans them out in one batched claims pass) rather than
        scanned per event.
        """
        q, kind = self.queue, e.kind
        if kind == "ResourceClaim":
            if e.type == DELETED:
                q.forget(kind, e.name)
                self._failure_gen.pop((kind, e.name), None)
                self._blocked_claims.discard(e.name)
            else:
                q.add(kind, e.name)
            # claim progress / loss wakes the owning workload(s)
            owner = e.object.meta.labels.get("workload")
            owners = set(self._claim_owners.get(e.name, ()))
            if owner:
                owners.add(owner)
            for wl in owners:
                q.add("Workload", wl)
            # claim churn moves budget accounting and can unblock a
            # drain waiting on its disruption budget
            if self.store.count("DisruptionBudget"):
                q.add_all("DisruptionBudget",
                          (o.meta.name for o in
                           self.store.list_objects("DisruptionBudget")))
            q.add_all("Node", self._draining_nodes)
            if e.type == DELETED:
                # prune edges — but keep workloads that still *reference*
                # this name (they must wake if the claim is re-created)
                live = {w for w in self._claim_owners.get(e.name, ())
                        if self._wl_refs.get(w, ("", ""))[0] == e.name}
                if live:
                    self._claim_owners[e.name] = live
                else:
                    self._claim_owners.pop(e.name, None)
        elif kind == "Workload":
            wl: Workload = e.object.spec
            prev_claim, prev_tmpl = self._wl_refs.get(e.name, ("", ""))
            if prev_claim and prev_claim != wl.claim:
                self._claim_owners.get(prev_claim, set()).discard(e.name)
            if prev_tmpl and prev_tmpl != wl.claim_template:
                self._template_owners.get(prev_tmpl, set()).discard(e.name)
            if e.type == DELETED:
                q.forget(kind, e.name)
                self._failure_gen.pop((kind, e.name), None)
                self._wl_refs.pop(e.name, None)
                if wl.claim:
                    self._claim_owners.get(wl.claim, set()).discard(e.name)
                if wl.claim_template:
                    self._template_owners.get(wl.claim_template,
                                              set()).discard(e.name)
                return
            q.add(kind, e.name)
            self._wl_refs[e.name] = (wl.claim, wl.claim_template)
            if wl.claim:
                self._claim_owners.setdefault(wl.claim, set()).add(e.name)
                q.add("ResourceClaim", wl.claim)
            if wl.claim_template:
                self._template_owners.setdefault(wl.claim_template,
                                                 set()).add(e.name)
            # workload churn (spec edits, slo telemetry status writes)
            # wakes any canary judging this workload
            q.add_all("CanaryRollout", self._canary_refs.get(e.name, ()))
        elif kind == "ResourceSlice":
            if slice_nodes is not None:
                slice_nodes.add(e.object.spec.node)
            else:
                self._requeue_claims_for_nodes({e.object.spec.node})
        elif kind == "DeviceClass":
            # class (re)definition changes what every claim can match
            q.add_all("ResourceClaim",
                      (o.meta.name for o in
                       self.store.list_objects("ResourceClaim")))
        elif kind == "ResourceClaimTemplate":
            q.add_all("Workload", self._template_owners.get(e.name, ()))
            if e.type == DELETED:
                live = {w for w in self._template_owners.get(e.name, ())
                        if self._wl_refs.get(w, ("", ""))[1] == e.name}
                if live:
                    self._template_owners[e.name] = live
                else:
                    self._template_owners.pop(e.name, None)
        elif kind == "Node":
            if e.type == DELETED:
                q.forget(kind, e.name)
                self._failure_gen.pop((kind, e.name), None)
                self._draining_nodes.discard(e.name)
            else:
                q.add(kind, e.name)
                if e.object.spec.drain:
                    self._draining_nodes.add(e.name)
                else:
                    self._draining_nodes.discard(e.name)
                if e.object.is_true(CONDITION_READY):
                    # a Ready node can take claims the scheduler found no
                    # node for: under threaded workers a claim can be
                    # scheduled before the lifecycle controller has
                    # judged a freshly registered node Ready
                    q.add_all("ResourceClaim",
                              [n for n in self._blocked_claims
                               if self.store.try_get("ResourceClaim", n)
                               is not None])
        elif kind == "DisruptionBudget":
            if e.type == DELETED:
                q.forget(kind, e.name)
                self._failure_gen.pop((kind, e.name), None)
            else:
                q.add(kind, e.name)
            # a budget edit can admit evictions a drain is waiting on
            q.add_all("Node", self._draining_nodes)
        elif kind == "CanaryRollout":
            prev_wl = self._canary_target.get(e.name, "")
            if prev_wl and prev_wl != e.object.spec.workload:
                self._canary_refs.get(prev_wl, set()).discard(e.name)
            if e.type == DELETED:
                q.forget(kind, e.name)
                self._failure_gen.pop((kind, e.name), None)
                self._canary_target.pop(e.name, None)
                self._canary_refs.get(e.object.spec.workload,
                                      set()).discard(e.name)
            else:
                q.add(kind, e.name)
                target = e.object.spec.workload
                self._canary_target[e.name] = target
                self._canary_refs.setdefault(target, set()).add(e.name)
        elif kind == "Lease":
            # every lease write (heartbeat, takeover, forced expiry)
            # re-examines the guarded node; lease name == node name
            q.add("Node", e.name)

    def _update_backoff(self, kind: str, name: str, obj: ApiObject) -> None:
        """Post-reconcile bookkeeping: backoff + blocked-claim tracking."""
        if kind == "ResourceClaim":
            if obj.is_true(CONDITION_ALLOCATED, current=True):
                self._blocked_claims.discard(name)
            else:
                self._blocked_claims.add(name)
        failing = any(c.status == FALSE and c.reason in RETRYABLE_REASONS
                      and c.observed_generation == obj.meta.generation
                      for c in obj.status.conditions)
        if failing:
            self._failure_gen[(kind, name)] = obj.meta.generation
            self.queue.failure(kind, name)
        else:
            self._failure_gen.pop((kind, name), None)
            self.queue.success(kind, name)

    def _requeue_on_released_capacity(self) -> None:
        """Freed devices may unblock pending claims — requeue them.

        Releases reach the pool through paths that emit no watch event a
        blocked claim could see (claim deletion, replica scale-down,
        direct deallocate), so the event loop watches the pool's
        release generation. Only releases can unblock a claim —
        allocations never can — and only claims already settled in a
        not-Allocated state (``_blocked_claims``) can benefit, so this
        stays O(blocked) per release, O(1) otherwise.
        """
        gen = self.registry.pool.release_generation
        if gen == self._seen_release_gen:
            return
        self._seen_release_gen = gen
        for name in self._blocked_claims:
            if self.store.try_get("ResourceClaim", name) is not None:
                self.queue.add("ResourceClaim", name)

    def _pump_events(self) -> None:
        slice_nodes: Set[str] = set()
        for e in self._watch.poll():
            self._route_event(e, slice_nodes)
            # a spec edit invalidates any backoff from an older generation:
            # the user changed intent, re-examine immediately
            key = (e.kind, e.name)
            if (key in self._failure_gen
                    and e.object.meta.generation != self._failure_gen[key]):
                self._failure_gen.pop(key, None)
                self.queue.success(e.kind, e.name)
        if slice_nodes:
            self._requeue_claims_for_nodes(slice_nodes)
        self._requeue_expired_leases()

    # -- reconciliation ----------------------------------------------------
    def reconcile(self, max_rounds: int = 64, mode: Optional[str] = None) -> int:
        """Run controllers to a fixpoint; returns rounds taken.

        ``mode`` (default: the plane's ``reconcile_mode``):

        * ``"event"`` — watch events route into per-kind dirty queues
          with dependency edges; each round reconciles only dirty
          objects. O(changes), not O(objects).
        * ``"sweep"`` — the PR-1 full sweep, kept as the reference arm
          for the scale benchmark and equivalence tests.
        """
        mode = mode or self.reconcile_mode
        if mode not in self.RECONCILE_MODES:
            raise ValueError(f"unknown reconcile mode {mode!r}")
        if self.informer is not None and self.informer.running:
            raise RuntimeError(
                "reconcile() called while a ControlPlaneRuntime informer "
                "is running; use plane.informer.wait_ready/wait_quiesce "
                "(or stop the runtime first)")
        try:
            with self.reconcile_lock:
                if mode == "sweep":
                    return self._reconcile_sweep(max_rounds)
                # "inline" is the blocking reference arm of the threaded
                # runtime — same event loop, driven by the caller
                return self._reconcile_events(max_rounds)
        finally:
            # batched durability: the journal flushes once a worthwhile
            # window has accumulated (also on the error path, so a crash
            # report reflects journaled reality); journal.sync() is the
            # hard barrier for callers that need one
            if self.journal is not None:
                self.journal.maybe_flush()

    def _reconcile_events(self, max_rounds: int) -> int:
        for round_no in range(1, max_rounds + 1):
            self.sync_inventory()
            self._pump_events()
            self._requeue_on_released_capacity()
            batch = self.queue.pop_ready(self._kind_order)
            if not batch:
                if self._watch.pending:
                    continue            # sync/self-writes produced events
                if self.queue.fast_forward():
                    continue            # everything dirty is in backoff
                return round_no
            done = 0
            try:
                for kind, name in batch:
                    obj = self.store.try_get(kind, name)
                    if obj is None:
                        self.queue.forget(kind, name)
                        done += 1
                        continue
                    for ctl in self._by_kind.get(kind, ()):
                        self.reconcile_calls += 1
                        ctl.reconcile(self, obj)
                        if self.store.try_get(kind, name) is None:
                            break       # deleted by an earlier controller
                    else:
                        self._update_backoff(kind, name, obj)
                    done += 1
            except BaseException:
                # pop_ready removed the batch from the dirty sets; an
                # escaping controller error must not lose the key being
                # processed or the unprocessed tail (the sweep loop's
                # re-list-everything behavior made this free)
                for kind, name in batch[done:]:
                    self.queue.add(kind, name)
                raise
        self._pump_events()             # surface the last round's churn
        raise self._nonconvergence_error(max_rounds, self.queue.pending())

    def _reconcile_sweep(self, max_rounds: int) -> int:
        last_changed: List[Tuple[str, str]] = []
        for round_no in range(1, max_rounds + 1):
            self.sync_inventory()
            # drain this round's baseline — still routed, so dependency
            # indexes (and the dirty queue) stay coherent if the same
            # plane later reconciles in event mode
            self._pump_events()
            changed = False
            last_changed = []
            for ctl in self.controllers:
                for obj in list(self.store.list_objects(ctl.kind)):
                    if self.store.try_get(obj.meta.kind, obj.meta.name) is None:
                        continue        # deleted by an earlier controller
                    self.reconcile_calls += 1
                    if bool(ctl.reconcile(self, obj)):
                        changed = True
                        last_changed.append((obj.meta.kind, obj.meta.name))
            if not changed and not self._watch.pending:
                return round_no
        raise self._nonconvergence_error(max_rounds, last_changed)

    def _dirty_detail(self, dirty: List[Tuple[str, str]]) -> str:
        """Per-object diagnostic lines: condition summary + the last
        condition transition. Shared by the inline loop's
        non-convergence error and the runtime's wait_ready timeout."""
        now = time.monotonic()
        lines = []
        for kind, name in sorted(set(dirty)):
            obj = self.store.try_get(kind, name)
            if obj is None:
                lines.append(f"  {kind}/{name}: <deleted>")
                continue
            conds = obj.status.conditions
            last = max(conds, key=lambda c: c.last_transition, default=None)
            detail = (f"last transition {last.type}={last.status} "
                      f"({last.reason or 'no reason'}) "
                      f"{now - last.last_transition:.3f}s ago"
                      if last else "no conditions yet")
            lines.append(f"  {kind}/{name}[g{obj.meta.generation}]: "
                         f"{obj.conditions_summary()}; {detail}")
        return "\n".join(lines) or "  <no dirty objects recorded>"

    def _nonconvergence_error(self, max_rounds: int,
                              dirty: List[Tuple[str, str]]) -> RuntimeError:
        """Name the objects still churning + their last condition moves."""
        return RuntimeError(
            f"reconcile did not converge in {max_rounds} rounds; "
            f"{len(set(dirty))} object(s) still dirty:\n"
            f"{self._dirty_detail(dirty)}")

    def wait_for(self, kind: str, name: str,
                 condition: str = CONDITION_READY) -> ApiObject:
        """Reconcile until ``condition`` is True for the current spec.

        Synchronous analogue of `kubectl wait --for=condition=...`:
        raises with the object's condition summary if the controllers
        reach a fixpoint without converging. With a running informer
        runtime attached, delegates to its condition-waiter future
        (convergence happens in the background threads).
        """
        if self.informer is not None and self.informer.running:
            # generous budget: the inline path had no timeout at all, and
            # entry points run on loaded machines (kernels build next door)
            return self.informer.wait_ready(kind, name, condition=condition,
                                            timeout=600.0)
        self.reconcile()
        obj = self.store.get(kind, name)
        if not obj.is_true(condition, current=True):
            raise RuntimeError(
                f"{kind}/{name} did not reach {condition}=True: "
                f"{obj.conditions_summary()}")
        if self.journal is not None:
            # convergence the caller observed is convergence that must
            # survive a crash — drain the window regardless of batch size
            self.journal.flush()
        return obj

    # -- claim teardown helpers (controller internals) ---------------------
    def is_prepared(self, claim: ResourceClaim) -> bool:
        return any(claim.uid in d.prepared
                   for d in self.registry.drivers.values())

    def unprepare(self, claim: ResourceClaim) -> None:
        involved = [d for d in self.registry.drivers.values()
                    if claim.uid in d.prepared]
        for d in involved:
            d.node_unprepare_resources(claim)
        if involved:
            self.registry.bus.publish(Events.NODE_UNPREPARE_RESOURCES,
                                      claim=claim)

    # -- telemetry ---------------------------------------------------------
    def record_phase_latencies(self, obj: ApiObject,
                               claims: List[ApiObject]) -> Dict[str, float]:
        """Per-phase wall time from condition transition timestamps."""
        stamps: Dict[str, float] = {}
        for phase in PHASE_ORDER:
            cands = [c.condition(phase) for c in ([obj] + claims)]
            times = [c.last_transition for c in cands if c is not None and c.true]
            if times:
                stamps[phase] = max(times)
        lat: Dict[str, float] = {}
        prev = obj.meta.created
        for phase in PHASE_ORDER:
            if phase in stamps:
                lat[phase] = max(stamps[phase] - prev, 0.0)
                prev = stamps[phase]
        lat["total"] = max(prev - obj.meta.created, 0.0)
        self.phase_latencies[obj.meta.name] = lat
        return lat

    # -- convenience accessors --------------------------------------------
    def output(self, name: str, key: str, kind: str = "Workload") -> Any:
        return self.store.get(kind, name).status.outputs.get(key)

    def mesh(self, workload: str) -> Any:
        return self.output(workload, "mesh")

    def plan(self, workload: str) -> Any:
        return self.output(workload, "plan")
