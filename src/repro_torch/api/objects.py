"""Typed API objects: metadata envelope, conditions, and the Workload.

The paper's architectural thesis (§II–§III) is that KNDs work because
networking state lives in *declarative, versioned API objects* that
controllers reconcile — not in imperative call chains. This module is
the object model for that control plane:

* :class:`ObjectMeta` — Kubernetes-style metadata: name/uid/labels plus
  ``resource_version`` (bumped on *every* write, the watch cursor) and
  ``generation`` (bumped on *spec* writes only, the reconciler's "did
  the user change intent?" signal).
* :class:`Condition` — typed status conditions (``Allocated``,
  ``Prepared``, ``Attached``, ``Ready``) with observed generation, so a
  condition can be "True, but for an older spec".
* :class:`Workload` — the one genuinely new object: a declarative
  description of a job / serve replica set. It names a ResourceClaim
  (or stamps claims from a ResourceClaimTemplate, one per replica) and
  the logical mesh it wants; the controllers converge the cluster onto
  it.

The DRA payloads themselves (:class:`~repro_torch.core.claims.ResourceClaim`,
``DeviceClass``, ``ResourceSlice``, ``ResourceClaimTemplate``) are the
existing core dataclasses — the store wraps them in an
:class:`ApiObject` envelope rather than duplicating them.

The port's own copy of the JAX package's ``api/objects.py`` (pure
Python; the port imports nothing of that package).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..core.uid import new_uid

__all__ = [
    "TRUE", "FALSE", "UNKNOWN",
    "Condition", "ObjectMeta", "ObjectStatus", "ApiObject", "Workload",
    "Node", "Lease", "DisruptionBudget", "CanaryRollout",
    "CONDITION_ALLOCATED", "CONDITION_PREPARED", "CONDITION_ATTACHED",
    "CONDITION_READY", "CONDITION_SCHEDULED", "PHASE_ORDER",
]

# Condition status values (Kubernetes uses strings, not booleans, so a
# condition can be Unknown — e.g. "not reconciled yet").
TRUE = "True"
FALSE = "False"
UNKNOWN = "Unknown"

# The claim/workload lifecycle, in order. Controllers drive objects
# through these; per-phase latency is measured between transitions.
CONDITION_ALLOCATED = "Allocated"
CONDITION_PREPARED = "Prepared"
CONDITION_ATTACHED = "Attached"
CONDITION_READY = "Ready"
PHASE_ORDER = (CONDITION_ALLOCATED, CONDITION_PREPARED,
               CONDITION_ATTACHED, CONDITION_READY)
# Set by the SchedulerController on claims placed onto nodes before
# allocation (node plane only; kept out of PHASE_ORDER so existing
# phase-latency outputs are unchanged when no nodes exist).
CONDITION_SCHEDULED = "Scheduled"


@dataclass
class Condition:
    """One typed status condition (mirrors ``metav1.Condition``)."""

    type: str
    status: str = UNKNOWN
    reason: str = ""
    message: str = ""
    observed_generation: int = 0
    last_transition: float = field(default_factory=time.monotonic)

    @property
    def true(self) -> bool:
        return self.status == TRUE

    def same_state(self, other: "Condition") -> bool:
        """Equal ignoring the transition timestamp (idempotent writes)."""
        return (self.type == other.type and self.status == other.status
                and self.reason == other.reason
                and self.message == other.message
                and self.observed_generation == other.observed_generation)


@dataclass
class ObjectMeta:
    name: str
    kind: str = ""
    uid: str = field(default_factory=new_uid)
    resource_version: int = 0    # bumped on every write (watch cursor)
    generation: int = 1          # bumped on spec writes only
    labels: Dict[str, str] = field(default_factory=dict)
    created: float = field(default_factory=time.monotonic)


@dataclass
class ObjectStatus:
    """The status subresource: conditions + free-form controller outputs."""

    conditions: List[Condition] = field(default_factory=list)
    # Reconciler outputs keyed by name (e.g. 'plan', 'mesh', 'attachment',
    # 'claims', 'phase_latency_s'). Kept out of spec: status is derived
    # state, rebuildable by re-running the controllers.
    outputs: Dict[str, Any] = field(default_factory=dict)

    def condition(self, type_: str) -> Optional[Condition]:
        for c in self.conditions:
            if c.type == type_:
                return c
        return None


@dataclass
class ApiObject:
    """Envelope stored by :class:`~repro_torch.api.store.ApiStore`.

    ``spec`` is the typed payload (a core DRA object or a
    :class:`Workload`); the envelope owns versioning and status.
    """

    meta: ObjectMeta
    spec: Any
    status: ObjectStatus = field(default_factory=ObjectStatus)

    def condition(self, type_: str) -> Optional[Condition]:
        return self.status.condition(type_)

    def is_true(self, type_: str, *, current: bool = False) -> bool:
        """Is the condition True (and, if ``current``, for this generation)?"""
        c = self.condition(type_)
        if c is None or not c.true:
            return False
        return (not current) or c.observed_generation == self.meta.generation

    def conditions_summary(self) -> str:
        return " ".join(f"{c.type}={c.status}"
                        f"@g{c.observed_generation}" for c in
                        self.status.conditions) or "<no conditions>"


@dataclass
class Workload:
    """Declarative description of a job or serve replica set.

    Exactly one of ``claim`` / ``claim_template`` is set:

    * ``claim``: the workload owns one named ResourceClaim and (when
      ``axes`` is non-empty) wants it planned into a logical mesh and
      attached — the training-job shape.
    * ``claim_template``: the workload stamps ``replicas`` claims from a
      ResourceClaimTemplate — the paper's StatefulSet/serve-replica
      shape. Scale up/down is a ``replicas`` spec edit the reconciler
      converges on.

    Template workloads update by *rolling replacement* rather than
    replace-on-edit: a template or ``runtime_config`` change gives the
    replica set a new revision, and the controller replaces claims one
    bounded step at a time — at most ``max_surge`` extra claims exist
    and at most ``max_unavailable`` desired replicas are non-Ready at
    any observable store state (Deployment rolling-update semantics).
    ``canary_config``/``canary_replicas`` carve out a replica subset
    running an overlayed config, watched by the CanaryController.
    """

    claim: str = ""
    claim_template: str = ""
    # Logical mesh request (planner input); empty = claim-only workload.
    axes: List[Any] = field(default_factory=list)      # List[AxisSpec]
    placement: str = "aligned"
    seed: int = 0
    role: str = "train"            # 'train' | 'serve'
    replicas: int = 1
    # Execute the AttachmentSpec through MeshRuntime (needs a process
    # group with one rank per binding). False still emits the spec.
    build_mesh: bool = True
    # Rolling-update strategy (template workloads): how many claims may
    # exist beyond `replicas` during an update, and how many desired
    # replicas may be non-Ready at any observable store state.
    max_surge: int = 1
    max_unavailable: int = 0
    # Runtime configuration (model/kernel knobs) folded into the replica
    # revision: editing it triggers a rolling replacement, exactly like
    # a template edit.
    runtime_config: Dict[str, Any] = field(default_factory=dict)
    # Canary overlay: `canary_replicas` of the set run with
    # runtime_config | canary_config; the CanaryController promotes or
    # rolls back based on SLO telemetry.
    canary_config: Dict[str, Any] = field(default_factory=dict)
    canary_replicas: int = 0

    def __post_init__(self) -> None:
        if bool(self.claim) == bool(self.claim_template):
            raise ValueError(
                "Workload needs exactly one of claim / claim_template")
        if self.claim_template and self.axes:
            raise ValueError(
                "axes (mesh planning) requires a single-claim workload; "
                "template replica sets are not planned into one mesh")
        if self.replicas < 1:
            raise ValueError("replicas must be >= 1")
        if self.max_surge < 0 or self.max_unavailable < 0:
            raise ValueError("max_surge/max_unavailable must be >= 0")
        if self.max_surge + self.max_unavailable < 1:
            raise ValueError(
                "max_surge + max_unavailable must be >= 1 or a rolling "
                "update can make no progress")
        if not 0 <= self.canary_replicas <= self.replicas:
            raise ValueError(
                "canary_replicas must be between 0 and replicas")
        if self.canary_replicas and not self.canary_config:
            raise ValueError("canary_replicas requires a canary_config")


@dataclass
class Node:
    """One cluster host, registered and heartbeat-kept by its NodeAgent.

    The DraNet-daemon analogue made explicit: a node is an API object
    whose ``Ready`` condition the :class:`NodeLifecycleController`
    derives from the freshness of the node's :class:`Lease`. Slices,
    prepares and attachments for the node's devices are owned by the
    agent; when the lease lapses the controller withdraws the node's
    inventory and the claims on it are evicted + rescheduled.
    """

    name: str
    # agent identity last holding this node (matches Lease.holder)
    provider: str = ""
    # cordoned: stays Ready (inventory kept) but the scheduler skips it,
    # the first half of node maintenance
    unschedulable: bool = False
    # draining: cordon plus budget-aware eviction of the claims placed
    # here (the DrainController's trigger); the node reports a Drained
    # condition once no claim holds its devices
    drain: bool = False
    pod: int = 0


@dataclass
class Lease:
    """A ``coordination.k8s.io``-style lease guarding one node's liveness.

    ``acquired`` (spec) is the registration wall-clock time; renewals
    are *status* writes (``outputs["renew_time"]``) so a heartbeat bumps
    only the resource version, never the spec generation. Wall-clock
    (not monotonic) on purpose: timestamps must stay comparable across
    control-plane restarts, where a recovered lease is stale until its
    agent re-registers.
    """

    name: str                  # == the node name (1:1)
    holder: str = ""
    duration_s: float = 1.0
    acquired: float = 0.0


@dataclass
class DisruptionBudget:
    """Bound on *voluntary* disruption for a set of claims (PDB analogue).

    ``selector`` matches claim labels (e.g. ``{"workload": "serve"}``);
    a voluntary eviction (drain, canary teardown) of a Ready matching
    claim is refused whenever it would leave fewer than ``min_available``
    Ready claims in the matched set. Involuntary failures (lease expiry,
    node SIGKILL) bypass budgets, exactly as in Kubernetes.
    """

    name: str
    selector: Dict[str, str] = field(default_factory=dict)
    min_available: int = 0

    def __post_init__(self) -> None:
        if not self.selector:
            raise ValueError("DisruptionBudget needs a non-empty selector")
        if self.min_available < 0:
            raise ValueError("min_available must be >= 0")


@dataclass
class CanaryRollout:
    """Declarative canary: try ``config`` on ``replicas`` of a workload.

    The CanaryController overlays ``config`` onto the target workload's
    canary slot, waits for at least ``min_samples`` SLO observations per
    arm from the serve plane, and then either *promotes* (folds the
    config into ``runtime_config`` for every replica) or *rolls back*
    (restores the workload spec byte-identically to its pre-canary
    form) when any ``slo`` ceiling is breached.
    """

    name: str
    workload: str = ""
    config: Dict[str, Any] = field(default_factory=dict)
    replicas: int = 1
    # metric ceilings, e.g. {"p95_latency_ms": 50.0, "error_rate": 0.01}
    slo: Dict[str, float] = field(default_factory=dict)
    min_samples: int = 8

    def __post_init__(self) -> None:
        if not self.workload:
            raise ValueError("CanaryRollout needs a target workload")
        if not self.config:
            raise ValueError("CanaryRollout needs a non-empty config")
        if self.replicas < 1:
            raise ValueError("canary replicas must be >= 1")
        if self.min_samples < 1:
            raise ValueError("min_samples must be >= 1")
