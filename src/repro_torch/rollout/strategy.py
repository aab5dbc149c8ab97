"""Pure rollout math: revisions and the bounded per-reconcile step.

Everything here is side-effect free so the rolling-update invariants
can be tested (and chaos-verified) without a store: the
:class:`~repro_torch.api.controllers.WorkloadController` feeds observed claim
state in and applies the returned :class:`RolloutPlan` one store write
at a time — each individual write preserves both bounds, so *every*
observable store state (not just fixpoints) satisfies them.

Revision model (the pod-template-hash analogue): a replica's revision
is a content hash of the ResourceClaimTemplate's spec generation plus
the runtime config it runs. Editing the template or the workload's
``runtime_config`` changes the hash and triggers a rolling
replacement; editing ``replicas`` does not (scaling is not an update).
A canary carves ``canary_replicas`` out of the set under the overlay
revision ``hash(generation, runtime_config | canary_config)`` —
promotion folds the overlay into ``runtime_config``, which makes the
base revision *equal* the canary revision, so promoted canary claims
are already current and only the old-revision remainder rolls.

The port's own copy of the JAX package's ``rollout/strategy.py`` (pure
Python; the port imports nothing of that package).
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

from ..api.objects import (ApiObject, CONDITION_ALLOCATED,
                           CONDITION_PREPARED, Workload)

__all__ = ["revision_hash", "claim_revision", "claim_ready",
           "desired_revisions", "RolloutPlan", "plan_rollout",
           "REVISION_LABEL"]

# Claim label carrying the revision a replica was stamped for.
REVISION_LABEL = "revision"


def revision_hash(template_generation: int,
                  config: Mapping[str, Any]) -> str:
    """Deterministic revision id for (template generation, config).

    JSON with sorted keys so dict insertion order never changes the
    hash; 10 hex chars like Kubernetes' pod-template-hash.
    """
    blob = json.dumps([template_generation, dict(config)],
                      sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:10]


def claim_revision(obj: ApiObject, base_revision: str) -> str:
    """Revision a claim belongs to; unlabeled claims (stamped before the
    rollout plane existed, e.g. recovered from an old WAL) are adopted
    into the current base revision rather than churned."""
    return obj.meta.labels.get(REVISION_LABEL, base_revision)


def claim_ready(obj: ApiObject) -> bool:
    """A replica counts as available once allocated + prepared for its
    current spec (the serve plane's 'can take traffic' bar)."""
    return (obj.is_true(CONDITION_ALLOCATED, current=True)
            and obj.is_true(CONDITION_PREPARED, current=True))


def desired_revisions(wl: Workload,
                      template_generation: int) -> Dict[str, int]:
    """revision -> replica count the spec asks for.

    With a canary overlay the merged config may hash equal to the base
    (an overlay that changes nothing) — the counts then collapse onto
    one revision, which is exactly right.
    """
    base = revision_hash(template_generation, wl.runtime_config)
    out = {base: wl.replicas - wl.canary_replicas}
    if wl.canary_replicas:
        canary = revision_hash(
            template_generation, {**wl.runtime_config, **wl.canary_config})
        out[canary] = out.get(canary, 0) + wl.canary_replicas
    return {rev: n for rev, n in out.items() if n > 0}


@dataclass
class RolloutPlan:
    """One bounded reconcile step against the observed claim set.

    ``delete_free`` never reduces availability (not-ready claims);
    ``delete_bounded`` are ready claims whose removal the availability
    budget admits, in order — the controller applies them first to
    last, and each single deletion keeps ready >= replicas -
    max_unavailable. ``stamp`` maps revision -> how many new claims the
    surge budget admits this step.
    """

    delete_free: List[str] = field(default_factory=list)
    delete_bounded: List[str] = field(default_factory=list)
    stamp: Dict[str, int] = field(default_factory=dict)
    # spec counts are exact and every desired replica is ready
    converged: bool = False

    @property
    def idle(self) -> bool:
        return (not self.delete_free and not self.delete_bounded
                and not self.stamp)


def plan_rollout(claims: List[Tuple[str, str, bool]],
                 desired: Mapping[str, int], *, replicas: int,
                 max_surge: int, max_unavailable: int) -> RolloutPlan:
    """Compute one rolling step from ``claims`` = [(name, revision,
    ready)] toward ``desired`` = {revision: count}.

    Invariants every applied write preserves:

    * **surge**: total claims <= replicas + max_surge (stamps stop at
      the ceiling; scale-down deletions only shrink the total);
    * **availability**: ready claims >= replicas - max_unavailable
      (ready claims are deleted only while the floor holds — counting
      *stale-revision* ready claims too, because an old replica keeps
      serving until its replacement is ready).

    Deterministic: claims are considered in sorted-name order within
    each class, so two planes observing the same state plan the same
    step (the inline-oracle equivalence the chaos tests assert).
    """
    plan = RolloutPlan()
    have: Dict[str, List[Tuple[str, bool]]] = {}
    for name, rev, ready in sorted(claims):
        have.setdefault(rev, []).append((name, ready))
    total = len(claims)
    ready_total = sum(1 for _, _, r in claims if r)

    # Excess claims, per revision: everything in an undesired revision,
    # plus surplus beyond the desired count (keep ready replicas first,
    # then lowest names — the stable prefix survives scale churn).
    excess: List[Tuple[str, bool]] = []
    for rev, members in sorted(have.items()):
        keep = desired.get(rev, 0)
        if len(members) <= keep:
            continue
        survivors = sorted(members, key=lambda m: (not m[1], m[0]))[:keep]
        kept = {name for name, _ in survivors}
        excess.extend(m for m in members if m[0] not in kept)

    floor = replicas - max_unavailable
    for name, ready in sorted(excess, key=lambda m: (m[1], m[0])):
        if not ready:
            plan.delete_free.append(name)
            total -= 1
        elif ready_total - 1 >= floor:
            plan.delete_bounded.append(name)
            ready_total -= 1
            total -= 1

    ceiling = replicas + max_surge
    for rev in sorted(desired):
        deficit = desired[rev] - min(len(have.get(rev, ())),
                                     desired[rev])
        admit = min(deficit, max(0, ceiling - total))
        if admit > 0:
            plan.stamp[rev] = admit
            total += admit

    plan.converged = (plan.idle
                      and {rev: len(m) for rev, m in have.items()
                           if m} == dict(desired)
                      and all(r for _, _, r in claims))
    return plan
