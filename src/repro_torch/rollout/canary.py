"""CanaryController: config canaries with automatic SLO rollback.

A :class:`~repro_torch.api.objects.CanaryRollout` names a workload, a config
overlay and SLO ceilings. The controller:

1. snapshots the workload spec (canonical JSON — the byte-identical
   restore target), then deploys the overlay onto
   ``canary_replicas``/``canary_config`` of the workload, which the
   rolling WorkloadController converges bounded by the workload's own
   surge/unavailability strategy;
2. watches the SLO telemetry the serve plane publishes into the
   workload's ``outputs["slo"]`` (see :mod:`repro_torch.serve.slo`);
3. once ``min_samples`` canary observations exist, **promotes** (folds
   the overlay into ``runtime_config`` — the canary claims' revision
   *becomes* the base revision, so they survive promotion untouched)
   or **rolls back** on any breached ceiling, restoring the snapshot
   byte-identically.

Every phase transition is crash-idempotent: the phase is recorded in
status *before* the workload edit it implies, and a re-reconcile in
any phase re-applies the edit if (and only if) the overlay state does
not match the phase — a worker killed between the two writes converges
to the same place.

The port's own copy of the JAX package's ``rollout/canary.py`` (pure
Python; the port imports nothing of that package). It counts phase
transitions in a plain dict.
"""

from __future__ import annotations

import json
from typing import TYPE_CHECKING, Any, Dict, Optional

from ..api.chaos import sync_point
from ..api.controllers import Controller
from ..api.objects import ApiObject, CanaryRollout, CONDITION_READY, Workload

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..api.controllers import ControlPlane

__all__ = ["CanaryController", "spec_blob"]

PHASE_DEPLOYED = "Deployed"
PHASE_PROMOTED = "Promoted"
PHASE_ROLLED_BACK = "RolledBack"

def spec_blob(spec: Workload) -> str:
    """Canonical JSON for a workload spec — the byte-identity yardstick."""
    from ..api.persistence import encode
    return json.dumps(encode(spec), sort_keys=True)


class CanaryController(Controller):
    kind = "CanaryRollout"
    name = "canary-controller"

    def __init__(self) -> None:
        # phase -> transitions recorded (plain counts)
        self.transitions: Dict[str, int] = {}

    def _count_transition(self, phase: str) -> None:
        self.transitions[phase] = self.transitions.get(phase, 0) + 1

    # -- overlay edits (all idempotent) ------------------------------------
    @staticmethod
    def _overlay_applied(wl: Workload, spec: CanaryRollout) -> bool:
        return (wl.canary_replicas == spec.replicas
                and wl.canary_config == spec.config)

    def _apply_overlay(self, plane: "ControlPlane", wl_name: str,
                       spec: CanaryRollout) -> None:
        def edit(wl: Workload) -> None:
            wl.canary_config = dict(spec.config)
            wl.canary_replicas = spec.replicas
        plane.store.update_spec("Workload", wl_name, edit)

    def _promote(self, plane: "ControlPlane", wl_name: str,
                 spec: CanaryRollout) -> None:
        def edit(wl: Workload) -> None:
            wl.runtime_config = {**wl.runtime_config, **spec.config}
            wl.canary_config = {}
            wl.canary_replicas = 0
        plane.store.update_spec("Workload", wl_name, edit)

    def _restore(self, plane: "ControlPlane", wl_name: str,
                 prior: str) -> None:
        from ..api.persistence import decode
        restored = decode(json.loads(prior))
        plane.store.update_spec("Workload", wl_name,
                                lambda _old, new=restored: new)

    # -- verdict -----------------------------------------------------------
    @staticmethod
    def _breach(spec: CanaryRollout, canary_slo: Dict[str, Any],
                baseline_slo: Optional[Dict[str, Any]] = None
                ) -> Optional[Dict[str, Any]]:
        """First breached ceiling, or None.

        Two ceiling forms: plain ``{"p95_latency_ms": 50.0}`` compares
        the canary arm against an absolute value; relative
        ``{"p95_latency_ms_vs_baseline": 1.5}`` compares the canary's
        metric against ``ceiling x`` the *baseline arm's* same metric —
        the robust form when absolute numbers drift with machine load
        but both arms drift together.
        """
        baseline_slo = baseline_slo or {}
        suffix = "_vs_baseline"
        for metric in sorted(spec.slo):
            ceiling = spec.slo[metric]
            if metric.endswith(suffix):
                base_metric = metric[:-len(suffix)]
                observed = canary_slo.get(base_metric)
                baseline = baseline_slo.get(base_metric)
                if (observed is not None and baseline is not None
                        and baseline > 0 and observed > ceiling * baseline):
                    return {"metric": metric, "ceiling": ceiling,
                            "observed": observed, "baseline": baseline}
                continue
            observed = canary_slo.get(metric)
            if observed is not None and observed > ceiling:
                return {"metric": metric, "ceiling": ceiling,
                        "observed": observed}
        return None

    # -- reconcile ---------------------------------------------------------
    def reconcile(self, plane: "ControlPlane", obj: ApiObject) -> bool:
        spec: CanaryRollout = obj.spec
        store = plane.store
        state = obj.status.outputs.get("canary", {})
        phase = state.get("phase", "")
        wl_obj = store.try_get("Workload", spec.workload)
        if wl_obj is None:
            return self._set(plane, obj, CONDITION_READY, False,
                             "WorkloadMissing",
                             f"no Workload {spec.workload!r}")
        wl: Workload = wl_obj.spec
        if not wl.claim_template:
            return self._set(plane, obj, CONDITION_READY, False,
                             "NotATemplateWorkload",
                             "canaries need a template replica set")
        if spec.replicas > wl.replicas:
            return self._set(plane, obj, CONDITION_READY, False,
                             "CanaryTooLarge",
                             "canary replicas exceed workload replicas")

        if phase == PHASE_PROMOTED:
            if self._overlay_applied(wl, spec):
                # killed between phase write and the promote edit
                self._promote(plane, spec.workload, spec)
                return True
            return self._set(plane, obj, CONDITION_READY, True, "Promoted",
                             "overlay folded into runtime_config")
        if phase == PHASE_ROLLED_BACK:
            if self._overlay_applied(wl, spec):
                # killed between phase write and the restore edit
                self._restore(plane, spec.workload, state["prior_spec"])
                return True
            verdict = state.get("verdict", {})
            metric = verdict.get("metric", "")
            return self._set(plane, obj, CONDITION_READY, True, "RolledBack",
                             f"slo ceiling breached: {metric}; prior spec "
                             f"restored")

        if not phase:
            prior = spec_blob(wl)
            sync_point("rollout.canary", killable=True,
                       canary=obj.meta.name, phase=PHASE_DEPLOYED)
            store.update_status(
                "CanaryRollout", obj.meta.name,
                lambda st, p=prior: st.outputs.__setitem__(
                    "canary", {"phase": PHASE_DEPLOYED, "prior_spec": p}))
            self._count_transition(PHASE_DEPLOYED)
            self._apply_overlay(plane, spec.workload, spec)
            self._set(plane, obj, CONDITION_READY, False, "CanaryDeployed",
                      "overlay applied; collecting slo samples")
            return True

        # phase == Deployed: enforce the overlay, then judge once the
        # canary arm has enough samples
        if not self._overlay_applied(wl, spec):
            self._apply_overlay(plane, spec.workload, spec)
            return True
        slo_out = wl_obj.status.outputs.get("slo", {})
        canary_slo = slo_out.get("canary", {})
        baseline_slo = slo_out.get("baseline", {})
        if canary_slo.get("samples", 0) < spec.min_samples:
            return self._set(plane, obj, CONDITION_READY, False,
                             "CollectingSamples",
                             "waiting for canary slo samples")
        if (any(m.endswith("_vs_baseline") for m in spec.slo)
                and baseline_slo.get("samples", 0) < spec.min_samples):
            return self._set(plane, obj, CONDITION_READY, False,
                             "CollectingSamples",
                             "relative ceilings need baseline slo samples")
        breach = self._breach(spec, canary_slo, baseline_slo)
        verdict_phase = PHASE_ROLLED_BACK if breach else PHASE_PROMOTED
        sync_point("rollout.canary", killable=True,
                   canary=obj.meta.name, phase=verdict_phase)
        def record(st, v=breach, p=verdict_phase):
            st.outputs["canary"] = dict(st.outputs.get("canary", {}),
                                        phase=p,
                                        **({"verdict": v} if v else {}))
        store.update_status("CanaryRollout", obj.meta.name, record)
        self._count_transition(verdict_phase)
        if breach:
            self._restore(plane, spec.workload, state["prior_spec"])
        else:
            self._promote(plane, spec.workload, spec)
        return True
