"""NRI-style lifecycle event bus (paper §III.B).

The port's own copy of the JAX package's ``core/nri.py`` (it is pure
Python; the port imports nothing of ``repro``).

"NRI provides a generic, event-driven plugin architecture that allows
multiple independent drivers to hook into the container runtime
lifecycle... different drivers can subscribe to pod lifecycle events and
act in parallel and without direct dependencies."

The bus carries *job* lifecycle events for the training/serving runtime.
Handlers are isolated: one driver's failure never blocks another (the
exact property CNI chaining lacks, §II). Dispatch can run handlers on a
thread pool (``parallel=True``) to make the independence literal, or
sequentially for determinism in tests — semantically both are
"parallel": no handler sees another's output, and hook results are
merged by the runtime, never chained.

Hooks are context-aware (§III.B "these hooks are not just triggers"):
every event carries the full context the driver needs — claim, plan,
step stats — so drivers never call back into the control plane on the
critical path (the Fig. 2 anti-pattern).
"""

from __future__ import annotations

import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence

__all__ = ["Event", "Events", "HookResult", "EventBus"]


class Events:
    """Well-known lifecycle events (NRI hook analogues)."""

    DISCOVERY = "Discovery"                      # drivers publish ResourceSlices
    JOB_SUBMITTED = "JobSubmitted"
    CLAIM_ALLOCATED = "ClaimAllocated"           # scheduler bound devices
    NODE_PREPARE_RESOURCES = "NodePrepareResources"  # DRA prepare (pre-critical-path)
    RUN_POD_SANDBOX = "RunPodSandbox"            # NRI: pod-level setup (network attach)
    CREATE_CONTAINER = "CreateContainer"         # NRI: container-level setup (char devs)
    STEP_BEGIN = "StepBegin"
    STEP_END = "StepEnd"
    CHECKPOINT_SAVED = "CheckpointSaved"
    NODE_FAILED = "NodeFailed"
    STRAGGLER_DETECTED = "StragglerDetected"
    JOB_RESUMED = "JobResumed"
    JOB_COMPLETED = "JobCompleted"
    NODE_UNPREPARE_RESOURCES = "NodeUnprepareResources"

    ALL = (DISCOVERY, JOB_SUBMITTED, CLAIM_ALLOCATED, NODE_PREPARE_RESOURCES,
           RUN_POD_SANDBOX, CREATE_CONTAINER, STEP_BEGIN, STEP_END,
           CHECKPOINT_SAVED, NODE_FAILED, STRAGGLER_DETECTED, JOB_RESUMED,
           JOB_COMPLETED, NODE_UNPREPARE_RESOURCES)


@dataclass
class Event:
    name: str
    context: Dict[str, Any] = field(default_factory=dict)
    timestamp: float = field(default_factory=time.monotonic)


@dataclass
class HookResult:
    driver: str
    event: str
    ok: bool
    value: Any = None
    error: Optional[str] = None
    duration_s: float = 0.0


Handler = Callable[[Event], Any]


class EventBus:
    """Publish/subscribe bus with per-driver isolation."""

    def __init__(self, parallel: bool = False, max_workers: int = 8):
        self._subs: Dict[str, List[tuple]] = {}
        self.parallel = parallel
        self.max_workers = max_workers
        self.history: List[HookResult] = []

    def subscribe(self, event: str, handler: Handler, driver: str = "?") -> None:
        self._subs.setdefault(event, []).append((driver, handler))

    def unsubscribe_driver(self, driver: str) -> None:
        for ev in list(self._subs):
            self._subs[ev] = [(d, h) for d, h in self._subs[ev] if d != driver]

    def subscribers(self, event: str) -> List[str]:
        return [d for d, _ in self._subs.get(event, [])]

    def _invoke(self, driver: str, handler: Handler, event: Event) -> HookResult:
        t0 = time.monotonic()
        try:
            value = handler(event)
            return HookResult(driver, event.name, True, value,
                              duration_s=time.monotonic() - t0)
        except Exception:  # noqa: BLE001 - isolation is the point
            return HookResult(driver, event.name, False, None,
                              error=traceback.format_exc(limit=4),
                              duration_s=time.monotonic() - t0)

    def publish(self, name: str, **context: Any) -> List[HookResult]:
        event = Event(name, context)
        subs = list(self._subs.get(name, []))
        if not subs:
            return []
        if self.parallel and len(subs) > 1:
            with ThreadPoolExecutor(max_workers=min(self.max_workers, len(subs))) as ex:
                futures = [ex.submit(self._invoke, d, h, event) for d, h in subs]
                results = [f.result() for f in futures]
        else:
            results = [self._invoke(d, h, event) for d, h in subs]
        self.history.extend(results)
        return results

    def failures(self) -> List[HookResult]:
        return [r for r in self.history if not r.ok]
