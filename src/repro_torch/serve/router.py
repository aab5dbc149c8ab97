"""Front-end request router over a set of serve replicas.

Dispatch is load-aware (least engine load score, ties broken by replica
name for determinism), queueing is bounded per replica, and when every
replica's queue is full the router rejects at submit with
:class:`RouterOverloadError`. Replicas carry an *arm* tag; as requests
reach a terminal state their measured latencies feed a
:class:`~repro_torch.serve.slo.SloTracker`. :meth:`remove_replica`
drains (the engine finishes its admitted work) rather than dropping.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ..api.chaos import sync_point
from ..obs import counter, histogram
from .engine import Request, ServeEngine, ServeError
from .slo import SloTracker

__all__ = ["Router", "RouterOverloadError"]

_RTR_REJECTED = counter("plane_torch_serve_router_rejections_total",
                        "submits rejected with RouterOverloadError")
_RTR_DISPATCH = counter("plane_torch_serve_router_dispatch_total",
                        "submits dispatched to a replica")
# Arm cardinality is the rollout plane's revision labels
# (baseline/canary) — bounded by construction.
_RTR_TTFT = histogram("plane_torch_serve_ttft_seconds",
                      "time to first token, per arm", labels=("arm",))
_RTR_TPOT = histogram("plane_torch_serve_tpot_seconds",
                      "time per output token over decode, per arm",
                      labels=("arm",))
_RTR_LATENCY = histogram("plane_torch_serve_request_latency_seconds",
                         "submit -> terminal end-to-end, per arm",
                         labels=("arm",))


class RouterOverloadError(ServeError):
    """Every replica's queue is full — the caller must back off."""


class Router:
    """Load-aware dispatch + bounded queues over named serve replicas."""

    def __init__(self, slo: Optional[SloTracker] = None, *,
                 max_queue_per_replica: int = 8):
        self.slo = slo
        self.max_queue = max_queue_per_replica
        self._replicas: Dict[str, ServeEngine] = {}
        self._arms: Dict[str, str] = {}
        self._draining: Dict[str, ServeEngine] = {}
        # per-replica (completed, failed) counts already harvested
        self._harvested: Dict[str, List[int]] = {}
        # terminal requests harvested but not yet returned by run()
        self._finished: List[Request] = []
        self.dispatched: Dict[str, int] = {}
        self.rejected = 0
        self._c_rejected = _RTR_REJECTED.cell()
        self._c_dispatch = _RTR_DISPATCH.cell()
        self._arm_cells: Dict[str, Tuple[Any, Any, Any]] = {}

    def _latency_cells(self, arm: str) -> Tuple[Any, Any, Any]:
        cells = self._arm_cells.get(arm)
        if cells is None:
            cells = self._arm_cells[arm] = (_RTR_TTFT.cell(arm=arm),
                                            _RTR_TPOT.cell(arm=arm),
                                            _RTR_LATENCY.cell(arm=arm))
        return cells

    # -- replica-set membership -------------------------------------------
    def add_replica(self, name: str, engine: ServeEngine,
                    arm: str = "baseline") -> None:
        if name in self._replicas:
            raise ValueError(f"replica {name} already registered")
        self._replicas[name] = engine
        self._arms[name] = arm
        self._harvested[name] = [len(engine.completed), len(engine.failed)]
        self.dispatched.setdefault(name, 0)

    def remove_replica(self, name: str) -> None:
        """Stop routing to the replica; it keeps draining admitted work
        until idle."""
        eng = self._replicas.pop(name)
        if eng.has_work():
            self._draining[name] = eng
        else:
            self._harvest(name, eng)
            self._harvested.pop(name, None)
            self._arms.pop(name, None)

    def replica_names(self) -> List[str]:
        return sorted(self._replicas)

    def arm_of(self, name: str) -> str:
        return self._arms.get(name, "baseline")

    # -- dispatch ----------------------------------------------------------
    def submit(self, prompt: List[int], max_new_tokens: int = 16,
               temperature: float = 0.0) -> Request:
        """Dispatch to the least-loaded replica with queue headroom;
        raises :class:`RouterOverloadError` when there is none."""
        if not self._replicas:
            raise RouterOverloadError("no replicas registered")
        candidates = [n for n, e in self._replicas.items()
                      if len(e.pending) < self.max_queue]
        if not candidates:
            self.rejected += 1
            self._c_rejected.inc()
            raise RouterOverloadError(
                f"all {len(self._replicas)} replica queues at "
                f"max_queue_per_replica={self.max_queue}")
        name = min(candidates,
                   key=lambda n: (self._replicas[n].load(), n))
        sync_point("router.dispatch", replica=name)
        self.dispatched[name] += 1
        self._c_dispatch.inc()
        return self._replicas[name].submit(prompt, max_new_tokens,
                                           temperature)

    # -- drive -------------------------------------------------------------
    def step(self) -> bool:
        """One tick across every replica (draining ones included);
        harvests newly terminal requests. Returns False when the whole
        set is idle."""
        busy = False
        for name, eng in list(self._replicas.items()):
            busy |= eng.step()
            self._harvest(name, eng)
        for name, eng in list(self._draining.items()):
            busy |= eng.step()
            self._harvest(name, eng)
            if not eng.has_work():
                del self._draining[name]
                self._harvested.pop(name, None)
                self._arms.pop(name, None)
        return busy

    def run(self, max_steps: int = 512) -> List[Request]:
        """Drive until idle or the step cap; returns every request that
        reached a terminal state since the previous ``run()``."""
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        if self.has_work():
            for eng in self._all_engines().values():
                eng.run(max_steps=0)    # fail leftovers with timeout
        for name, eng in self._all_engines().items():
            self._harvest(name, eng)
        out, self._finished = self._finished, []
        return out

    def has_work(self) -> bool:
        return any(e.has_work() for e in self._all_engines().values())

    # -- internals ---------------------------------------------------------
    def _all_engines(self) -> Dict[str, ServeEngine]:
        return {**self._replicas, **self._draining}

    def _harvest(self, name: str, eng: ServeEngine) -> None:
        arm = self._arms.get(name, "baseline")
        nc, nf = self._harvested.setdefault(name, [0, 0])
        h_ttft, h_tpot, h_lat = self._latency_cells(arm)
        for r in eng.completed[nc:] + eng.failed[nf:]:
            self._finished.append(r)
            if r.ttft_s is not None:
                h_ttft.observe(r.ttft_s)
            if r.tpot_s is not None:
                h_tpot.observe(r.tpot_s)
            if r.latency_s is not None:
                h_lat.observe(r.latency_s)
            if self.slo is not None:
                self.slo.observe_request(arm, r)
        self._harvested[name] = [len(eng.completed), len(eng.failed)]

    def stats(self) -> Dict[str, Dict[str, object]]:
        return {name: {"arm": self._arms.get(name, "baseline"),
                       "load": round(eng.load(), 4),
                       **eng.stats()}
                for name, eng in self._all_engines().items()}
