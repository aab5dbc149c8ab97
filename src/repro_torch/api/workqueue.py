"""Work queue for event-driven reconciliation: dirty sets + backoff.

A sweep loop re-examines every object of every kind each
round — O(rounds × objects) even when one claim changed. This module is
the client-go-shaped alternative: watch events route into per-kind
*dirty queues*; a reconcile round pops only dirty objects. Dependency
edges (claim ↔ owning workload, slice → affected claims) live in the
:class:`~repro_torch.api.controllers.ControlPlane`, which translates one
event into the set of keys that must be re-examined.

Rate limiting is per-object exponential backoff measured in reconcile
*rounds* (the loop's native clock — no wall-clock sleeps, so tests stay
deterministic and fast). The queue does not self-schedule retries —
level-triggered reconciliation retries when an *event* (slice change,
freed capacity, spec edit) requeues the object; backoff only gates how
soon such a requeue is admitted for an object that has been failing,
with the window growing 1, 2, 4, … rounds per consecutive failure.
Healthy objects are never delayed. When everything pending is inside a
backoff window and no new events exist, the loop fast-forwards the
clock to the earliest deadline instead of spinning through empty
rounds.

The port's own copy of the JAX package's ``api/workqueue.py``, with its
instruments named ``plane_torch_workqueue_*``.
"""

from __future__ import annotations

import threading
import zlib
from typing import Dict, Iterable, List, Optional, Tuple

from ..obs import active, counter, gauge, histogram
from .chaos import sync_point

__all__ = ["WorkQueue"]

Key = Tuple[str, str]  # (kind, name)

# Registry instruments (docs/OBSERVABILITY.md). These are *sampled*:
# every queue mutation already runs under the plane's reconcile lock,
# so the hot path counts in plain ints and mirrors them into the cells
# from a registry collect hook — exporters see the same totals, the
# per-operation cost is an integer add in both the enabled and the
# disabled arm, and telemetry() reads the plain ints (always exact).
_WQ_ENQUEUED = counter("plane_torch_workqueue_enqueued_total",
                       "objects accepted into the dirty queue")
_WQ_POPPED = counter("plane_torch_workqueue_popped_total",
                     "keys admitted to a reconcile round")
_WQ_DEFERRED = counter("plane_torch_workqueue_deferred_total",
                       "pop attempts parked by a backoff window")
_WQ_REQUEUES = counter("plane_torch_workqueue_requeues_total",
                       "keys re-dirtied after having been popped")
_WQ_DEPTH = gauge("plane_torch_workqueue_depth",
                  "queued keys (ready or in backoff)")
_WQ_BACKOFF = histogram("plane_torch_workqueue_backoff_rounds",
                        "backoff delay applied per reconcile failure",
                        buckets=(1, 2, 4, 8, 16, 32, 64))


class WorkQueue:
    """Deduplicated dirty queue with per-object exponential backoff."""

    def __init__(self, backoff_base: int = 1, backoff_cap: int = 16):
        # kind -> {name: insertion order} — dict doubles as an ordered set
        self._dirty: Dict[str, Dict[str, None]] = {}
        self._failures: Dict[Key, int] = {}
        self._not_before: Dict[Key, int] = {}   # key -> earliest round
        self._clock = 0                         # current round number
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        # telemetry: plain ints on the hot path (mutations are serialized
        # by the plane's reconcile lock), mirrored into this queue's
        # registry cells only when an exporter collects (_flush_obs).
        # _n_requeues counts keys re-dirtied after having been popped at
        # least once — the numerator of the requeue rate.
        self._n_enqueued = 0
        self._n_popped = 0
        self._n_deferred = 0
        self._n_requeues = 0
        self._popped_once: Dict[Key, None] = {}
        self._c_enqueued = _WQ_ENQUEUED.cell()
        self._c_popped = _WQ_POPPED.cell()
        self._c_deferred = _WQ_DEFERRED.cell()
        self._c_requeues = _WQ_REQUEUES.cell()
        self._g_depth = _WQ_DEPTH.cell()
        self._h_backoff = _WQ_BACKOFF.cell()
        self._flushed = [0, 0, 0, 0]
        self._flush_lock = threading.Lock()
        if self._c_enqueued.enabled:
            active().add_collect_hook(self._flush_obs)

    def _flush_obs(self) -> None:
        """Mirror the plain-int telemetry into the registry cells.

        Collect hook: runs when an exporter reads, never on the hot
        path. Serialized against concurrent collects by its own lock;
        deltas keep the cumulative cells exact at every flush.
        """
        with self._flush_lock:
            pairs = ((self._n_enqueued, self._c_enqueued),
                     (self._n_popped, self._c_popped),
                     (self._n_deferred, self._c_deferred),
                     (self._n_requeues, self._c_requeues))
            for i, (n, cell) in enumerate(pairs):
                d = n - self._flushed[i]
                if d:
                    cell.inc(d)
                    self._flushed[i] = n
            self._g_depth.set(len(self))

    # read-only views of the plain-int telemetry
    @property
    def enqueued(self) -> int:
        return self._n_enqueued

    @property
    def popped(self) -> int:
        return self._n_popped

    @property
    def deferred(self) -> int:
        return self._n_deferred

    @property
    def requeues(self) -> int:
        return self._n_requeues

    # -- enqueue -------------------------------------------------------------
    def add(self, kind: str, name: str) -> None:
        """Mark (kind, name) dirty; idempotent while already queued."""
        sync_point("workqueue.add", kind=kind, name=name)
        bucket = self._dirty.setdefault(kind, {})
        if name not in bucket:
            bucket[name] = None
            self._n_enqueued += 1
            if (kind, name) in self._popped_once:
                self._n_requeues += 1

    def add_all(self, kind: str, names: Iterable[str]) -> None:
        for n in names:
            self.add(kind, n)

    # -- backoff -------------------------------------------------------------
    def failure(self, kind: str, name: str) -> int:
        """Record a reconcile failure; returns the delay (rounds) applied.

        The delay is the exponential window plus a *deterministic* jitter
        in ``[0, window]`` keyed on the object identity and its failure
        count: without jitter, every object failing in the same round
        retries in the same round forever (a thundering herd against the
        shared allocator); hashing the key decorrelates them while two
        queues fed the same failure sequence still produce byte-identical
        schedules. ``window <= delay <= 2 * window`` always holds.
        """
        key = (kind, name)
        f = self._failures.get(key, 0)
        window = min(self.backoff_base << f, self.backoff_cap)
        # crc32, not hash(): Python salts str hashes per process, which
        # would make retry schedules unreproducible across runs
        jitter = zlib.crc32(f"{kind}/{name}#{f}".encode()) % (window + 1)
        delay = window + jitter
        self._failures[key] = f + 1
        self._not_before[key] = self._clock + delay
        self._h_backoff.observe(delay)
        return delay

    def success(self, kind: str, name: str) -> None:
        """Reset the object's backoff state (it made progress)."""
        key = (kind, name)
        self._failures.pop(key, None)
        self._not_before.pop(key, None)

    def forget(self, kind: str, name: str) -> None:
        """Drop all queue state for a deleted object."""
        self.success(kind, name)
        self._popped_once.pop((kind, name), None)
        bucket = self._dirty.get(kind)
        if bucket is not None and name in bucket:
            del bucket[name]

    def failures(self, kind: str, name: str) -> int:
        return self._failures.get((kind, name), 0)

    # -- dequeue -------------------------------------------------------------
    def pop_ready(self, kinds: Iterable[str]) -> List[Key]:
        """Advance the clock one round and pop every ready dirty key.

        ``kinds`` fixes the processing order (the controller priority:
        claims converge before the workloads that roll them up). Keys
        still inside their backoff window stay queued for a later round.
        """
        sync_point("workqueue.pop", clock=self._clock)
        self._clock += 1
        out: List[Key] = []
        for kind in kinds:
            bucket = self._dirty.get(kind)
            if not bucket:
                continue
            keep: Dict[str, None] = {}
            for name in bucket:
                if self._not_before.get((kind, name), 0) > self._clock:
                    keep[name] = None
                    self._n_deferred += 1
                else:
                    out.append((kind, name))
                    self._popped_once[(kind, name)] = None
            self._dirty[kind] = keep
        self._n_popped += len(out)
        return out

    def fast_forward(self) -> bool:
        """Jump the clock to the earliest backoff deadline of a queued key.

        Returns False when nothing queued is waiting on backoff (i.e.
        there is genuinely no work).
        """
        deadlines = [self._not_before[(k, n)]
                     for k, bucket in self._dirty.items() for n in bucket
                     if (k, n) in self._not_before]
        if not deadlines:
            return False
        self._clock = max(self._clock, min(deadlines))
        return True

    # -- introspection ---------------------------------------------------------
    def __len__(self) -> int:
        return sum(len(b) for b in self._dirty.values())

    @property
    def empty(self) -> bool:
        return len(self) == 0

    def pending(self) -> List[Key]:
        """Every queued key (ready or in backoff), in kind order."""
        return [(k, n) for k, bucket in self._dirty.items() for n in bucket]

    def depth_by_kind(self) -> Dict[str, int]:
        """Current dirty-queue depth per kind (zero-depth kinds omitted)."""
        return {k: len(b) for k, b in self._dirty.items() if b}

    def telemetry(self) -> Dict[str, object]:
        """Operational counters for ``ControlPlaneRuntime.stats()``.

        ``requeue_rate``
        is requeues ÷ pops — how often a popped key came back (healing
        churn, backoff retries); ``in_backoff`` counts keys currently
        parked inside a backoff window.
        """
        return {
            "depth_by_kind": self.depth_by_kind(),
            "depth": len(self),
            "clock": self._clock,
            "enqueued": self.enqueued,
            "popped": self.popped,
            "deferred": self.deferred,
            "requeues": self.requeues,
            "requeue_rate": round(self.requeues / self.popped, 4)
                            if self.popped else 0.0,
            "in_backoff": sum(1 for key in self._not_before
                              if key[1] in self._dirty.get(key[0], ())),
            "failing_objects": len(self._failures),
        }

    def __repr__(self) -> str:
        return (f"WorkQueue(dirty={len(self)}, clock={self._clock}, "
                f"enqueued={self.enqueued}, popped={self.popped}, "
                f"deferred={self.deferred})")
