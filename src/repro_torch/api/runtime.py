"""Threaded informer runtime: the control plane as a running system.

Until this module, the ControlPlane was *call-driven*: every entry point
blocked on ``reconcile()`` inline, so the control plane only converged
when the workload stopped to let it. The paper's KND architecture
assumes the opposite — DraNet-style drivers watch and converge *while
pods execute*. :class:`ControlPlaneRuntime` is that shape for this repo:

* an **informer thread** pumps the store's watch stream into the
  existing :class:`~repro_torch.api.workqueue.WorkQueue` dirty queues
  (dependency edges, per-object backoff and fast-forward all unchanged),
  resolves condition waiters, and supervises workers;
* **per-kind worker pools** drain the dirty queues and run the kind's
  controllers on each popped key. Controller critical sections serialize
  on the plane's reconcile lock (CPython's GIL would interleave them
  anyway); the concurrency win is *overlap* — allocation, preparation,
  planning and WAL journaling proceed between and underneath training
  steps instead of inside them;
* **condition-waiter futures** replace blocking ``wait_for``:
  ``submit()`` then ``wait_ready()`` parks the caller on an event the
  informer sets the moment the condition goes True for the current
  generation (flushing the journal first — convergence a caller
  observed must survive a crash);
* **rate limiting**: an optional token bucket caps reconciles/second so
  a churning control plane cannot starve the data plane (the
  ``bench_informer`` interference knob);
* **crash-restart**: a worker that panics (driver error, injected
  fault) flushes the WAL window first — journaled state never lags a
  crash — requeues its in-flight key, and dies; the informer restarts
  it up to ``max_worker_restarts`` times. Past the budget the runtime
  fails fast: every current and future waiter raises.

The blocking path survives as ``reconcile_mode="inline"`` (an alias of
the event loop, driven by the caller) — the reference arm for tests and
the overlap benchmark. Chaos hooks: every hand-off runs through
:func:`repro_torch.api.chaos.sync_point`, so ``tests/chaos.py`` can force
adversarial schedules with seeded delays and worker kills.

Usage::

    plane = ControlPlane.open(state_dir, registry, cluster)
    with ControlPlaneRuntime(plane) as rt:     # start()ed
        rt.submit(claim)
        rt.submit(Workload(claim=claim.name, axes=[...]), name="job")
        obj = rt.wait_ready("Workload", "job", timeout=30)
        ...                                    # train; plane keeps converging
        rt.edit("ResourceClaim", claim.name, shrink)   # elastic resize
        rt.wait_ready("Workload", "job")
    # stop() joined the threads and synced the WAL

The port's own copy of the JAX package's ``api/runtime.py``, with its
instruments named ``plane_torch_runtime_*``: ``stats()`` reports the
plain counters, the work queue's telemetry and, under ``"obs"``, the
reconcile-latency and waiter-wait histograms.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

from ..obs import counter, histogram, quantile
from .chaos import sync_point
from .objects import ApiObject, CONDITION_READY
from .store import ApiStore, WatchEvent

__all__ = ["ControlPlaneRuntime", "ConditionWaiter", "RuntimeStats",
           "TokenBucket"]

Key = Tuple[str, str]

# Registry instruments (docs/OBSERVABILITY.md). Reconcile latency is
# labeled by kind — bounded by the controller kind order, not by object
# names.
_RT_RECONCILE = histogram("plane_torch_runtime_reconcile_seconds",
                          "wall time of one reconcile_key call",
                          labels=("kind",))
_RT_RESTARTS = counter("plane_torch_runtime_worker_restarts_total",
                       "panicked workers respawned by the informer")
_RT_WAITER_WAIT = histogram("plane_torch_runtime_waiter_wait_seconds",
                            "condition-waiter creation -> resolution")

class TokenBucket:
    """Minimal thread-safe token bucket (reconciles per second)."""

    def __init__(self, rate_hz: float, burst: Optional[float] = None):
        self.rate = float(rate_hz)
        self.burst = float(burst if burst is not None else max(rate_hz, 1.0))
        self._tokens = self.burst
        self._t = time.monotonic()
        self._lock = threading.Lock()

    def acquire(self, stop: Optional[threading.Event] = None) -> None:
        """Take one token, sleeping until available (or ``stop`` is set)."""
        while True:
            with self._lock:
                now = time.monotonic()
                self._tokens = min(self.burst,
                                   self._tokens + (now - self._t) * self.rate)
                self._t = now
                if self._tokens >= 1.0:
                    self._tokens -= 1.0
                    return
                wait = (1.0 - self._tokens) / self.rate
            if stop is not None and stop.wait(wait):
                return
            elif stop is None:
                time.sleep(wait)


class ConditionWaiter:
    """A future resolved when ``kind/name`` reaches ``condition`` True.

    Created by :meth:`ControlPlaneRuntime.waiter` /
    :meth:`~ControlPlaneRuntime.wait_ready`; resolved (or failed) by the
    informer thread.
    """

    def __init__(self, kind: str, name: str, condition: str):
        self.kind = kind
        self.name = name
        self.condition = condition
        self.t_created = time.monotonic()   # waiter-wait histogram anchor
        self._event = threading.Event()
        self._obj: Optional[ApiObject] = None
        self._error: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def _resolve(self, obj: ApiObject) -> None:
        self._obj = obj
        self._event.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def wait(self, timeout: Optional[float] = None) -> ApiObject:
        """Block until resolved; raises on runtime failure or timeout."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"{self.kind}/{self.name} did not reach "
                f"{self.condition}=True within {timeout}s")
        if self._error is not None:
            raise self._error
        assert self._obj is not None
        return self._obj

    def __repr__(self) -> str:
        state = ("pending" if not self.done
                 else "failed" if self._error else "ready")
        return (f"ConditionWaiter({self.kind}/{self.name}"
                f"@{self.condition}, {state})")


@dataclass
class RuntimeStats:
    """Counters the tests and the overlap benchmark assert against.

    Also callable: ``runtime.stats()`` returns the counters merged with
    the shared :class:`~repro_torch.api.workqueue.WorkQueue`'s telemetry
    (per-kind queue depth, backoff counts, requeue rate) — the
    operational snapshot ``bench_informer`` prints.
    """

    dispatched: int = 0          # keys handed to worker inboxes
    reconciled: int = 0          # keys a worker finished (incl. no-ops)
    redispatch_deferred: int = 0  # popped while the same key was in flight
    panics: int = 0              # worker loops ended by an exception
    restarts: int = 0            # panicked workers respawned
    waiters_resolved: int = 0
    waiters_failed: int = 0
    informer_rounds: int = 0
    last_panic: Optional[str] = None
    panic_log: List[str] = field(default_factory=list)
    _runtime: Optional["ControlPlaneRuntime"] = field(
        default=None, repr=False, compare=False)

    def __call__(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "dispatched": self.dispatched,
            "reconciled": self.reconciled,
            "redispatch_deferred": self.redispatch_deferred,
            "panics": self.panics,
            "restarts": self.restarts,
            "waiters_resolved": self.waiters_resolved,
            "waiters_failed": self.waiters_failed,
            "informer_rounds": self.informer_rounds,
        }
        rt = self._runtime
        if rt is not None:
            with rt.lock:   # queue counters mutate under the plane lock
                out["workqueue"] = rt.plane.queue.telemetry()
            out["obs"] = rt._obs_snapshot()
        return out


class ControlPlaneRuntime:
    """Background informer loops + worker pools around one ControlPlane.

    Thread model (all threads daemonic; :meth:`stop` joins them):

    * 1 informer thread — event pump, dispatch, waiter resolution,
      worker supervision;
    * ``workers_per_kind`` workers per controller kind, each draining a
      per-kind inbox fed from the shared :class:`WorkQueue`.

    Mutations that bypass the store (``pool.withdraw_node``, direct
    ``allocator.deallocate``) must run under :attr:`lock` — use
    ``ControlPlane.mutate()`` or the runtime's own helpers
    (:meth:`delete_claim`), which do.
    """

    # wait_ready's fallback deadline: callers passing timeout=None get a
    # bounded wait with the non-convergence diagnostic, not a silent hang
    DEFAULT_TIMEOUT = 60.0

    def __init__(self, plane: Any, *, workers_per_kind: int = 2,
                 poll_interval_s: float = 0.02,
                 max_rate_hz: Optional[float] = None,
                 max_worker_restarts: int = 8,
                 name: str = "informer"):
        if workers_per_kind < 1:
            raise ValueError("workers_per_kind must be >= 1")
        self.plane = plane
        self.workers_per_kind = workers_per_kind
        self.poll_interval_s = poll_interval_s
        self.limiter = (TokenBucket(max_rate_hz)
                        if max_rate_hz is not None else None)
        self.max_worker_restarts = max_worker_restarts
        self.name = name
        self.stats = RuntimeStats(_runtime=self)
        # the plane's reconcile lock serializes controller critical
        # sections (and any out-of-band pool/registry mutation)
        self.lock: threading.RLock = plane.reconcile_lock
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._quiesced = threading.Event()
        self._failed: Optional[BaseException] = None
        self._informer: Optional[threading.Thread] = None
        self._workers: Dict[Tuple[str, int], threading.Thread] = {}
        self._inboxes: Dict[str, "queue.Queue[Optional[Key]]"] = {}
        self._inflight: set = set()          # keys a worker currently holds
        self._waiters: List[ConditionWaiter] = []
        self._waiters_lock = threading.Lock()
        # guards multi-writer stats fields (panics/reconciled/panic_log):
        # bare `+= 1` from concurrent workers drops increments
        self._stats_lock = threading.Lock()
        self._started = False
        # registry cells (per-runtime; the exporters aggregate)
        self._c_restarts = _RT_RESTARTS.cell()
        self._h_waiter_wait = _RT_WAITER_WAIT.cell()
        self._h_reconcile: Dict[str, Any] = {}   # kind -> histogram cell

    # -- lifecycle ---------------------------------------------------------
    @property
    def running(self) -> bool:
        return self._started and not self._stop.is_set()

    @property
    def worker_count(self) -> int:
        return len(self._workers)

    def start(self) -> "ControlPlaneRuntime":
        if self._started:
            raise RuntimeError("runtime already started")
        if getattr(self.plane, "informer", None) not in (None, self):
            raise RuntimeError("plane already has a running informer")
        self._started = True
        self.plane.informer = self
        # every store write wakes the informer (journal hooks run under
        # the store lock and must stay O(1): just set an event)
        self.plane.store.add_journal(self._on_store_event)
        for kind in self.plane._kind_order:
            self._inboxes[kind] = queue.Queue()
            for idx in range(self.workers_per_kind):
                self._spawn_worker(kind, idx)
        self._informer = threading.Thread(
            target=self._informer_loop, name=f"{self.name}-loop", daemon=True)
        self._informer.start()
        self._wake.set()
        return self

    def stop(self, timeout: float = 10.0) -> RuntimeStats:
        """Stop threads, drain + sync the journal, fail pending waiters."""
        if not self._started:
            return self.stats
        self._stop.set()
        self._wake.set()
        for kind, inbox in self._inboxes.items():
            for _ in range(self.workers_per_kind + 1):
                inbox.put(None)                     # shutdown sentinels
        deadline = time.monotonic() + timeout
        for t in [self._informer] + list(self._workers.values()):
            if t is not None and t.is_alive():
                t.join(max(0.0, deadline - time.monotonic()))
        if self.plane.informer is self:
            self.plane.informer = None
        self.plane.store.remove_journal(self._on_store_event)
        if self.plane.journal is not None:
            self.plane.journal.sync()               # WAL-safe shutdown
        self._fail_waiters(RuntimeError(
            f"control-plane runtime {self.name!r} stopped"))
        return self.stats

    def __enter__(self) -> "ControlPlaneRuntime":
        return self.start()

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    # -- object submission (thread-safe store front-ends) ------------------
    def submit(self, spec: Any, name: Optional[str] = None,
               labels: Optional[Mapping[str, str]] = None) -> ApiObject:
        obj = self.plane.store.create(spec, name=name, labels=labels)
        self._wake.set()
        return obj

    def edit(self, kind: str, name: str, mutate: Callable[[Any], Any]
             ) -> ApiObject:
        obj = self.plane.store.update_spec(kind, name, mutate)
        self._wake.set()
        return obj

    def delete(self, kind: str, name: str) -> ApiObject:
        obj = self.plane.store.delete(kind, name)
        self._wake.set()
        return obj

    def delete_claim(self, name: str) -> None:
        """Tear a claim down (unprepare + deallocate + delete) safely."""
        with self.lock:
            obj = self.plane.store.try_get("ResourceClaim", name)
            if obj is None:
                return
            claim = obj.spec
            self.plane.unprepare(claim)
            if claim.allocated:
                self.plane.allocator.deallocate(claim)
            self.plane.store.delete("ResourceClaim", name)
        self._wake.set()

    # -- condition waiters -------------------------------------------------
    def waiter(self, kind: str, name: str,
               condition: str = CONDITION_READY) -> ConditionWaiter:
        """Register a future for ``kind/name`` reaching ``condition``."""
        w = ConditionWaiter(kind, name, condition)
        # liveness check and append are ONE critical section: stop() /
        # _fail_runtime set their flags before swapping the list under
        # this same lock, so either we append early enough to be swept
        # by _fail_waiters, or we observe the flags and fail fast — a
        # registered-but-never-resolved waiter cannot exist
        with self._waiters_lock:
            if self._failed is not None:
                w._fail(self._failed)
                return w
            if not self.running:
                w._fail(RuntimeError(
                    f"control-plane runtime {self.name!r} is not running"))
                return w
            self._waiters.append(w)
        self._wake.set()
        return w

    def wait_ready(self, kind_or_obj: Any, name: Optional[str] = None,
                   condition: str = CONDITION_READY,
                   timeout: Optional[float] = None) -> ApiObject:
        """Block until the object reaches ``condition`` for its current spec.

        The threaded analogue of ``ControlPlane.wait_for``: accepts an
        ``ApiObject`` or ``(kind, name)``. Raises ``TimeoutError`` with
        the object's condition summary, last condition transitions and
        the runtime's queue state when convergence does not arrive in
        time. ``timeout=None`` means :attr:`DEFAULT_TIMEOUT`, never
        "wait forever": an unbounded wait on a wedged runtime hangs the
        caller with zero diagnostics, which is strictly worse than a
        loud timeout naming the stuck objects.
        """
        if timeout is None:
            timeout = self.DEFAULT_TIMEOUT
        if isinstance(kind_or_obj, ApiObject):
            kind, name = kind_or_obj.meta.kind, kind_or_obj.meta.name
        else:
            kind = kind_or_obj
        if name is None:
            raise ValueError("wait_ready needs an ApiObject or (kind, name)")
        w = self.waiter(kind, name, condition)
        try:
            return w.wait(timeout)
        except TimeoutError:
            with self._waiters_lock:
                if w in self._waiters:
                    self._waiters.remove(w)
            obj = self.plane.store.try_get(kind, name)
            summary = "<deleted>"
            if obj is not None:
                # reasons included: "Allocated=False(Unsatisfiable)@g3"
                summary = " ".join(
                    f"{c.type}={c.status}({c.reason})"
                    f"@g{c.observed_generation}"
                    for c in obj.status.conditions) or "<no conditions>"
            with self.lock:
                # snapshot mutable runtime state under the lock: a live
                # worker mutating _inflight mid-iteration would raise
                # and mask the TimeoutError the caller is promised
                queue_state = repr(self.plane.queue)
                inflight = sorted(self._inflight)
                pending = self.plane.queue.pending()
            detail = self.plane._dirty_detail([(kind, name)] + pending)
            raise TimeoutError(
                f"{kind}/{name} did not reach {condition}=True within "
                f"{timeout}s: {summary}; queue={queue_state}, "
                f"inflight={inflight}, stats={self.stats}; "
                f"still-dirty keys and last transitions:\n{detail}"
            ) from None

    def wait_quiesce(self, timeout: float = 30.0) -> bool:
        """Block until the runtime is idle (no events, dirty keys, work).

        Returns True when quiescent; False on timeout. A permanently
        failing object drains to idle too — retries are event-driven,
        so once its condition writes reach a fixpoint nothing re-dirties
        it (same semantics as the inline loop's convergence).
        """
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._failed is not None:
                raise self._failed
            if self._quiesced.wait(min(0.05, self.poll_interval_s)):
                return True
        return False

    # -- internals ---------------------------------------------------------
    def _on_store_event(self, event: WatchEvent) -> None:
        # new work exists the moment a store write lands — a waiter
        # polling wait_quiesce must not observe the stale idle flag
        self._quiesced.clear()
        self._wake.set()

    def _spawn_worker(self, kind: str, idx: int) -> None:
        t = threading.Thread(target=self._worker_loop, args=(kind,),
                             name=f"{self.name}-{kind}-{idx}", daemon=True)
        self._workers[(kind, idx)] = t
        t.start()

    def _fail_waiters(self, error: BaseException) -> None:
        with self._waiters_lock:
            waiters, self._waiters = self._waiters, []
        for w in waiters:
            self.stats.waiters_failed += 1
            w._fail(error)

    def _fail_runtime(self, error: BaseException) -> None:
        self._failed = error
        self._fail_waiters(error)
        self._stop.set()
        self._wake.set()
        for inbox in self._inboxes.values():
            inbox.put(None)

    # -- informer thread ---------------------------------------------------
    def _informer_loop(self) -> None:
        try:
            while not self._stop.is_set():
                self.stats.informer_rounds += 1
                sync_point("runtime.informer.pump",
                           rounds=self.stats.informer_rounds)
                progressed = self._pump_and_dispatch()
                self._supervise_workers()
                self._resolve_waiters()
                if not progressed:
                    self._maybe_quiesce()
                    self._wake.wait(self.poll_interval_s)
                    self._wake.clear()
        except BaseException as e:  # noqa: BLE001 - must never die silently
            with self._stats_lock:
                self.stats.panics += 1
                self.stats.last_panic = f"informer: {type(e).__name__}: {e}"
                self.stats.panic_log.append(self.stats.last_panic)
            self._fail_runtime(e)

    def _maybe_quiesce(self) -> None:
        """Raise the idle flag — but only while provably idle.

        Both locks are held for the check-and-set: a store write either
        completes before the check (pending=True, no set) or happens
        after the set, in which case its journal hook *clears* the flag
        again. Either way ``wait_quiesce`` can never observe a stale
        True while work exists.

        Quiescence also *settles* pending waiters: with no events left
        and nothing dirty, an object whose condition is still False will
        never progress until some future event arrives — the threaded
        analogue of the inline ``wait_for`` raising at a fixpoint, so
        callers fail in milliseconds instead of sleeping out a timeout.
        """
        plane = self.plane
        with self.lock, plane.store.lock:
            pool = plane.registry.pool
            if (plane._watch.pending
                    or len(plane.queue) != 0
                    or self._inflight
                    # out-of-band mutations emit no store event; idle
                    # means the level-triggered edges are caught up too,
                    # else a freed-capacity/inventory change sitting in
                    # a generation counter would be settled away
                    or pool.release_generation != plane._seen_release_gen
                    or pool.inventory_generation != plane._synced_pool_gen
                    or plane.registry.classes.keys() - plane._synced_classes
                    # a Ready node with a lapsed lease has an eviction
                    # due: settling waiters now would fail them just
                    # before the node plane converges them
                    or plane._lease_attention_needed()):
                return
            self._quiesced.set()
            self._settle_waiters_locked()

    def _settle_waiters_locked(self) -> None:
        """At a fixpoint every pending waiter has an answer: resolve the
        converged, fail the rest with the inline-style summary."""
        with self._waiters_lock:
            if not self._waiters:
                return
            waiters, self._waiters = self._waiters, []
        resolved: List[Tuple[ConditionWaiter, ApiObject]] = []
        failed: List[Tuple[ConditionWaiter, BaseException]] = []
        for w in waiters:
            obj = self.plane.store.try_get(w.kind, w.name)
            if obj is not None and obj.is_true(w.condition, current=True):
                resolved.append((w, obj))
            else:
                summary = (obj.conditions_summary() if obj is not None
                           else "<object not found>")
                failed.append((w, RuntimeError(
                    f"{w.kind}/{w.name} did not reach {w.condition}=True: "
                    f"{summary} (reconcile reached a fixpoint; only a new "
                    f"event — spec edit, capacity change — can retry it)")))
        if resolved and self.plane.journal is not None:
            self.plane.journal.flush()       # store lock is re-entrant
        now = time.monotonic()
        for w, obj in resolved:
            self.stats.waiters_resolved += 1
            self._h_waiter_wait.observe(now - w.t_created)
            w._resolve(obj)
        for w, err in failed:
            self.stats.waiters_failed += 1
            w._fail(err)

    def _pump_and_dispatch(self) -> bool:
        """One informer round: pump events, pop ready keys, dispatch.

        Returns True when any key was dispatched (or the backoff clock
        fast-forwarded), i.e. the loop should spin again immediately.
        """
        plane = self.plane
        with self.lock:
            plane.sync_inventory()
            plane._pump_events()
            plane._requeue_on_released_capacity()
            if len(plane.queue) == 0:
                return False
            self._quiesced.clear()
            batch = plane.queue.pop_ready(plane._kind_order)
            if not batch:
                # everything dirty is inside a backoff window; jump the
                # round clock to the earliest deadline (same fast-forward
                # the inline loop does) unless new events arrived
                return plane.queue.fast_forward()
            dispatched = False
            for key in batch:
                if key in self._inflight:
                    # a worker holds this key; keep it dirty for the next
                    # round instead of reconciling the same object twice
                    # concurrently
                    plane.queue.add(*key)
                    self.stats.redispatch_deferred += 1
                    continue
                self._inflight.add(key)
                self._inboxes[key[0]].put(key)
                self.stats.dispatched += 1
                dispatched = True
            return dispatched

    def _supervise_workers(self) -> None:
        """Respawn panicked workers; fail the runtime past the budget."""
        for (kind, idx), t in list(self._workers.items()):
            if t.is_alive() or self._stop.is_set():
                continue
            if self.stats.restarts >= self.max_worker_restarts:
                self._fail_runtime(RuntimeError(
                    f"worker restart budget exhausted "
                    f"({self.max_worker_restarts}); last panic: "
                    f"{self.stats.last_panic}"))
                return
            self.stats.restarts += 1
            self._c_restarts.inc()
            self._spawn_worker(kind, idx)

    def _resolve_waiters(self) -> None:
        with self._waiters_lock:
            waiters = list(self._waiters)
        if not waiters:
            return
        resolved: List[Tuple[ConditionWaiter, ApiObject]] = []
        for w in waiters:
            obj = self.plane.store.try_get(w.kind, w.name)
            if obj is not None and obj.is_true(w.condition, current=True):
                resolved.append((w, obj))
        if not resolved:
            return
        # convergence the caller observed is convergence that must
        # survive a crash: drain the journal window before resolving
        if self.plane.journal is not None:
            self.plane.journal.flush()
        with self._waiters_lock:
            for w, _ in resolved:
                if w in self._waiters:
                    self._waiters.remove(w)
        now = time.monotonic()
        for w, obj in resolved:
            self.stats.waiters_resolved += 1
            self._h_waiter_wait.observe(now - w.t_created)
            w._resolve(obj)

    # -- worker threads ----------------------------------------------------
    def _worker_loop(self, kind: str) -> None:
        inbox = self._inboxes[kind]
        while not self._stop.is_set():
            try:
                key = inbox.get(timeout=self.poll_interval_s)
            except queue.Empty:
                continue
            if key is None:                          # shutdown sentinel
                return
            try:
                sync_point("runtime.worker.pop", killable=True,
                           kind=key[0], name=key[1])
                if self.limiter is not None:
                    self.limiter.acquire(self._stop)
                self._reconcile_key(key)
            except (AssertionError, KeyboardInterrupt) as e:
                # a failed test assertion (or ^C) must FAIL the runtime,
                # not masquerade as one more survivable worker panic that
                # a restart quietly absorbs
                self._panic(key, e)
                self._fail_runtime(e)
                return
            except BaseException as e:  # noqa: BLE001 - panic path
                self._panic(key, e)
                return          # thread dies (quietly — the panic is
                                # recorded + requeued); informer respawns it
            finally:
                self._inflight.discard(key)
                self._wake.set()

    def _reconcile_key(self, key: Key) -> None:
        kind, name = key
        plane = self.plane
        cell = self._h_reconcile.get(kind)
        if cell is None:
            cell = self._h_reconcile[kind] = _RT_RECONCILE.cell(kind=kind)
        t0 = time.perf_counter()
        try:
            with self.lock:
                obj = plane.store.try_get(kind, name)
                if obj is None:
                    plane.queue.forget(kind, name)
                    self.stats.reconciled += 1
                    return
                sync_point("runtime.worker.reconcile", killable=True,
                           kind=kind, name=name)
                for ctl in plane._by_kind.get(kind, ()):
                    plane.reconcile_calls += 1
                    ctl.reconcile(plane, obj)
                    if plane.store.try_get(kind, name) is None:
                        break            # deleted by an earlier controller
                else:
                    plane._update_backoff(kind, name, obj)
                self.stats.reconciled += 1
        finally:
            cell.observe(time.perf_counter() - t0)
        if plane.journal is not None:
            plane.journal.maybe_flush()

    def _panic(self, key: Key, error: BaseException) -> None:
        """Worker crash path: requeue the key, journal what is real.

        Injected and real faults take the same road — the error text
        lands in ``stats.last_panic``/``panic_log`` and the restart
        budget decides whether the runtime survives it.
        """
        with self._stats_lock:
            self.stats.panics += 1
            self.stats.last_panic = (f"{key[0]}/{key[1]}: "
                                     f"{type(error).__name__}: {error}")
            self.stats.panic_log.append(self.stats.last_panic)
        with self.lock:
            # the key was popped from the dirty set; a panic must not
            # lose it (same invariant the inline loop keeps on errors)
            self.plane.queue.add(*key)
        if self.plane.journal is not None:
            # WAL-safe: everything written to the store before the crash
            # is durable before the worker is replaced — a recovery off
            # this journal sees exactly the pre-panic reality
            try:
                self.plane.journal.flush()
            except Exception:  # noqa: BLE001 - never mask the panic
                pass

    # -- introspection -----------------------------------------------------
    def _obs_snapshot(self) -> Dict[str, Any]:
        """Registry-instrument view for ``stats()`` (docs/OBSERVABILITY.md):
        per-kind reconcile latency + waiter wait percentiles."""
        lat: Dict[str, Any] = {}
        for kind, cell in sorted(self._h_reconcile.items()):
            snap = cell.snapshot()
            lat[kind] = {"count": snap["count"],
                         "p50_ms": round(quantile(snap, 0.5) * 1e3, 3),
                         "p95_ms": round(quantile(snap, 0.95) * 1e3, 3)}
        wsnap = self._h_waiter_wait.snapshot()
        return {
            "reconcile_latency_by_kind": lat,
            "waiter_wait": {"count": wsnap["count"],
                            "p50_ms": round(quantile(wsnap, 0.5) * 1e3, 3)},
        }

    def __repr__(self) -> str:
        state = ("running" if self.running else
                 "failed" if self._failed else
                 "stopped" if self._started else "new")
        return (f"ControlPlaneRuntime({self.name}, {state}, "
                f"workers={len(self._workers)}, stats={self.stats})")
