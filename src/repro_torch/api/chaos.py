"""Fault injection for the threaded control plane: named sync points.

The informer runtime (:mod:`repro_torch.api.runtime`) is only trustworthy if
its concurrency survives *adversarial* schedules — TSoR (arXiv
2305.10621) and the Slingshot-RDMA work (arXiv 2508.09663) both stress
exactly this: control-plane convergence racing data-plane traffic under
injected faults. This module is the hook that makes such schedules
reproducible:

* **Sync points.** Hot paths in the store, the work queue, the WAL
  journal, and the runtime's worker loops call
  ``sync_point("store.write", ...)`` etc. With no injector installed
  this is one global read and a ``None`` check — cheap enough to leave
  in production paths.
* **Seeded delays.** An installed :class:`FaultInjector` sleeps at
  matching points with a seeded RNG, forcing store-write interleavings,
  queue hand-off races and journal-flush overlaps that a quiet machine
  would never schedule. Same seed → same fault decisions (the *sleep
  targets* are deterministic; the OS still owns the actual schedule).
* **Worker kills.** Points marked ``killable=True`` (only the runtime's
  worker reconcile step — never mid-store-write, where an exception
  would tear an invariant) may raise :class:`InjectedFault`; the runtime
  treats it as a worker panic and exercises its crash-restart +
  WAL-safe-journaling path.

Install per test via :func:`installed` (a context manager), or globally
with :func:`install`. ``tests/chaos.py`` builds the stress harness on
top of this.

Known sync points (prefix-matchable, e.g. ``"store."`` hits all three):

====================          =================================================
``store.create``              before admission validators run
``store.write``               inside ``ApiStore._bump`` (store lock held)
``workqueue.add``             a key becoming dirty
``workqueue.pop``             a reconcile round popping its batch
``journal.flush``             WAL flush window serialization begins
``wal.append``                one frame about to hit the file
``runtime.informer.pump``     informer event-pump iteration
``runtime.worker.pop``        worker picked a key off its inbox (killable)
``runtime.worker.reconcile``  controllers about to run for a key (killable)
``node.agent.publish``        node agent about to publish its slices
``node.agent.heartbeat``      node agent lease renewal tick (killable —
                              a kill here IS the SIGKILL'd-daemon
                              scenario: heartbeats stop, the lease
                              lapses, the node is evicted)
``rollout.stamp``             rolling update about to create a surge
                              replica claim (killable)
``rollout.delete``            rolling update about to tear down a
                              replaced replica claim (killable)
``rollout.evict``             voluntary eviction (drain / budget path)
                              about to deallocate a claim (killable)
``rollout.canary``            canary controller about to record a phase
                              transition (killable — a kill here lands
                              between the phase write and the workload
                              edit, the crash-idempotence window)
``serve.step``                serve engine about to run one batched
                              tick (latency here models a slow model
                              step — the TTFT/TPOT degradation a canary
                              verdict must catch)
``serve.admit``               a queued request just admitted into a
                              slot with its block budget reserved
``serve.complete``            a request reached a terminal state and
                              its slot is being recycled
``router.dispatch``           router picked a replica for a request
                              (latency here models a congested front
                              door)
====================          =================================================

The port's own copy of the JAX package's ``api/chaos.py`` (pure
Python; the port imports nothing of that package). It records injected
delays per point in the ``plane_torch_chaos_injected_delay_seconds``
histogram, as the JAX package does in its own.
"""

from __future__ import annotations

import random
import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

from ..obs import histogram, quantile

__all__ = ["FaultInjector", "InjectedFault", "sync_point", "install",
           "installed", "SYNC_POINTS", "LockOrderWitness"]

SYNC_POINTS = (
    "store.create", "store.write",
    "workqueue.add", "workqueue.pop",
    "journal.flush", "wal.append",
    "runtime.informer.pump", "runtime.worker.pop",
    "runtime.worker.reconcile",
    "node.agent.publish", "node.agent.heartbeat",
    "rollout.stamp", "rollout.delete", "rollout.evict", "rollout.canary",
    "serve.step", "serve.admit", "serve.complete", "router.dispatch",
)

# Injected-delay distribution per sync point (docs/OBSERVABILITY.md).
# Label cardinality is bounded by SYNC_POINTS — the planelint
# sync-points pass keeps that tuple closed.
_CHAOS_DELAY = histogram("plane_torch_chaos_injected_delay_seconds",
                         "injected delay per sync-point hit",
                         labels=("point",))


class InjectedFault(RuntimeError):
    """A chaos-injected worker panic (never raised without an injector)."""


class FaultInjector:
    """Seeded, thread-safe fault source for the control plane's sync points.

    ``delay_points`` / ``kill_points`` are exact names or prefixes from
    :data:`SYNC_POINTS`. Delays are uniform in ``(0, max_delay_s)`` with
    probability ``delay_prob`` per hit; kills fire with ``kill_prob`` at
    killable points, at most ``max_kills`` times total (so a stress run
    always converges once the kill budget is spent).

    ``latency_points`` maps point names/prefixes to a *base latency in
    seconds* injected on **every** hit (scaled by a seeded uniform
    factor in ``[0.5, 1.5]``) — the slow-RPC / congested-etcd model, as
    opposed to the probabilistic micro-delays above whose job is only
    to shake thread schedules. Use it to hold a rollout inside a
    window (e.g. ``{"rollout.stamp": 0.01}`` keeps surge replicas slow
    enough that availability bounds are actually exercised).
    """

    def __init__(self, seed: int = 0, *,
                 delay_points: Iterable[str] = ("store.", "workqueue.",
                                                "journal.", "wal.",
                                                "runtime."),
                 delay_prob: float = 0.05, max_delay_s: float = 0.002,
                 kill_points: Iterable[str] = ("runtime.worker.",),
                 kill_prob: float = 0.0, max_kills: int = 4,
                 latency_points: Optional[Dict[str, float]] = None):
        self.seed = seed
        self.delay_points = tuple(delay_points)
        self.delay_prob = delay_prob
        self.max_delay_s = max_delay_s
        self.kill_points = tuple(kill_points)
        self.kill_prob = kill_prob
        self.max_kills = max_kills
        self.latency_points = dict(latency_points or {})
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        # telemetry: point -> hits / delays / kills (assertable in tests)
        self.hits: Dict[str, int] = {}
        self.delays = 0
        self.kills = 0
        self.latency_injections = 0
        self.latency_injected_s = 0.0
        # point -> histogram cell: the injected-delay distribution the
        # summary() satellite surfaces (and the exporters aggregate)
        self._h_delay: Dict[str, object] = {}

    @staticmethod
    def _matches(point: str, patterns: Tuple[str, ...]) -> bool:
        return any(point == p or point.startswith(p) for p in patterns)

    def _latency_base(self, point: str) -> float:
        for pat, base in self.latency_points.items():
            if point == pat or point.startswith(pat):
                return base
        return 0.0

    def fire(self, point: str, killable: bool = False, **ctx: object) -> None:
        """Called from a sync point; may sleep or (if killable) raise."""
        delay = 0.0
        kill = False
        with self._lock:
            self.hits[point] = self.hits.get(point, 0) + 1
            if (killable and self.kills < self.max_kills
                    and self._matches(point, self.kill_points)
                    and self._rng.random() < self.kill_prob):
                self.kills += 1
                kill = True
            elif (self._matches(point, self.delay_points)
                    and self._rng.random() < self.delay_prob):
                self.delays += 1
                delay = self._rng.uniform(0.0, self.max_delay_s)
            base = self._latency_base(point)
            if base > 0.0 and not kill:
                # every hit pays the configured latency (jittered by a
                # seeded factor) — a congested apiserver, not a race shake
                delay += base * self._rng.uniform(0.5, 1.5)
                self.latency_injections += 1
                self.latency_injected_s += delay
            if delay > 0.0:
                cell = self._h_delay.get(point)
                if cell is None:
                    cell = self._h_delay[point] = _CHAOS_DELAY.cell(
                        point=point)
                cell.observe(delay)
        if kill:
            raise InjectedFault(f"injected worker kill at {point} "
                                f"(kill #{self.kills}, seed {self.seed})")
        if delay:
            time.sleep(delay)

    def summary(self) -> Dict[str, object]:
        with self._lock:
            hists = {}
            for point, cell in sorted(self._h_delay.items()):
                snap = cell.snapshot()          # type: ignore[attr-defined]
                hists[point] = {
                    "count": snap["count"],
                    "sum_s": round(snap["sum"], 6),
                    "p50_ms": round(quantile(snap, 0.5) * 1e3, 3),
                    "p95_ms": round(quantile(snap, 0.95) * 1e3, 3),
                }
            return {"seed": self.seed, "hits": dict(self.hits),
                    "delays": self.delays, "kills": self.kills,
                    "latency_injections": self.latency_injections,
                    "latency_injected_s": round(self.latency_injected_s, 6),
                    "delay_hist": hists}


# The installed injector. One global slot (not thread-local): the whole
# point is perturbing *cross-thread* schedules, and reads must stay a
# single attribute load on the production path.
_active: Optional[FaultInjector] = None


def sync_point(point: str, killable: bool = False, **ctx: object) -> None:
    """Fire the installed injector at ``point``; no-op when none is."""
    inj = _active
    if inj is not None:
        inj.fire(point, killable=killable, **ctx)


def install(injector: Optional[FaultInjector]) -> Optional[FaultInjector]:
    """Install (or with None, clear) the global injector; returns previous."""
    global _active
    prev, _active = _active, injector
    return prev


@contextmanager
def installed(injector: FaultInjector) -> Iterator[FaultInjector]:
    """Scoped install — the stress tests' per-seed harness."""
    prev = install(injector)
    try:
        yield injector
    finally:
        install(prev)


# ---------------------------------------------------------------------------
# Lock-order witness: the dynamic twin of planelint's static lock graph
# ---------------------------------------------------------------------------

class _TracedLock:
    """A lock proxy that reports acquisition order to its witness.

    Wraps an ``RLock``/``Lock`` with the same acquire/release/context
    protocol. The edge is recorded *before* blocking on the inner lock,
    so an order violation is witnessed even on the schedule where it
    deadlocks. Reentrant re-acquisition is counted, not re-reported.
    """

    __slots__ = ("_witness", "name", "_inner")

    def __init__(self, witness: "LockOrderWitness", name: str, inner):
        self._witness = witness
        self.name = name
        self._inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._witness._before_acquire(self.name)
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._witness._acquired(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        self._witness._released(self.name)

    def __enter__(self) -> "_TracedLock":
        self.acquire()
        return self

    def __exit__(self, *exc: object) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"_TracedLock({self.name}, {self._inner!r})"


class LockOrderWitness:
    """Records actual lock-acquisition orders; fails on observed cycles.

    planelint's ``lock-order`` pass proves the *lexical* nesting of
    plane locks is acyclic; this witness checks the claim at runtime
    during chaos stress, where interprocedural paths the static pass
    cannot see (callbacks, watch hooks, worker hand-offs) are actually
    scheduled. Wrap the plane's locks before constructing the runtime
    (``ControlPlaneRuntime.__init__`` captures ``reconcile_lock`` by
    reference)::

        witness = LockOrderWitness()
        witness.attach_plane(plane)
        rt = ControlPlaneRuntime(plane)
        witness.attach_runtime(rt)
        ...
        witness.assert_acyclic()

    An edge ``A -> B`` means some thread acquired B while holding A.
    A cycle means two schedules can acquire the same pair in opposite
    orders — an ABBA deadlock waiting for the right interleaving.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._held = threading.local()          # name -> reentrancy count
        # (holder, acquired) -> observation count
        self.edges: Dict[Tuple[str, str], int] = {}
        # first call site observed per edge: "thread @ file:line"
        self.sites: Dict[Tuple[str, str], str] = {}
        self.acquisitions = 0

    # -- wrapping ----------------------------------------------------------
    def wrap(self, name: str, lock) -> _TracedLock:
        if isinstance(lock, _TracedLock):
            return lock
        return _TracedLock(self, name, lock)

    def attach_plane(self, plane) -> "LockOrderWitness":
        """Wrap the plane-wide locks (reconcile + store). Must run
        before a ControlPlaneRuntime is constructed on the plane."""
        plane.reconcile_lock = self.wrap("reconcile", plane.reconcile_lock)
        plane.store._lock = self.wrap("store", plane.store._lock)
        return self

    def attach_runtime(self, rt) -> "LockOrderWitness":
        """Wrap the runtime's side locks (waiters/stats bookkeeping)."""
        rt._waiters_lock = self.wrap("waiters", rt._waiters_lock)
        rt._stats_lock = self.wrap("stats", rt._stats_lock)
        return self

    # -- bookkeeping (called from _TracedLock) -----------------------------
    def _counts(self) -> Dict[str, int]:
        counts = getattr(self._held, "counts", None)
        if counts is None:
            counts = self._held.counts = {}
        return counts

    def _before_acquire(self, name: str) -> None:
        counts = self._counts()
        if counts.get(name):
            return                              # reentrant: no new edge
        held = [n for n, c in counts.items() if c]
        if not held:
            return
        site = None
        with self._lock:
            for h in held:
                edge = (h, name)
                n = self.edges.get(edge, 0)
                self.edges[edge] = n + 1
                if n == 0:
                    if site is None:
                        site = self._call_site()
                    self.sites[edge] = site

    def _acquired(self, name: str) -> None:
        counts = self._counts()
        counts[name] = counts.get(name, 0) + 1
        self.acquisitions += 1

    def _released(self, name: str) -> None:
        counts = self._counts()
        n = counts.get(name, 0) - 1
        if n <= 0:
            counts.pop(name, None)
        else:
            counts[name] = n

    @staticmethod
    def _call_site() -> str:
        frame = sys._getframe(2)
        while frame is not None and frame.f_code.co_filename == __file__:
            frame = frame.f_back
        if frame is None:                        # pragma: no cover
            return threading.current_thread().name
        return (f"{threading.current_thread().name} @ "
                f"{frame.f_code.co_filename}:{frame.f_lineno}")

    # -- verdict -----------------------------------------------------------
    def cycles(self) -> List[List[str]]:
        """Every distinct cycle in the observed order graph."""
        adj: Dict[str, Set[str]] = {}
        with self._lock:
            for a, b in self.edges:
                adj.setdefault(a, set()).add(b)
        out: List[List[str]] = []
        state: Dict[str, int] = {}
        stack: List[str] = []

        def dfs(node: str) -> None:
            state[node] = 1
            stack.append(node)
            for nxt in sorted(adj.get(node, ())):
                if state.get(nxt, 0) == 1:
                    out.append(stack[stack.index(nxt):] + [nxt])
                elif state.get(nxt, 0) == 0:
                    dfs(nxt)
            stack.pop()
            state[node] = 2

        for node in sorted(adj):
            if state.get(node, 0) == 0:
                dfs(node)
        return out

    def assert_acyclic(self) -> None:
        found = self.cycles()
        if not found:
            return
        detail = []
        for cyc in found:
            for a, b in zip(cyc, cyc[1:]):
                detail.append(f"  {a} -> {b}: seen "
                              f"{self.edges.get((a, b), 0)}x, first at "
                              f"{self.sites.get((a, b), '?')}")
        raise AssertionError(
            "lock-order cycle observed at runtime (ABBA deadlock "
            "candidate): " + " | ".join("->".join(c) for c in found)
            + "\n" + "\n".join(detail))

    def summary(self) -> Dict[str, object]:
        cycles = ["->".join(c) for c in self.cycles()]
        with self._lock:
            return {"acquisitions": self.acquisitions,
                    "edges": {f"{a}->{b}": n
                              for (a, b), n in sorted(self.edges.items())},
                    "cycles": cycles}
