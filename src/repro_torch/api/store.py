"""ApiStore: a typed, versioned, watchable in-memory object store.

The single source of truth for the declarative control plane — the
API-server analogue of the paper's architecture. Every mutation bumps a
monotonic ``resource_version`` and appends a :class:`WatchEvent` to an
ordered log; :class:`Watch` cursors replay the log, so a controller that
starts late still sees every object (level-triggered reconciliation).

Semantics (deliberately Kubernetes-shaped):

* **typed**: only registered payload types may be stored; the kind is
  derived from the payload's Python type.
* **spec vs status**: ``update_spec`` bumps ``generation`` (user intent
  changed); ``update_status`` / ``set_condition`` bump only
  ``resource_version``. Controllers compare a condition's
  ``observed_generation`` to ``meta.generation`` to detect stale work.
* **optimistic concurrency**: writers may pass the resource version they
  read; a mismatch raises :class:`ConflictError`.
* **label selectors**: ``list_objects(selector={"app": "x"})`` filters
  by exact label match, like a Kubernetes label selector.
* **idempotent conditions**: ``set_condition`` is a no-op (no version
  bump, no watch event) when the condition state is unchanged — this is
  what lets reconcile loops detect a fixpoint.
* **thread-safe**: every mutation and every watch-cursor read runs under
  one re-entrant lock, so threaded informers can share a store with the
  reconcile loop (the ROADMAP's informer prerequisite).
* **journal hooks**: ``add_journal`` registers a callback invoked (under
  the lock) for every appended watch event — the write-ahead-log tap
  used by :mod:`repro_torch.api.persistence`.
* **admission validators**: ``add_validator`` callbacks run before a
  ``create`` lands; the control plane uses this to reject claims that
  exceed a DeviceClass capacity summary (:class:`AdmissionError`) at
  submit time instead of failing allocation later.

The port's own copy of the JAX package's ``api/store.py`` (pure
Python; the port imports nothing of that package).
"""

from __future__ import annotations

import itertools
import threading
from bisect import bisect_right
from dataclasses import dataclass, replace
from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Tuple, Type)

from ..core.claims import (DeviceClass, ResourceClaim, ResourceClaimTemplate)
from ..core.resources import ResourceSlice
from .chaos import sync_point
from .objects import (ApiObject, CanaryRollout, Condition, DisruptionBudget,
                      Lease, Node, ObjectMeta, ObjectStatus, TRUE, Workload)

__all__ = ["ApiStore", "Watch", "WatchEvent", "ConflictError",
           "ApiError", "AdmissionError", "KIND_OF"]

# The typed registry: payload type -> kind string. This is the "schema"
# of the API — create() rejects anything else.
KIND_OF: Dict[Type[Any], str] = {
    ResourceClaim: "ResourceClaim",
    ResourceClaimTemplate: "ResourceClaimTemplate",
    DeviceClass: "DeviceClass",
    ResourceSlice: "ResourceSlice",
    Workload: "Workload",
    Node: "Node",
    Lease: "Lease",
    DisruptionBudget: "DisruptionBudget",
    CanaryRollout: "CanaryRollout",
}


class ApiError(KeyError):
    """Unknown object / kind."""


class AdmissionError(ApiError):
    """An admission validator rejected the object at create time."""

    def __str__(self) -> str:
        # KeyError.__str__ reprs its argument, which would quote-wrap
        # every surfaced admission message
        return str(self.args[0]) if self.args else ""


class ConflictError(RuntimeError):
    """Optimistic-concurrency failure: resource version moved underfoot."""


ADDED = "ADDED"
MODIFIED = "MODIFIED"
DELETED = "DELETED"


@dataclass(frozen=True)
class WatchEvent:
    type: str                 # ADDED | MODIFIED | DELETED
    kind: str
    name: str
    resource_version: int
    object: ApiObject         # live reference (single-process store)


class Watch:
    """A cursor over the store's event log.

    ``poll()`` returns the events appended since the previous poll
    (optionally filtered by kind). Synchronous by design: reconcilers
    run deterministically in-process, no threads needed for tests.
    """

    def __init__(self, store: "ApiStore", kind: Optional[str],
                 since_version: int):
        self._store = store
        self._kind = kind
        with store.lock:
            self._pos = store._log_index_after(since_version)

    def poll(self) -> List[WatchEvent]:
        with self._store.lock:
            log = self._store._log
            events = [e for e in log[self._pos:]
                      if self._kind is None or e.kind == self._kind]
            self._pos = len(log)
            return events

    @property
    def pending(self) -> bool:
        with self._store.lock:
            return any(self._kind is None or e.kind == self._kind
                       for e in self._store._log[self._pos:])


class ApiStore:
    """In-memory API server: typed objects, versions, watches."""

    def __init__(self) -> None:
        self._objects: Dict[Tuple[str, str], ApiObject] = {}
        self._by_kind: Dict[str, Dict[str, ApiObject]] = {}
        self._version = itertools.count(1)
        self._last_version = 0
        self._log: List[WatchEvent] = []
        # one re-entrant lock guards objects, the log, and the version
        # counter; journal hooks run under it so WAL order == event order
        self._lock = threading.RLock()
        self._journals: List[Callable[[WatchEvent], None]] = []
        self._validators: List[Callable[[str, Any], None]] = []

    # -- concurrency / hooks ----------------------------------------------
    @property
    def lock(self) -> threading.RLock:
        return self._lock

    def add_journal(self, hook: Callable[[WatchEvent], None]) -> None:
        """Register a per-event callback (the persistence WAL tap)."""
        self._journals.append(hook)

    def remove_journal(self, hook: Callable[[WatchEvent], None]) -> None:
        if hook in self._journals:
            self._journals.remove(hook)

    def add_validator(self, validator: Callable[[str, Any], None]) -> None:
        """Register an admission validator run before each ``create``."""
        self._validators.append(validator)

    # -- internals ---------------------------------------------------------
    def _bump(self, obj: ApiObject, event_type: str) -> ApiObject:
        # chaos: stretch the store-lock critical section so concurrent
        # writers/watchers queue up in adversarial orders
        sync_point("store.write", kind=obj.meta.kind, name=obj.meta.name)
        obj.meta.resource_version = next(self._version)
        self._last_version = obj.meta.resource_version
        event = WatchEvent(event_type, obj.meta.kind, obj.meta.name,
                           obj.meta.resource_version, obj)
        self._log.append(event)
        for hook in self._journals:
            hook(event)
        return obj

    def _log_index_after(self, version: int) -> int:
        # resource versions are strictly increasing along the log, so the
        # replay cursor is a binary search, not a linear scan
        return bisect_right(self._log, version,
                            key=lambda e: e.resource_version)

    @staticmethod
    def kind_of(spec: Any) -> str:
        kind = KIND_OF.get(type(spec))
        if kind is None:
            raise ApiError(f"unregistered API type {type(spec).__name__!r}; "
                           f"known kinds: {sorted(k.__name__ for k in KIND_OF)}")
        return kind

    def _check_version(self, obj: ApiObject,
                       expected: Optional[int]) -> None:
        if expected is not None and obj.meta.resource_version != expected:
            raise ConflictError(
                f"{obj.meta.kind}/{obj.meta.name}: resource version "
                f"{expected} is stale (now {obj.meta.resource_version})")

    # -- CRUD --------------------------------------------------------------
    def create(self, spec: Any, name: Optional[str] = None,
               labels: Optional[Mapping[str, str]] = None) -> ApiObject:
        kind = self.kind_of(spec)
        name = name or getattr(spec, "name", None)
        if not name:
            raise ApiError(f"{kind} object needs a name")
        sync_point("store.create", kind=kind, name=name)
        with self._lock:
            for validate in self._validators:
                validate(kind, spec)
            key = (kind, name)
            if key in self._objects:
                raise ConflictError(f"{kind}/{name} already exists")
            obj = ApiObject(meta=ObjectMeta(name=name, kind=kind,
                                            labels=dict(labels or {})),
                            spec=spec)
            self._objects[key] = obj
            self._by_kind.setdefault(kind, {})[name] = obj
            return self._bump(obj, ADDED)

    def get(self, kind: str, name: str) -> ApiObject:
        try:
            return self._objects[(kind, name)]
        except KeyError:
            raise ApiError(f"{kind}/{name} not found") from None

    def try_get(self, kind: str, name: str) -> Optional[ApiObject]:
        return self._objects.get((kind, name))

    def list_objects(self, kind: Optional[str] = None,
                     selector: Optional[Mapping[str, str]] = None
                     ) -> List[ApiObject]:
        with self._lock:
            if kind is not None:
                # per-kind index: avoids touching unrelated kinds entirely
                pool = [(n, o) for n, o in self._by_kind.get(kind, {}).items()]
            else:
                pool = [((k, n), o) for (k, n), o in self._objects.items()]
        out = []
        for _, obj in sorted(pool, key=lambda t: t[0]):
            if selector and any(obj.meta.labels.get(lk) != lv
                                for lk, lv in selector.items()):
                continue
            out.append(obj)
        return out

    def count(self, kind: str) -> int:
        return len(self._by_kind.get(kind, {}))

    def delete(self, kind: str, name: str,
               resource_version: Optional[int] = None) -> ApiObject:
        with self._lock:
            obj = self.get(kind, name)
            self._check_version(obj, resource_version)
            del self._objects[(kind, name)]
            self._by_kind.get(kind, {}).pop(name, None)
            return self._bump(obj, DELETED)

    # -- spec writes (bump generation) -------------------------------------
    def update_spec(self, kind: str, name: str,
                    mutate: Callable[[Any], Any],
                    resource_version: Optional[int] = None) -> ApiObject:
        """Apply ``mutate`` to the spec payload; marks intent as changed.

        ``mutate`` may modify the payload in place (return None) or
        return a replacement payload of the same registered type.
        """
        with self._lock:
            obj = self.get(kind, name)
            self._check_version(obj, resource_version)
            new_spec = mutate(obj.spec)
            if new_spec is not None:
                if self.kind_of(new_spec) != kind:
                    raise ApiError(f"replacement spec for {kind}/{name} has "
                                   f"kind {self.kind_of(new_spec)}")
                obj.spec = new_spec
            obj.meta.generation += 1
            return self._bump(obj, MODIFIED)

    # -- status writes (resource version only) -----------------------------
    def update_status(self, kind: str, name: str,
                      mutate: Callable[[ObjectStatus], None]) -> ApiObject:
        with self._lock:
            obj = self.get(kind, name)
            mutate(obj.status)
            return self._bump(obj, MODIFIED)

    def set_condition(self, kind: str, name: str, cond: Condition) -> bool:
        """Idempotent condition write. Returns True iff state changed."""
        with self._lock:
            obj = self.get(kind, name)
            existing = obj.status.condition(cond.type)
            if existing is not None:
                if existing.same_state(cond):
                    return False
                if existing.status == cond.status:
                    # same status, new reason/generation: keep old timestamp
                    cond = replace(cond,
                                   last_transition=existing.last_transition)
                obj.status.conditions[
                    obj.status.conditions.index(existing)] = cond
            else:
                obj.status.conditions.append(cond)
            self._bump(obj, MODIFIED)
            return True

    def set_output(self, kind: str, name: str, key: str, value: Any) -> None:
        self.update_status(kind, name,
                           lambda st: st.outputs.__setitem__(key, value))

    # -- watch -------------------------------------------------------------
    def watch(self, kind: Optional[str] = None,
              since_version: int = 0) -> Watch:
        return Watch(self, kind, since_version)

    # -- introspection -----------------------------------------------------
    @property
    def resource_version(self) -> int:
        # tracked explicitly (not read off the log tail) so a recovered
        # store whose last durable event was a DELETE keeps counting from
        # the right place
        return self._last_version

    def __len__(self) -> int:
        return len(self._objects)

    def __repr__(self) -> str:
        kinds: Dict[str, int] = {}
        for (k, _) in self._objects:
            kinds[k] = kinds.get(k, 0) + 1
        return f"ApiStore(v{self.resource_version}, {kinds})"
