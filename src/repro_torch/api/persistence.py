"""Durable control plane: WAL-backed ApiStore persistence + recovery.

The paper's architectural bet is that network resource state belongs in
the cluster's *declarative core* — versioned objects that survive
component restarts, so controllers converge from stored state instead of
re-running imperative wiring. This module is that durability layer for
the in-memory :class:`~repro_torch.api.store.ApiStore`:

* **Codec** — deterministic, type-tagged JSON serialization of every
  registered API payload (claims, templates, classes, slices, workloads)
  plus the :class:`~repro_torch.api.objects.ApiObject` envelope (meta,
  conditions, outputs). ``store_dump_json`` of a store and of its
  recovered twin are byte-identical; derived values that cannot be
  serialized (a ``DeviceMesh``, a ``MeshPlan``) become :class:`Unpersisted`
  markers and are re-derived by the reconcilers after recovery.
* **WriteAheadLog** — an append-only, CRC-framed record log. Writes are
  unbuffered (SIGKILL loses nothing past the ``write()``) and fsync'd in
  batches (``fsync_every``) so power-loss durability is bounded without
  paying a sync per event. Replay tolerates a torn tail: a truncated or
  corrupt record ends the log, it never corrupts the store.
* **StoreJournal** — hooks the store's watch stream (`store.add_journal`)
  and coalesces events per object until ``flush()`` (the
  :class:`~repro_torch.api.controllers.ControlPlane` flushes at every
  reconcile fixpoint), appending one WAL record per touched object with
  its ``resource_version``. Every ``snapshot_every`` WAL records the
  journal compacts: full store snapshot keyed by the store generation
  (resource version), fresh WAL segment, old segments deleted.
* **recover_store** — newest readable snapshot + WAL replay → a fresh
  store with the original uids, resource versions, generations and
  condition history, plus a synthesized watch log so a new control
  plane's cursors re-seed their dirty queues from the recovered objects.

Layout of a state directory::

    state/
      snapshot-000000000137.json   # full dump at resource_version 137
      wal-000000000137.log         # events with resource_version > 137

The port's own copy of the JAX package's ``api/persistence.py`` (pure
Python; the port imports nothing of that package). ``FORMAT_VERSION``
and the codec table are the same field for field, so a state directory
written by either package recovers in the other. The one difference in
the WAL: the port's pickled batches carry each object's codec dump (a
frame then names no Python module, and the JAX package replays it),
and its replay maps the JAX package's module names onto the port's when
it unpickles a batch that package wrote. A ``DeviceMesh`` output
persists as an ``Unpersisted("DeviceMesh")`` marker where the JAX
package writes ``Unpersisted("Mesh")``.
"""

from __future__ import annotations

import atexit
import hashlib
import io
import itertools
import json
import pickle
import os
import re
import time
import zlib
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterator, List, Optional, Tuple,
                    Type)

from ..core.attributes import AttributeSet, Quantity, Version
from ..core.claims import (AllocatedDevice, AllocationResult, ClaimSpec,
                           DeviceClass, DeviceConfig, DeviceRequest,
                           MatchAttribute, NetworkDeviceData, ResourceClaim,
                           ResourceClaimTemplate)
from ..core.oci import AttachmentSpec, DeviceBinding
from ..core.planner import AxisSpec
from ..core.resources import Device, DeviceRef, ResourceSlice
from .chaos import sync_point
from .objects import (ApiObject, CanaryRollout, Condition, DisruptionBudget,
                      Lease, Node, ObjectMeta, ObjectStatus, Workload,
                      CONDITION_ALLOCATED)
from .store import ADDED, DELETED, MODIFIED, ApiStore, WatchEvent

__all__ = [
    "FORMAT_VERSION", "Unpersisted", "UnencodableError", "RecoveryError",
    "encode", "decode", "dump_api_object", "load_api_object",
    "dump_store", "load_store", "store_dump_json", "store_fingerprint",
    "allocation_records", "allocation_fingerprint",
    "WriteAheadLog", "StoreJournal", "RecoveryInfo",
    "recover_store", "has_state",
]

FORMAT_VERSION = 1

_SNAPSHOT_RE = re.compile(r"^snapshot-(\d{12})\.json$")
_DELTA_RE = re.compile(r"^delta-(\d{12})\.json$")
_WAL_RE = re.compile(r"^wal-(\d{12})\.log$")


class UnencodableError(TypeError):
    """A value with no registered codec reached a strict encode."""


class RecoveryError(RuntimeError):
    """The state directory holds no usable snapshot or WAL."""


class Unpersisted:
    """Placeholder for a status output that could not be serialized.

    Derived artifacts (``DeviceMesh``, ``MeshPlan``) are rebuildable by the
    reconcilers, so the journal records only *that* something was there.
    ``ControlPlane.adopt`` strips these markers (and the attachment
    fingerprint guarding them) so the AttachmentController re-derives the
    real values after recovery.
    """

    __slots__ = ("type_name",)

    def __init__(self, type_name: str) -> None:
        self.type_name = type_name

    def __eq__(self, other: Any) -> bool:
        return (isinstance(other, Unpersisted)
                and other.type_name == self.type_name)

    def __hash__(self) -> int:
        return hash(("Unpersisted", self.type_name))

    def __repr__(self) -> str:
        return f"Unpersisted({self.type_name})"


# ---------------------------------------------------------------------------
# Codec: type-tagged JSON for every persistable API value
# ---------------------------------------------------------------------------
# Every non-scalar encodes to {"!": <tag>, ...}; plain dicts get the "dict"
# tag so payload dicts can never collide with the envelope itself.

# tag -> (type, persisted field names); decoded via cls(**fields).
_DATACLASS_CODECS: Dict[str, Tuple[Type[Any], Tuple[str, ...]]] = {
    "DeviceRef": (DeviceRef, ("driver", "pool", "name", "node")),
    "AllocatedDevice": (AllocatedDevice, ("request", "ref")),
    "NetworkDeviceData": (NetworkDeviceData,
                          ("interface_name", "ips", "hardware_address")),
    "AllocationResult": (AllocationResult,
                         ("devices", "node", "device_statuses")),
    "DeviceConfig": (DeviceConfig, ("driver", "parameters")),
    "MatchAttribute": (MatchAttribute, ("attribute", "requests")),
    "DeviceRequest": (DeviceRequest, ("name", "device_class", "selectors",
                                      "count", "allocation_mode")),
    "ClaimSpec": (ClaimSpec, ("requests", "constraints", "config",
                              "topology_scope")),
    "ResourceClaim": (ResourceClaim, ("name", "spec", "uid", "allocation",
                                      "prepared", "reserved_for")),
    "DeviceClass": (DeviceClass, ("name", "selectors", "config")),
    "Device": (Device, ("name", "attributes", "capacity",
                        "driver", "pool", "node")),
    "ResourceSlice": (ResourceSlice, ("driver", "pool", "node", "devices",
                                      "generation")),
    "Workload": (Workload, ("claim", "claim_template", "axes", "placement",
                            "seed", "role", "replicas", "build_mesh",
                            "max_surge", "max_unavailable", "runtime_config",
                            "canary_config", "canary_replicas")),
    "Node": (Node, ("name", "provider", "unschedulable", "drain", "pod")),
    "Lease": (Lease, ("name", "holder", "duration_s", "acquired")),
    "DisruptionBudget": (DisruptionBudget,
                         ("name", "selector", "min_available")),
    "CanaryRollout": (CanaryRollout, ("name", "workload", "config",
                                      "replicas", "slo", "min_samples")),
    "AxisSpec": (AxisSpec, ("name", "size", "physical")),
    "Condition": (Condition, ("type", "status", "reason", "message",
                              "observed_generation", "last_transition")),
    "ObjectMeta": (ObjectMeta, ("name", "kind", "uid", "resource_version",
                                "generation", "labels", "created")),
    "DeviceBinding": (DeviceBinding, ("device_id", "mesh_coord", "attrs")),
    "AttachmentSpec": (AttachmentSpec, ("axis_names", "axis_shape",
                                        "bindings", "metadata")),
}
_TAG_OF_TYPE: Dict[Type[Any], str] = {
    cls: tag for tag, (cls, _) in _DATACLASS_CODECS.items()}

_COUNT_RE = re.compile(r"count\((-?\d+)")


def _count_value(counter: "itertools.count") -> int:
    """Next value an ``itertools.count`` will yield (template continuity)."""
    m = _COUNT_RE.search(repr(counter))
    return int(m.group(1)) if m else 0


def encode(value: Any, lenient: bool = False) -> Any:
    """Recursively encode ``value`` into tagged, JSON-serializable form.

    ``lenient=True`` (used for status outputs) replaces unencodable
    values with :class:`Unpersisted` markers instead of raising.
    """
    if value is None or isinstance(value, (bool, int, str)):
        return value
    if isinstance(value, float):
        return value
    if isinstance(value, list):
        return [encode(v, lenient) for v in value]
    if isinstance(value, tuple):
        return {"!": "tuple", "v": [encode(v, lenient) for v in value]}
    if isinstance(value, dict):
        return {"!": "dict",
                "v": [[encode(k, lenient), encode(v, lenient)]
                      for k, v in value.items()]}
    if isinstance(value, Quantity):
        return {"!": "Quantity", "value": value.value, "raw": value.raw}
    if isinstance(value, Version):
        return {"!": "Version", "major": value.major, "minor": value.minor,
                "patch": value.patch}
    if isinstance(value, AttributeSet):
        return {"!": "AttributeSet",
                "v": [[k, encode(v, lenient)] for k, v in value.items()]}
    if isinstance(value, ResourceClaimTemplate):
        return {"!": "ResourceClaimTemplate", "name": value.name,
                "spec": encode(value.spec, lenient),
                "counter": _count_value(value._counter)}
    if isinstance(value, Unpersisted):
        return {"!": "unpersisted", "type": value.type_name}
    tag = _TAG_OF_TYPE.get(type(value))
    if tag is not None:
        _, fields = _DATACLASS_CODECS[tag]
        return {"!": tag,
                "f": {f: encode(getattr(value, f), lenient) for f in fields}}
    if lenient:
        return {"!": "unpersisted", "type": type(value).__name__}
    raise UnencodableError(
        f"no codec for {type(value).__name__!r} (value {value!r:.80})")


def decode(value: Any) -> Any:
    """Inverse of :func:`encode`."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return value
    if isinstance(value, list):
        return [decode(v) for v in value]
    tag = value["!"]
    if tag == "tuple":
        return tuple(decode(v) for v in value["v"])
    if tag == "dict":
        return {decode(k): decode(v) for k, v in value["v"]}
    if tag == "Quantity":
        return Quantity(value["value"], value["raw"])
    if tag == "Version":
        return Version(value["major"], value["minor"], value["patch"])
    if tag == "AttributeSet":
        return AttributeSet({k: decode(v) for k, v in value["v"]})
    if tag == "ResourceClaimTemplate":
        tmpl = ResourceClaimTemplate(name=value["name"],
                                     spec=decode(value["spec"]))
        tmpl._counter = itertools.count(value["counter"])
        return tmpl
    if tag == "unpersisted":
        return Unpersisted(value["type"])
    if tag in _DATACLASS_CODECS:
        cls, _ = _DATACLASS_CODECS[tag]
        return cls(**{f: decode(v) for f, v in value["f"].items()})
    raise UnencodableError(f"unknown codec tag {tag!r}")


# ---------------------------------------------------------------------------
# Envelope + whole-store dumps
# ---------------------------------------------------------------------------

def dump_api_object(obj: ApiObject) -> Dict[str, Any]:
    return {
        "meta": encode(obj.meta),
        "spec": encode(obj.spec),
        "status": {
            "conditions": [encode(c) for c in obj.status.conditions],
            "outputs": {k: encode(v, lenient=True)
                        for k, v in obj.status.outputs.items()},
        },
    }


def load_api_object(d: Dict[str, Any]) -> ApiObject:
    status = ObjectStatus(
        conditions=[decode(c) for c in d["status"]["conditions"]],
        outputs={k: decode(v) for k, v in d["status"]["outputs"].items()})
    return ApiObject(meta=decode(d["meta"]), spec=decode(d["spec"]),
                     status=status)


def dump_store(store: ApiStore) -> Dict[str, Any]:
    """Deterministic full-store dump (objects sorted by kind, name).

    The store lock is held for the WHOLE dump, not just the listing:
    with threaded informer workers mutating object status in place, a
    lock-free encode could serialize a half-updated object (allocation
    present, condition not yet written) into a checkpoint manifest.
    """
    with store.lock:
        objects = []
        for obj in sorted(store.list_objects(),
                          key=lambda o: (o.meta.kind, o.meta.name)):
            objects.append(dump_api_object(obj))
        return {"format": FORMAT_VERSION,
                "resource_version": store.resource_version,
                "objects": objects}


def load_store(dump: Dict[str, Any]) -> ApiStore:
    """Rebuild an :class:`ApiStore` from a :func:`dump_store` dump."""
    if dump.get("format") != FORMAT_VERSION:
        raise RecoveryError(f"unsupported store dump format "
                            f"{dump.get('format')!r}")
    objects = {}
    for d in dump["objects"]:
        obj = load_api_object(d)
        objects[(obj.meta.kind, obj.meta.name)] = obj
    return _store_from_objects(objects, dump["resource_version"])


def _store_from_objects(objects: Dict[Tuple[str, str], ApiObject],
                        last_version: int) -> ApiStore:
    """Assemble a store: indexes, version counter, synthesized watch log.

    The log gets one ADDED event per live object (sorted by resource
    version) so a fresh watch at ``since_version=0`` sees every recovered
    object — this is what re-seeds a new control plane's dirty queues.
    """
    store = ApiStore()
    ordered = sorted(objects.items(),
                     key=lambda kv: kv[1].meta.resource_version)
    for (kind, name), obj in ordered:
        store._objects[(kind, name)] = obj
        store._by_kind.setdefault(kind, {})[name] = obj
        store._log.append(WatchEvent(ADDED, kind, name,
                                     obj.meta.resource_version, obj))
        last_version = max(last_version, obj.meta.resource_version)
    store._last_version = last_version
    store._version = itertools.count(last_version + 1)
    return store


def store_dump_json(store: ApiStore) -> str:
    return json.dumps(dump_store(store), sort_keys=True,
                      separators=(",", ":"))


def store_fingerprint(store: ApiStore) -> str:
    return hashlib.sha256(store_dump_json(store).encode()).hexdigest()


def allocation_records(store: ApiStore) -> Dict[str, str]:
    """claim name -> digest of (uid, allocation, Allocated condition).

    The crash-recovery acceptance check: a claim adopted from persisted
    state must keep a byte-identical allocation *and* an untouched
    ``Allocated`` condition (same reason, same transition timestamp)
    through the post-recovery reconcile — zero spurious re-allocations.
    """
    out: Dict[str, str] = {}
    for obj in store.list_objects("ResourceClaim"):
        claim: ResourceClaim = obj.spec
        if not claim.allocated:
            continue
        rec = json.dumps({"uid": claim.uid,
                          "allocation": encode(claim.allocation),
                          "condition": encode(
                              obj.condition(CONDITION_ALLOCATED))},
                         sort_keys=True, separators=(",", ":"))
        out[obj.meta.name] = hashlib.sha256(rec.encode()).hexdigest()
    return out


def allocation_fingerprint(store: ApiStore) -> str:
    blob = json.dumps(sorted(allocation_records(store).items()))
    return hashlib.sha256(blob.encode()).hexdigest()


# ---------------------------------------------------------------------------
# Write-ahead log
# ---------------------------------------------------------------------------

class WriteAheadLog:
    """Append-only CRC-framed record log with batched fsync.

    Frame: ``<crc32:8 hex> <len:8 hex> <payload>\\n`` where the payload's
    first byte tags its encoding — ``J`` for one codec-JSON record, ``P``
    for a pickled *batch* of records. Batching is the hot path: one
    ``pickle.dumps`` over a flush window amortizes serializer setup and
    the write syscall. The port pickles each object's codec dump, never
    the object, so its frames name no Python module and the JAX
    package's replay reads them; replay reads that package's frames of
    pickled objects through :class:`_PortUnpickler`.

    Writes go through an unbuffered file object, so a SIGKILL can only
    lose records never handed to the kernel; ``fsync_every`` (counted in
    records) bounds what a *power loss* can take. Replay stops at the
    first frame that fails length or CRC validation — a torn tail is
    dropped as a unit, never half-applied.
    """

    def __init__(self, path: str, fsync_every: int = 2048):
        self.path = path
        self.fsync_every = fsync_every
        self._f = open(path, "ab", buffering=0)
        self.records = 0
        self.frames = 0
        self.bytes_written = 0
        self.fsyncs = 0
        self._since_sync = 0

    def _write_frame(self, payload: bytes, records: int) -> int:
        sync_point("wal.append", path=self.path, records=records)
        frame = (b"%08x %08x " % (zlib.crc32(payload), len(payload))
                 + payload + b"\n")
        self._f.write(frame)
        self.records += records
        self.frames += 1
        self.bytes_written += len(frame)
        self._since_sync += records
        if self._since_sync >= self.fsync_every:
            self.sync()
        return len(frame)

    def append(self, record: Dict[str, Any]) -> int:
        """Append one codec-JSON record (the debuggable slow path)."""
        payload = b"J" + json.dumps(record, separators=(",", ":")).encode()
        return self._write_frame(payload, 1)

    def append_batch(self, entries: List[Tuple[int, str, str, str,
                                               Any]]) -> int:
        """Append a flush window as one pickled frame (the hot path).

        Each entry is ``(resource_version, event_type, kind, name,
        payload)`` with payload an :class:`ApiObject`, a codec dump
        dict, or None (deletes); objects are written as their codec
        dumps.
        """
        entries = [e if e[4] is None or isinstance(e[4], dict)
                   else (e[0], e[1], e[2], e[3], dump_api_object(e[4]))
                   for e in entries]
        blob = pickle.dumps(entries, pickle.HIGHEST_PROTOCOL)
        return self._write_frame(b"P" + blob, len(entries))

    def sync(self) -> None:
        if not self._f.closed:
            os.fsync(self._f.fileno())
            self.fsyncs += 1
        self._since_sync = 0

    def close(self) -> None:
        if not self._f.closed:
            self.sync()
            self._f.close()

    @staticmethod
    def replay(path: str) -> Iterator[Dict[str, Any]]:
        """Yield valid records in order; stop silently at a torn tail.

        Records are normalized dicts ``{"v", "t", "k", "n"}`` plus
        either ``"o"`` (codec dump) or ``"obj"`` (live unpickled
        object); deletes carry neither.
        """
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return
        pos = 0
        while pos < len(data):
            header = data[pos:pos + 18]
            if len(header) < 18 or header[8:9] != b" " or header[17:18] != b" ":
                return
            try:
                crc = int(header[:8], 16)
                length = int(header[9:17], 16)
            except ValueError:
                return
            payload = data[pos + 18:pos + 18 + length]
            tail = data[pos + 18 + length:pos + 19 + length]
            if len(payload) < length or tail != b"\n":
                return
            if zlib.crc32(payload) != crc:
                return
            kind, body = payload[:1], payload[1:]
            if kind == b"J":
                try:
                    yield json.loads(body)
                except ValueError:
                    return
            elif kind == b"P":
                try:
                    entries = _PortUnpickler(io.BytesIO(body)).load()
                except Exception:  # noqa: BLE001
                    return
                for v, t, k, n, obj in entries:
                    rec: Dict[str, Any] = {"v": v, "t": t, "k": k, "n": n}
                    if isinstance(obj, dict):
                        rec["o"] = obj
                    elif obj is not None:
                        rec["obj"] = obj
                    yield rec
            else:
                return
            pos += 19 + length


class _PortUnpickler(pickle.Unpickler):
    """Unpickles a batch of live objects the JAX package's WAL wrote:
    its ``repro.<module>`` classes load as the port's
    ``repro_torch.<module>`` twins (same names, same fields)."""

    def find_class(self, module: str, name: str) -> Any:
        if module.startswith("repro."):
            module = "repro_torch." + module[len("repro."):]
        return super().find_class(module, name)


# ---------------------------------------------------------------------------
# Journal: store events -> WAL, with snapshot compaction
# ---------------------------------------------------------------------------

def _state_files(path: str, pattern: re.Pattern) -> List[Tuple[int, str]]:
    out = []
    try:
        names = os.listdir(path)
    except OSError:
        return out
    for name in names:
        m = pattern.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(path, name)))
    return sorted(out)


def has_state(path: str) -> bool:
    """Does ``path`` hold a recoverable snapshot, delta chain or WAL?"""
    return bool(_state_files(path, _SNAPSHOT_RE)
                or _state_files(path, _DELTA_RE)
                or _state_files(path, _WAL_RE))


class StoreJournal:
    """Durability sidecar for one :class:`ApiStore`.

    Registers an event hook on the store's watch stream; events coalesce
    per object (latest state wins within a flush window) and ``flush()``
    appends one WAL record per touched object. The control plane flushes
    at every reconcile fixpoint, so the durability horizon is one
    reconcile call; ``flush_every`` caps the window for stores mutated
    outside a reconcile loop. Compaction (full snapshot + fresh WAL
    segment + old-segment deletion) runs every ``snapshot_every`` WAL
    records, keyed by the store generation (resource version).
    """

    def __init__(self, store: ApiStore, path: str, *,
                 fsync_every: int = 2048, flush_every: int = 512,
                 flush_batch: int = 64, snapshot_every: int = 4096,
                 full_snapshot_every: int = 8):
        self.store = store
        self.path = path
        self.fsync_every = fsync_every
        self.flush_every = flush_every
        self.flush_batch = flush_batch
        self.snapshot_every = snapshot_every
        # incremental compaction: only every Nth compaction rewrites the
        # full store; the ones between write a delta record holding just
        # the objects touched since the previous compaction (plus
        # tombstones), so compaction cost tracks churn, not store size.
        # 1 = every compaction is full (the pre-delta behavior).
        self.full_snapshot_every = max(int(full_snapshot_every), 1)
        self.wal: Optional[WriteAheadLog] = None
        self.snapshots = 0           # full snapshots written
        self.delta_snapshots = 0     # delta records written
        self.events_seen = 0
        # wall time spent serializing/writing (the bench's noise-free
        # numerator for the WAL-overhead ratio)
        self.spent_s = 0.0
        # (kind, name) -> (event type, live object | None, rv for deletes)
        self._pending: Dict[Tuple[str, str],
                            Tuple[str, Optional[ApiObject], Optional[int]]] = {}
        # deletions since the last compaction (delta tombstones)
        self._deleted_since_compact: Dict[Tuple[str, str], int] = {}
        self._last_compact_rv = -1   # base the next delta diffs against
        self._full_rv = -1           # rv of the newest full snapshot
        self._deltas_since_full = 0
        self._attached = False

    # -- lifecycle ---------------------------------------------------------
    def attach(self, resume: bool = False) -> "StoreJournal":
        """Start journaling: initial snapshot + fresh WAL segment.

        Attaching an *empty* store to a directory that already has state
        is almost always a mistake (it would compact the prior state
        away) — use :func:`recover_store` / ``ControlPlane.recover``
        first, or pass ``resume=True`` to override.
        """
        os.makedirs(self.path, exist_ok=True)
        if (not resume and len(self.store) == 0 and has_state(self.path)):
            raise RecoveryError(
                f"{self.path} already holds control-plane state; recover "
                f"it (ControlPlane.recover) instead of overwriting")
        with self.store.lock:
            # snapshot and hook registration under one critical section:
            # a concurrent mutation must land either in the snapshot or
            # in the WAL, never in neither
            self._compact_locked()
            self.store.add_journal(self.on_event)
        self._attached = True
        # clean interpreter exits drain the pending window even when it
        # never reached flush_batch (short-lived scripts would otherwise
        # persist only the initial snapshot); a SIGKILL still loses the
        # window, by design
        atexit.register(self._atexit_drain)
        return self

    def _atexit_drain(self) -> None:
        try:
            self.sync()
        except Exception:  # noqa: BLE001 - never break interpreter exit
            pass

    def close(self) -> None:
        if self._attached:
            self.store.remove_journal(self.on_event)
            self._attached = False
            atexit.unregister(self._atexit_drain)
        self.flush()
        if self.wal is not None:
            self.wal.close()

    # -- event intake ------------------------------------------------------
    def on_event(self, event: WatchEvent) -> None:
        key = (event.kind, event.name)
        self.events_seen += 1
        if event.type == DELETED:
            self._pending[key] = (DELETED, None, event.resource_version)
            self._deleted_since_compact[key] = event.resource_version
        else:
            prev = self._pending.get(key)
            etype = event.type
            if etype == MODIFIED and prev is not None and prev[0] == ADDED:
                etype = ADDED          # never durably existed before this
            self._pending[key] = (etype, event.object, None)
        if len(self._pending) >= self.flush_every:
            self.flush()

    # -- durability --------------------------------------------------------
    def maybe_flush(self) -> int:
        """Flush when the pending window reached ``flush_batch`` objects.

        The reconcile loop calls this at every fixpoint; deferring the
        flush until a worthwhile batch exists is what amortizes the
        serializer and the write syscall (~200 us on overlayfs) across
        many objects. The durability horizon is therefore at most
        ``flush_batch`` touched objects (or ``flush_every`` raw events,
        whichever trips first) — call :meth:`sync` for a hard barrier.
        """
        if len(self._pending) >= self.flush_batch:
            return self.flush()
        return 0

    def flush(self) -> int:
        """Serialize the pending window into WAL records. Returns count."""
        if not self._pending or self.wal is None:
            return 0
        sync_point("journal.flush", pending=len(self._pending))
        t0 = time.perf_counter()
        with self.store.lock:
            pending, self._pending = self._pending, {}
            entries = []
            for (kind, name), (etype, obj, del_rv) in pending.items():
                if etype == DELETED:
                    entries.append((del_rv, etype, kind, name, None))
                else:
                    entries.append((obj.meta.resource_version, etype,
                                    kind, name, obj))
            self.wal.append_batch(entries)
            if self.wal.records >= self.snapshot_every:
                self._compact_locked()
        self.spent_s += time.perf_counter() - t0
        return len(pending)

    def sync(self) -> None:
        self.flush()
        if self.wal is not None:
            t0 = time.perf_counter()
            self.wal.sync()
            self.spent_s += time.perf_counter() - t0

    def compact(self) -> None:
        with self.store.lock:
            self.flush()
            self._compact_locked()

    def _compact_locked(self) -> None:
        """Compact at the current store generation; rotate the WAL.

        Every ``full_snapshot_every``-th compaction (and the first one)
        writes a full snapshot; the compactions between write an
        incremental *delta* record — only the objects whose resource
        version moved past the previous compaction, plus tombstones for
        deletions — so steady-state compaction serializes O(churn)
        instead of rewriting the whole store each time. Recovery applies
        newest full snapshot -> delta chain -> WAL.
        """
        rv = self.store.resource_version
        os.makedirs(self.path, exist_ok=True)
        full = (self._full_rv < 0 or self._last_compact_rv < 0
                or rv == self._last_compact_rv
                or self._deltas_since_full + 1 >= self.full_snapshot_every)
        if full:
            self._write_json(f"snapshot-{rv:012d}.json", dump_store(self.store))
            self._full_rv = rv
            self._deltas_since_full = 0
            self.snapshots += 1
        else:
            base = self._last_compact_rv
            with self.store.lock:
                changed = [dump_api_object(o)
                           for o in sorted(self.store.list_objects(),
                                           key=lambda o: (o.meta.kind,
                                                          o.meta.name))
                           if o.meta.resource_version > base]
            tombstones = sorted([k, n] for (k, n)
                                in self._deleted_since_compact)
            self._write_json(f"delta-{rv:012d}.json",
                             {"format": FORMAT_VERSION, "base": base,
                              "resource_version": rv, "objects": changed,
                              "deleted": tombstones})
            self._deltas_since_full += 1
            self.delta_snapshots += 1
        self._deleted_since_compact = {}
        self._last_compact_rv = rv
        if self.wal is not None:
            self.wal.close()
        self.wal = WriteAheadLog(
            os.path.join(self.path, f"wal-{rv:012d}.log"),
            fsync_every=self.fsync_every)
        # reap superseded segments: everything at or before the newest
        # full snapshot except the snapshot itself, plus any WAL the
        # delta chain now covers
        for base, fp in _state_files(self.path, _SNAPSHOT_RE):
            if base != self._full_rv:
                self._remove(fp)
        for base, fp in _state_files(self.path, _DELTA_RE):
            if base <= self._full_rv or base > rv:
                self._remove(fp)
        for base, fp in _state_files(self.path, _WAL_RE):
            if base != rv:
                self._remove(fp)

    def _write_json(self, name: str, payload: Dict[str, Any]) -> None:
        path = os.path.join(self.path, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, sort_keys=True, separators=(",", ":"))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @staticmethod
    def _remove(path: str) -> None:
        try:
            os.remove(path)
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Recovery
# ---------------------------------------------------------------------------

@dataclass
class RecoveryInfo:
    path: str
    snapshot_rv: int = -1              # -1: recovered from WAL alone
    wal_records: int = 0
    objects: int = 0
    resource_version: int = 0
    deltas_applied: int = 0            # delta records chained in
    delta_objects: int = 0
    dropped_outputs: Dict[Tuple[str, str], List[str]] = field(
        default_factory=dict)
    torn_tail: bool = False

    def summary(self) -> str:
        dropped = sum(len(v) for v in self.dropped_outputs.values())
        return (f"v{self.resource_version}: {self.objects} object(s) from "
                f"snapshot@{self.snapshot_rv} + {self.deltas_applied} "
                f"delta(s) + {self.wal_records} WAL "
                f"record(s), {dropped} derived output(s) to re-derive")


def recover_store(path: str) -> Tuple[ApiStore, RecoveryInfo]:
    """Replay snapshot + delta chain + WAL into a fresh :class:`ApiStore`.

    Picks the newest full snapshot that parses (older ones are fallbacks
    for a crash mid-compaction), chains every delta record whose ``base``
    matches the running resource version (incremental compaction,
    :class:`StoreJournal`), then applies every WAL record beyond the
    chain, in segment order. A torn WAL tail is dropped. Raises
    :class:`RecoveryError` when nothing usable exists.
    """
    snapshots = _state_files(path, _SNAPSHOT_RE)
    deltas = _state_files(path, _DELTA_RE)
    wals = _state_files(path, _WAL_RE)
    if not snapshots and not deltas and not wals:
        raise RecoveryError(f"no snapshot, delta or WAL in {path!r}")

    objects: Dict[Tuple[str, str], ApiObject] = {}
    base_rv, snapshot_rv = -1, -1
    for base, snap_path in reversed(snapshots):
        try:
            with open(snap_path) as f:
                dump = json.load(f)
            if dump.get("format") != FORMAT_VERSION:
                continue
            objects = {}
            for d in dump["objects"]:
                obj = load_api_object(d)
                objects[(obj.meta.kind, obj.meta.name)] = obj
            base_rv = snapshot_rv = dump["resource_version"]
            break
        except (OSError, ValueError, KeyError, UnencodableError):
            continue

    # delta chain: each record names the compaction generation it diffs
    # against; a gap (missing/corrupt link, or a delta older than the
    # chosen snapshot) ends the chain — later deltas cannot apply
    deltas_applied = delta_objects = 0
    chain_rv = base_rv if base_rv >= 0 else None
    for drv, delta_path in deltas:
        if chain_rv is not None and drv <= chain_rv:
            continue
        try:
            with open(delta_path) as f:
                dump = json.load(f)
            if dump.get("format") != FORMAT_VERSION:
                break
            if chain_rv is not None and dump.get("base") != chain_rv:
                break
            if chain_rv is None:
                # no usable snapshot: a chain can still start from a
                # delta whose base is the (lost) initial snapshot only
                # if it carries every live object — which we cannot
                # know, so refuse rather than silently under-recover
                break
            for k, n in dump.get("deleted", ()):
                objects.pop((k, n), None)
            for d in dump["objects"]:
                obj = load_api_object(d)
                objects[(obj.meta.kind, obj.meta.name)] = obj
                delta_objects += 1
            chain_rv = dump["resource_version"]
            deltas_applied += 1
        except (OSError, ValueError, KeyError, UnencodableError):
            break
    if chain_rv is not None:
        base_rv = max(base_rv, chain_rv)

    last_rv = max(base_rv, 0)
    replayed = 0
    for _, wal_path in wals:
        for rec in WriteAheadLog.replay(wal_path):
            if rec["v"] <= base_rv:
                continue
            key = (rec["k"], rec["n"])
            if rec["t"] == DELETED:
                objects.pop(key, None)
            elif "obj" in rec:
                objects[key] = rec["obj"]
            else:
                objects[key] = load_api_object(rec["o"])
            last_rv = max(last_rv, rec["v"])
            replayed += 1

    store = _store_from_objects(objects, last_rv)
    info = RecoveryInfo(path=path, snapshot_rv=snapshot_rv,
                        wal_records=replayed, objects=len(store),
                        resource_version=store.resource_version,
                        deltas_applied=deltas_applied,
                        delta_objects=delta_objects)
    for obj in store.list_objects():
        dropped = [k for k, v in obj.status.outputs.items()
                   if isinstance(v, Unpersisted)]
        if dropped:
            info.dropped_outputs[(obj.meta.kind, obj.meta.name)] = dropped
    return store, info
