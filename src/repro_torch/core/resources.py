"""DRA-style resource inventory: Devices, ResourceSlices, ResourcePool.

Mirrors the paper's §III.A "Richer Resource Profiles": a driver can
"publish not just the existence of a physical NIC, but also its NUMA node
and PCI root address", and equally "model more abstract resources, such as
an SR-IOV Virtual Function or even a provisioned network service". A
:class:`Device` is therefore *anything* with attributes + capacity — a TPU
chip, an ICI link, a RoCE NIC, a DCN port, or a logical network service.

Discovery (DraNet workflow step 1): each node's driver produces one or
more :class:`ResourceSlice` objects; the :class:`ResourcePool` aggregates
slices cluster-wide and serves the allocator.

The port's own copy of the JAX package's ``core/resources.py`` (that module
imports no JAX, but the port imports nothing of that package).
"""

from __future__ import annotations

from bisect import bisect_left
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

from .attributes import AttributeSet, Quantity, normalize_attr

__all__ = [
    "Device", "ResourceSlice", "ResourcePool", "DeviceRef", "DeviceIndex",
]


@dataclass
class Device:
    """One allocatable device published by a driver.

    ``name`` is unique within its slice's pool; the fully-qualified id is
    ``<driver>/<pool>/<name>``.
    """

    name: str
    attributes: AttributeSet = field(default_factory=AttributeSet)
    capacity: Dict[str, Quantity] = field(default_factory=dict)

    # Filled by the owning slice at publication time:
    driver: str = ""
    pool: str = ""
    node: str = ""

    def set_capacity(self, name: str, value: Any) -> "Device":
        self.capacity[name] = Quantity.parse(value)
        return self

    @property
    def id(self) -> str:
        return f"{self.driver}/{self.pool}/{self.name}"

    def cel_env(self) -> Dict[str, Any]:
        """The ``device`` environment bound when evaluating selectors."""
        return {
            "name": self.name,
            "driver": self.driver,
            "pool": self.pool,
            "node": self.node,
            "attributes": self.attributes,
            "capacity": dict(self.capacity),
        }

    def __repr__(self) -> str:
        return f"Device({self.id})"


@dataclass(frozen=True)
class DeviceRef:
    """A stable reference to an allocated device (claim status entry)."""

    driver: str
    pool: str
    name: str
    node: str

    @staticmethod
    def of(d: Device) -> "DeviceRef":
        return DeviceRef(d.driver, d.pool, d.name, d.node)

    @property
    def id(self) -> str:
        return f"{self.driver}/{self.pool}/{self.name}"


@dataclass
class ResourceSlice:
    """A driver's inventory advertisement for one pool on one node.

    DraNet workflow: "The DraNet daemon on each node discovers network
    interfaces and their topological attributes (PCI root, NUMA node) and
    publishes them as ResourceSlices API objects."
    """

    driver: str
    pool: str
    node: str
    devices: List[Device] = field(default_factory=list)
    generation: int = 0

    def __post_init__(self) -> None:
        for d in self.devices:
            self._adopt(d)

    def _adopt(self, d: Device) -> None:
        d.driver = self.driver
        d.pool = self.pool
        d.node = self.node

    def add(self, device: Device) -> "ResourceSlice":
        self._adopt(device)
        self.devices.append(device)
        return self

    def __iter__(self) -> Iterator[Device]:
        return iter(self.devices)

    def __len__(self) -> int:
        return len(self.devices)


class DeviceIndex:
    """Free-device index for one device filter (class+selector fingerprint).

    Owned and maintained by :class:`ResourcePool`. ``members`` is every
    device id that matched the filter's predicate against the current
    inventory; the free lists hold the *unallocated* members, kept
    **sorted by id** (cluster-wide and per node) so the allocator's
    candidate lists are a plain copy — no per-allocation sort, no
    re-evaluation of CEL selectors. The pool maintains the lists on
    allocate/release (bisect insert/remove); the whole index is rebuilt
    only when the inventory generation moves (slice publish / node
    withdrawal).
    """

    __slots__ = ("key", "members", "_free_all", "_free_by_node", "generation")

    def __init__(self, key: Any) -> None:
        self.key = key
        self.members: set = set()                       # matching device ids
        self._free_all: List[Device] = []               # sorted by id
        self._free_by_node: Dict[str, List[Device]] = {}  # node -> sorted
        self.generation = -1                            # inventory gen built at

    def rebuild(self, devices: Iterable[Device],
                allocated: Mapping[str, str], generation: int) -> None:
        self.members.clear()
        free: List[Device] = []
        for d in devices:
            self.members.add(d.id)
            if d.id not in allocated:
                free.append(d)
        free.sort(key=_device_id)
        self._free_all = free
        self._free_by_node = {}
        for d in free:
            self._free_by_node.setdefault(d.node, []).append(d)  # sorted order
        self.generation = generation

    def mark(self, device: Device, free: bool) -> None:
        """O(log n) free-list maintenance for one allocate/release."""
        if device.id not in self.members:
            return
        for lst in (self._free_all,
                    self._free_by_node.setdefault(device.node, [])):
            i = bisect_left(lst, device.id, key=_device_id)
            if free:
                if i >= len(lst) or lst[i].id != device.id:
                    lst.insert(i, device)
            elif i < len(lst) and lst[i].id == device.id:
                del lst[i]

    def free_devices(self, node: Optional[str] = None) -> List[Device]:
        """Free matching devices, sorted by id (live list — do not mutate)."""
        if node is not None:
            return self._free_by_node.get(node, [])
        return self._free_all

    def free_ids(self, node: Optional[str] = None) -> List[str]:
        return [d.id for d in self.free_devices(node)]


def _device_id(d: Device) -> str:
    return d.id


class ResourcePool:
    """Cluster-wide aggregation of ResourceSlices + allocation bookkeeping.

    This plays the role of the scheduler's view of all published slices.
    Allocation state lives here (not on devices) so that re-planning after
    a node failure is just: drop the node's slices, re-run the allocator.

    Hot-path structure: ``_by_id`` gives O(1) device lookup (the
    controllers probe every allocated device each reconcile);
    ``inventory_generation`` versions the topology so allocator candidate
    caches and :class:`DeviceIndex` free sets invalidate only when a slice
    actually changed, not on every allocation.
    """

    # LRU bound on registered free-device indexes (distinct selector
    # fingerprints); beyond this, coldest indexes are evicted and simply
    # rebuilt on next use.
    MAX_INDEXES = 64

    def __init__(self) -> None:
        self._slices: List[ResourceSlice] = []
        self._allocated: Dict[str, str] = {}  # device id -> claim uid
        self._by_claim: Dict[str, set] = {}   # claim uid -> device ids
        self._by_id: Dict[str, Device] = {}   # device id -> device
        self._indexes: Dict[Any, DeviceIndex] = {}
        self._inventory_gen = 0
        self._release_gen = 0

    # -- publication ------------------------------------------------------
    def publish(self, slice_: ResourceSlice) -> None:
        # re-publication by (driver, pool, node) replaces the old slice
        kept = []
        for s in self._slices:
            if s.driver == slice_.driver and s.pool == slice_.pool and s.node == slice_.node:
                for d in s:
                    self._by_id.pop(d.id, None)
            else:
                kept.append(s)
        kept.append(slice_)
        self._slices = kept
        for d in slice_:
            self._by_id[d.id] = d
        self._inventory_gen += 1

    def withdraw_node(self, node: str) -> List[ResourceSlice]:
        """Remove all slices for a node (node failure / drain). Returns them."""
        gone = [s for s in self._slices if s.node == node]
        if not gone:
            return gone
        self._slices = [s for s in self._slices if s.node != node]
        # allocations on vanished devices are implicitly broken; drop them
        for s in gone:
            for d in s:
                self._by_id.pop(d.id, None)
                uid = self._allocated.pop(d.id, None)
                if uid is not None:
                    self._by_claim.get(uid, set()).discard(d.id)
        self._inventory_gen += 1
        return gone

    # -- queries ----------------------------------------------------------
    @property
    def slices(self) -> Sequence[ResourceSlice]:
        return tuple(self._slices)

    @property
    def inventory_generation(self) -> int:
        """Bumped on publish/withdraw only — NOT on allocate/release."""
        return self._inventory_gen

    @property
    def release_generation(self) -> int:
        """Bumped on release() only — devices returning to the free pool.

        Withdrawal is *not* a release (the devices are gone, not free);
        it bumps ``inventory_generation`` instead. Only a release can
        unblock a pending claim — allocations never can — so the event
        loop watches this (and only this) to requeue unallocated claims
        when capacity returns, without re-scanning on every allocation.
        """
        return self._release_gen

    def devices(self, include_allocated: bool = False) -> List[Device]:
        out = []
        for s in self._slices:
            for d in s:
                if include_allocated or d.id not in self._allocated:
                    out.append(d)
        return out

    def nodes(self) -> List[str]:
        return sorted({s.node for s in self._slices})

    def get(self, device_id: str) -> Optional[Device]:
        return self._by_id.get(device_id)

    def is_allocated(self, device_id: str) -> bool:
        return device_id in self._allocated

    def owner(self, device_id: str) -> Optional[str]:
        return self._allocated.get(device_id)

    # -- free-device indexes ------------------------------------------------
    def index(self, key: Any, predicate: Callable[[Device], bool]) -> DeviceIndex:
        """The free-device index for ``key``, (re)built if the inventory moved.

        ``predicate`` is the attribute-level device filter (device-class
        selectors + request selectors); it is evaluated once per device
        per inventory generation instead of once per device per allocate
        call — the CEL evaluations this avoids are the allocator's
        dominant cost at scale.
        """
        idx = self._indexes.pop(key, None)
        if idx is None and len(self._indexes) >= self.MAX_INDEXES:
            # LRU eviction: _indexes is insertion-ordered and every hit
            # re-inserts at the end, so the first key is the coldest.
            # Bounds both memory and the per-device _index_mark walk when
            # claims carry unboundedly many distinct selector strings.
            del self._indexes[next(iter(self._indexes))]
        if idx is None:
            idx = DeviceIndex(key)
        self._indexes[key] = idx
        if idx.generation != self._inventory_gen:
            idx.rebuild((d for s in self._slices for d in s
                         if predicate(d)),
                        self._allocated, self._inventory_gen)
        return idx

    def _index_mark(self, device: Device, free: bool) -> None:
        for idx in self._indexes.values():
            if idx.generation == self._inventory_gen:
                idx.mark(device, free)

    # -- allocation bookkeeping --------------------------------------------
    def mark_allocated(self, devices: Iterable[Device], claim_uid: str) -> None:
        devices = list(devices)
        for d in devices:
            if d.id in self._allocated:
                raise ValueError(f"device {d.id} already allocated to "
                                 f"{self._allocated[d.id]}")
        for d in devices:
            self._allocated[d.id] = claim_uid
            self._by_claim.setdefault(claim_uid, set()).add(d.id)
            self._index_mark(d, free=False)

    def release(self, claim_uid: str) -> int:
        ids = self._by_claim.pop(claim_uid, set())
        for device_id in ids:
            self._allocated.pop(device_id, None)
            dev = self._by_id.get(device_id)
            if dev is not None:
                self._index_mark(dev, free=True)
        if ids:
            self._release_gen += 1
        return len(ids)

    def utilization(self) -> Tuple[int, int]:
        total = sum(len(s) for s in self._slices)
        return len(self._allocated), total

    def __repr__(self) -> str:
        a, t = self.utilization()
        return f"ResourcePool(slices={len(self._slices)}, allocated={a}/{t})"
