"""ResourceClaims, DeviceClasses and cross-request constraints (DRA).

The paper's §III.A "Expressive User Intent": users request resources via
ResourceClaim objects using CEL selection, enabling topology-aware
scheduling — "a user can request a GPU and a NIC that share the same PCI
root". That cross-device relation is modelled (as in KEP-4381 structured
parameters) with :class:`MatchAttribute` constraints spanning the claim's
requests.

"Decoupled Lifecycle and Embedded Parameters": a claim carries *opaque
driver config* (``DeviceConfig``) pushed to the driver at
NodePrepareResources time, eliminating API-server callbacks on the pod
critical path (Fig. 4).

The port's own copy of the JAX package's ``core/claims.py`` (that module
imports no JAX, but the port imports nothing of that package).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from .cel import CelError, CelProgram, compile_expr
from .resources import Device, DeviceRef
from .uid import new_uid

__all__ = [
    "DeviceClass", "DeviceRequest", "MatchAttribute", "DeviceConfig",
    "AllocatedDevice", "AllocationResult", "NetworkDeviceData",
    "ResourceClaim", "ResourceClaimTemplate", "ClaimSpec",
]


@dataclass
class DeviceClass:
    """Admin-curated device category: a named bundle of CEL selectors.

    e.g. ``tpu.google.com`` (all TPU chips) or ``rdma-nic`` (RDMA-capable
    NICs). Claims reference a class and may add their own selectors.
    """

    name: str
    selectors: List[str] = field(default_factory=list)
    config: List["DeviceConfig"] = field(default_factory=list)

    def __post_init__(self) -> None:
        self._compiled = [compile_expr(s) for s in self.selectors]

    def __getstate__(self) -> Dict[str, Any]:
        # compiled CEL programs are derived state: dropping them keeps
        # WAL pickles small/fast; compile_expr is LRU-cached on load
        state = self.__dict__.copy()
        state.pop("_compiled", None)
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._compiled = [compile_expr(s) for s in self.selectors]

    def matches(self, device: Device) -> bool:
        env = {"device": device.cel_env()}
        try:
            return all(p.evaluate_bool(env) for p in self._compiled)
        except CelError:
            return False  # CEL runtime error on a device == no match (per DRA)


@dataclass
class DeviceConfig:
    """Opaque, driver-scoped configuration embedded in the claim ("push" model)."""

    driver: str
    parameters: Dict[str, Any] = field(default_factory=dict)


@dataclass
class DeviceRequest:
    """One request line inside a claim: N devices of a class + extra selectors."""

    name: str
    device_class: str
    selectors: List[str] = field(default_factory=list)
    count: int = 1
    # 'ExactCount' (default) or 'All' (all matching devices on the chosen node set)
    allocation_mode: str = "ExactCount"

    def __post_init__(self) -> None:
        if self.allocation_mode not in ("ExactCount", "All"):
            raise ValueError(
                f"allocation_mode must be 'ExactCount' or 'All', "
                f"got {self.allocation_mode!r}")
        # count is meaningless under 'All' (the allocator takes every
        # matching device), so only ExactCount validates it
        if self.allocation_mode == "ExactCount" and self.count < 1:
            raise ValueError("count must be >= 1")
        self._compiled = [compile_expr(s) for s in self.selectors]

    def __getstate__(self) -> Dict[str, Any]:
        state = self.__dict__.copy()
        state.pop("_compiled", None)        # derived; recompiled on load
        return state

    def __setstate__(self, state: Dict[str, Any]) -> None:
        self.__dict__.update(state)
        self._compiled = [compile_expr(s) for s in self.selectors]

    def selector_match(self, device: Device) -> bool:
        env = {"device": device.cel_env()}
        try:
            return all(p.evaluate_bool(env) for p in self._compiled)
        except CelError:
            return False

    def fingerprint(self) -> Tuple[str, Tuple[str, ...]]:
        """Value-based identity of this request's device filter.

        Two requests with the same class and selector strings match the
        same device set against a given inventory, so allocator candidate
        caches key on this (plus the pool's inventory generation).
        """
        return (self.device_class, tuple(self.selectors))


@dataclass
class MatchAttribute:
    """Cross-request topology constraint.

    All devices allocated for ``requests`` (or the whole claim when empty)
    must report the *same value* for ``attribute`` — exactly how "NIC on
    the same PCI root as the GPU" is expressed in structured DRA.
    """

    attribute: str
    requests: List[str] = field(default_factory=list)

    def applies_to(self, request_name: str) -> bool:
        return not self.requests or request_name in self.requests

    def value_of(self, device: Device) -> Any:
        """The constrained attribute's value on ``device`` (None = absent).

        The allocator's incremental DFS tracks one running value per
        constraint; a placement is legal iff ``value_of`` is present and
        equal to the running value — the stepwise form of :meth:`check`.
        """
        return device.attributes.get(self.attribute, None)

    def check(self, devices: Sequence[Tuple[str, Device]]) -> bool:
        """devices: (request_name, device) pairs for a tentative allocation."""
        values = []
        for req_name, dev in devices:
            if not self.applies_to(req_name):
                continue
            v = dev.attributes.get(self.attribute, None)
            if v is None:
                return False  # constrained attribute must exist
            values.append(v)
        return len(set(values)) <= 1


@dataclass
class ClaimSpec:
    requests: List[DeviceRequest] = field(default_factory=list)
    constraints: List[MatchAttribute] = field(default_factory=list)
    config: List[DeviceConfig] = field(default_factory=list)
    # 'node': all devices must come from one node (pod-local claim, the
    # common DRA case); 'cluster': devices may span nodes (multi-host mesh
    # claims — how this framework requests whole TPU slices).
    topology_scope: str = "node"

    def clone(self) -> "ClaimSpec":
        """Independent copy (templates must not alias stamped claims)."""
        return ClaimSpec(
            requests=[DeviceRequest(name=r.name, device_class=r.device_class,
                                    selectors=list(r.selectors), count=r.count,
                                    allocation_mode=r.allocation_mode)
                      for r in self.requests],
            constraints=[MatchAttribute(attribute=c.attribute,
                                        requests=list(c.requests))
                         for c in self.constraints],
            config=[DeviceConfig(driver=c.driver, parameters=dict(c.parameters))
                    for c in self.config],
            topology_scope=self.topology_scope)


@dataclass
class AllocatedDevice:
    request: str
    ref: DeviceRef


@dataclass
class NetworkDeviceData:
    """KEP-4817: standardized network interface data in claim status.

    The paper's §VII names this as "the key enabler" for composing
    independent network drivers — every driver reports allocated interface
    details in a common format.
    """

    interface_name: str = ""
    ips: List[str] = field(default_factory=list)
    hardware_address: str = ""


@dataclass
class AllocationResult:
    devices: List[AllocatedDevice] = field(default_factory=list)
    node: str = ""  # node selected by the scheduler ('' = multi-node claim)
    # driver/device id -> standardized status (KEP-4817)
    device_statuses: Dict[str, NetworkDeviceData] = field(default_factory=dict)

    def refs(self, request: Optional[str] = None) -> List[DeviceRef]:
        return [a.ref for a in self.devices if request is None or a.request == request]


@dataclass
class ResourceClaim:
    """A user's declarative request for devices (DraNet workflow step 2)."""

    name: str
    spec: ClaimSpec
    uid: str = field(default_factory=new_uid)
    # status
    allocation: Optional[AllocationResult] = None
    prepared: bool = False
    reserved_for: List[str] = field(default_factory=list)  # pod/job uids

    @property
    def allocated(self) -> bool:
        return self.allocation is not None

    def request(self, name: str) -> DeviceRequest:
        for r in self.spec.requests:
            if r.name == name:
                return r
        raise KeyError(f"no request {name!r} in claim {self.name!r}")

    def config_for(self, driver: str) -> List[Dict[str, Any]]:
        """Opaque parameters destined for ``driver`` (the DRA push model)."""
        return [c.parameters for c in self.spec.config if c.driver == driver]


@dataclass
class ResourceClaimTemplate:
    """Stamped out per pod/job replica (as used by the paper's StatefulSets)."""

    name: str
    spec: ClaimSpec
    _counter: itertools.count = field(default_factory=itertools.count, repr=False)

    def instantiate(self, owner: str) -> ResourceClaim:
        i = next(self._counter)
        return ResourceClaim(name=f"{self.name}-{owner}-{i}",
                             spec=self.spec.clone())
