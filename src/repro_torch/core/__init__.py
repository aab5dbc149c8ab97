"""The KND model, the port's own copy of the JAX package's ``core``.

Layers:
  attributes/cel      — typed attributes + CEL-subset selector language
  resources/claims    — DRA objects: ResourceSlice, ResourceClaim, DeviceClass
  allocator           — structured (aligned) vs legacy device-plugin (lottery)
  planner             — claims -> chips -> topology-aligned mesh plans
  nri/drivers         — composable lifecycle drivers on an event bus
  oci                 — declarative attachment executed by the runtime,
                        which builds a torch ``DeviceMesh``
  lifecycle           — startup pipeline models (Table I)
"""

from .attributes import AttributeSet, Quantity, Version
from .cel import CelError, CelProgram, compile_expr, evaluate
from .claims import (AllocationResult, ClaimSpec, DeviceClass, DeviceConfig,
                     DeviceRequest, MatchAttribute, NetworkDeviceData,
                     ResourceClaim, ResourceClaimTemplate)
from .allocator import AllocationError, LegacyAllocator, StructuredAllocator
from .drivers import (DriverRegistry, GpuDriver, IciDriver, KNDDriver,
                      NicDriver, TpuDriver)
from .nri import Event, EventBus, Events, HookResult
from .oci import AttachmentSpec, DeviceBinding, MeshRuntime
from .planner import AxisSpec, MeshPlan, MeshPlanner, folded_order
from .resources import Device, DeviceRef, ResourcePool, ResourceSlice

__all__ = [
    "AttributeSet", "Quantity", "Version",
    "CelError", "CelProgram", "compile_expr", "evaluate",
    "AllocationResult", "ClaimSpec", "DeviceClass", "DeviceConfig",
    "DeviceRequest", "MatchAttribute", "NetworkDeviceData", "ResourceClaim",
    "ResourceClaimTemplate",
    "AllocationError", "LegacyAllocator", "StructuredAllocator",
    "DriverRegistry", "GpuDriver", "IciDriver", "KNDDriver", "NicDriver",
    "TpuDriver",
    "Event", "EventBus", "Events", "HookResult",
    "AttachmentSpec", "DeviceBinding", "MeshRuntime",
    "AxisSpec", "MeshPlan", "MeshPlanner", "folded_order",
    "Device", "DeviceRef", "ResourcePool", "ResourceSlice",
]
