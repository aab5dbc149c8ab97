"""OCI-style declarative attachment (paper §III.C).

"recent additions to the OCI runtime specification allow for the
declarative attachment of network interfaces. This allows network drivers
to simply instruct the container runtime to move a prepared interface
into the pod's namespace, offloading the privileged, low-level netlink
operations to the runtime itself."

Adapted: drivers never touch the process group (the privileged state in
this world). They emit an :class:`AttachmentSpec`; the single trusted
:class:`MeshRuntime` executes it — building the
``torch.distributed.device_mesh.DeviceMesh`` and binding device
coordinates to ranks. This keeps every driver unprivileged and
composable, exactly the paper's intent.

The port of the JAX package's ``core/oci.py``: the spec types are the
same, and where JAX hands the i-th binding (by mesh coordinate) the i-th
JAX device, the port hands it global rank i.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["DeviceBinding", "AttachmentSpec", "MeshRuntime"]


@dataclass(frozen=True)
class DeviceBinding:
    """One declarative binding: physical device -> logical mesh coordinate."""

    device_id: str               # fabric/resource device id (e.g. pod0/chip3_7)
    mesh_coord: Tuple[int, ...]  # logical coordinate in the mesh
    attrs: Dict[str, Any] = field(default_factory=dict)


@dataclass
class AttachmentSpec:
    """The declarative request a driver hands to the runtime.

    Mirrors OCI runtime-spec PR #1271's netdev list: a *description* of
    the desired end state, not a procedure.
    """

    axis_names: Tuple[str, ...]
    axis_shape: Tuple[int, ...]
    bindings: List[DeviceBinding] = field(default_factory=list)
    metadata: Dict[str, Any] = field(default_factory=dict)

    def validate(self) -> None:
        want = math.prod(self.axis_shape)
        if len(self.bindings) != want:
            raise ValueError(
                f"attachment has {len(self.bindings)} bindings for a "
                f"{self.axis_shape} mesh ({want} coords)")
        coords = {b.mesh_coord for b in self.bindings}
        if len(coords) != want:
            raise ValueError("duplicate/missing mesh coordinates in bindings")
        for b in self.bindings:
            if len(b.mesh_coord) != len(self.axis_shape):
                raise ValueError(f"coord rank mismatch: {b.mesh_coord}")
            for c, s in zip(b.mesh_coord, self.axis_shape):
                if not (0 <= c < s):
                    raise ValueError(f"coord {b.mesh_coord} outside {self.axis_shape}")


class MeshRuntime:
    """The privileged runtime executing attachments (OCI analogue).

    Only this class builds device meshes. Drivers and planners stay
    declarative. ``device_type`` is the device type of every mesh it
    builds, so the control plane's AttachmentController calls
    ``execute(spec)`` alone.
    """

    def __init__(self, device_type: str = "cuda") -> None:
        self.device_type = device_type
        self._executed: List[AttachmentSpec] = []

    @staticmethod
    def rank_grid(spec: AttachmentSpec) -> np.ndarray:
        """The global rank at each mesh coordinate: bindings sorted by
        mesh coordinate get ranks 0, 1, ... in order, as the JAX
        runtime hands them its devices."""
        spec.validate()
        grid = np.empty(spec.axis_shape, dtype=np.int64)
        for rank, b in enumerate(sorted(spec.bindings, key=lambda b: b.mesh_coord)):
            grid[b.mesh_coord] = rank
        return grid

    def execute(self, spec: AttachmentSpec):
        """Build a ``DeviceMesh`` realizing the attachment over the
        initialised default process group, one rank per binding, on this
        runtime's device type.

        Raises when no process group is initialised or its world size
        is not the number of bindings: a mesh never silently shrinks to
        the ranks at hand.
        """
        import torch
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        grid = self.rank_grid(spec)
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError(
                f"MeshRuntime.execute: no process group is initialised; the "
                f"{spec.axis_shape} mesh needs one of world size {grid.size}")
        world = dist.get_world_size()
        if world != grid.size:
            raise RuntimeError(
                f"MeshRuntime.execute: the {spec.axis_shape} mesh binds "
                f"{grid.size} devices, the process group has {world} ranks")
        mesh = DeviceMesh(self.device_type,
                          torch.from_numpy(grid),
                          mesh_dim_names=tuple(spec.axis_names))
        self._executed.append(spec)
        return mesh

    @property
    def executed(self) -> Sequence[AttachmentSpec]:
        return tuple(self._executed)
