"""MeshPlanner: ResourceClaims -> physical chips -> aligned device meshes.

This is the scheduler role in the DraNet workflow (step 2, "Claiming &
Scheduling"), adapted to TPU pods: a claim for N chips is solved against
the inventory, and the planner decides *which logical mesh coordinate
each physical chip serves* — the exact decision whose quality the paper
measures (aligned vs unaligned).

Placement policies:

* ``aligned`` (KND/DRA): logical axes are embedded in the ICI torus so
  every ring step is 1 physical hop. A torus dimension that hosts a full
  axis uses the wraparound ring; a dimension that hosts several axes (or
  a partial segment) uses a folded (boustrophedon) order, max 2 hops.
* ``unaligned`` (legacy device-plugin): chips are assigned to coordinates
  by a seeded random permutation — attribute-blind, exactly the paper's
  "lottery" arm. Mean ring dilation on a 16x16 torus is ~8x.

The plan carries per-axis hop dilation, which the roofline's collective
term and netsim consume. The plan's :class:`AttachmentSpec` is executed
by the OCI-style :class:`MeshRuntime` — the planner itself never touches
the process group.

The port's own copy of the JAX package's ``core/planner.py``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..topology.tpu import TpuCluster, ring_dilation
from .claims import ClaimSpec, DeviceRequest, ResourceClaim
from .oci import AttachmentSpec, DeviceBinding

__all__ = ["AxisSpec", "MeshPlan", "MeshPlanner", "folded_order"]


def folded_order(n: int) -> List[int]:
    """Boustrophedon embedding of a ring of n into a path of n nodes.

    Visits even indices ascending then odd indices descending:
    0 2 4 ... 5 3 1. Consecutive ring neighbors (incl. wrap) are <= 2
    apart in path position, so a ring mapped onto a torus *segment*
    (no wraparound available) keeps max dilation 2 instead of n-1.
    """
    return list(range(0, n, 2)) + list(reversed(range(1, n, 2)))


@dataclass(frozen=True)
class AxisSpec:
    """One logical mesh axis and the physical dimension hosting it.

    ``physical``: 'x' | 'y' (torus dims) | 'pod' (DCN). Multiple axes may
    share a physical dim (outer axes stride by the product of inner axis
    sizes — their dilation is reported accordingly).
    """

    name: str
    size: int
    physical: str


@dataclass
class MeshPlan:
    axis_names: Tuple[str, ...]
    axis_shape: Tuple[int, ...]
    # chip ids, shape == axis_shape (row-major over logical coords)
    chip_grid: np.ndarray
    placement: str                      # 'aligned' | 'unaligned'
    # per-axis (mean, max) physical hop distance between ring neighbors;
    # pod-spanning axes report dilation 1 on the DCN link class instead.
    dilation: Dict[str, Tuple[float, int]]
    link_class: Dict[str, str]          # axis -> 'ici' | 'dcn'
    claim: Optional[ResourceClaim] = None
    metadata: Dict[str, object] = field(default_factory=dict)

    def attachment(self) -> AttachmentSpec:
        bindings = []
        for coord in np.ndindex(*self.axis_shape):
            bindings.append(DeviceBinding(str(self.chip_grid[coord]), tuple(coord)))
        spec = AttachmentSpec(self.axis_names, self.axis_shape, bindings,
                              metadata={"placement": self.placement,
                                        "dilation": dict(self.dilation)})
        spec.validate()
        return spec

    def summary(self) -> str:
        parts = [f"{n}={s}({self.link_class[n]}, d̄={self.dilation[n][0]:.2f})"
                 for n, s in zip(self.axis_names, self.axis_shape)]
        return f"MeshPlan[{self.placement}] " + " × ".join(parts)


class MeshPlanner:
    """Plans mesh placements over a TpuCluster inventory."""

    def __init__(self, cluster: TpuCluster):
        self.cluster = cluster

    # -- claims -------------------------------------------------------------
    def make_claim(self, name: str, num_chips: int,
                   generation: str = "v5e") -> ResourceClaim:
        """A cluster-scoped DRA claim for ``num_chips`` TPU chips."""
        spec = ClaimSpec(
            requests=[DeviceRequest(
                name="chips",
                device_class="tpu.google.com",
                selectors=[f'device.attributes["generation"] == "{generation}"'],
                count=num_chips)],
            topology_scope="cluster")
        return ResourceClaim(name=name, spec=spec)

    # -- planning -----------------------------------------------------------
    def plan(self, axes: Sequence[AxisSpec], placement: str = "aligned",
             claim: Optional[ResourceClaim] = None, seed: int = 0) -> MeshPlan:
        names = tuple(a.name for a in axes)
        shape = tuple(a.size for a in axes)
        n_needed = int(np.prod(shape))

        pod_axes = [a for a in axes if a.physical == "pod"]
        if len(pod_axes) > 1:
            raise ValueError("at most one pod axis")
        n_pods_needed = pod_axes[0].size if pod_axes else 1
        if n_pods_needed > len(self.cluster.pods):
            raise ValueError(f"plan needs {n_pods_needed} pods, cluster has "
                             f"{len(self.cluster.pods)}")
        per_pod = n_needed // n_pods_needed
        pod_spec = self.cluster.pods[0]
        if per_pod > pod_spec.num_chips:
            raise ValueError(f"{per_pod} chips/pod > {pod_spec.num_chips}")

        # physical dim -> the logical axes it hosts, outer-to-inner
        by_phys: Dict[str, List[AxisSpec]] = {"x": [], "y": []}
        for a in axes:
            if a.physical in ("x", "y"):
                by_phys[a.physical].append(a)
        for phys, hosted in by_phys.items():
            extent = getattr(pod_spec, phys)
            hosted_prod = int(np.prod([a.size for a in hosted])) if hosted else 1
            if hosted_prod > extent:
                raise ValueError(
                    f"axes {[a.name for a in hosted]} need {hosted_prod} "
                    f"> torus {phys} extent {extent}")

        grid = np.empty(shape, dtype=object)
        if placement == "aligned":
            self._fill_aligned(grid, axes, by_phys)
        elif placement == "unaligned":
            self._fill_unaligned(grid, axes, seed)
        else:
            raise ValueError(f"unknown placement {placement!r}")

        dilation, link_class = self._measure(grid, axes)
        return MeshPlan(names, shape, grid, placement, dilation, link_class,
                        claim=claim)

    # -- aligned embedding ----------------------------------------------------
    def _phys_coord(self, axes: Sequence[AxisSpec], by_phys: Dict[str, List[AxisSpec]],
                    coord: Tuple[int, ...], pod_spec) -> Tuple[int, int, int]:
        """Map a logical coordinate to (pod, x, y) with torus-aware orders."""
        idx = {a.name: coord[i] for i, a in enumerate(axes)}
        pod = 0
        for a in axes:
            if a.physical == "pod":
                pod = idx[a.name]
        out = {}
        for phys in ("x", "y"):
            hosted = by_phys[phys]
            extent = getattr(pod_spec, phys)
            if not hosted:
                out[phys] = 0
                continue
            # mixed-radix position along this physical dim, outer->inner
            pos = 0
            for a in hosted:
                pos = pos * a.size + idx[a.name]
            total = int(np.prod([a.size for a in hosted]))
            if total == extent:
                # full dimension: wraparound ring is available; identity
                # order is exactly 1-hop (uses the wrap link for the seam)
                out[phys] = pos
            else:
                # partial segment: no wrap seam -> folded order, max 2 hops
                out[phys] = folded_order(total)[pos] if len(hosted) == 1 else pos
        return pod, out["x"], out["y"]

    def _fill_aligned(self, grid: np.ndarray, axes: Sequence[AxisSpec],
                      by_phys: Dict[str, List[AxisSpec]]) -> None:
        pod_spec = self.cluster.pods[0]
        for coord in np.ndindex(*grid.shape):
            pod, x, y = self._phys_coord(axes, by_phys, coord, pod_spec)
            grid[coord] = self.cluster.chip_at(pod, x, y)

    def _fill_unaligned(self, grid: np.ndarray, axes: Sequence[AxisSpec],
                        seed: int) -> None:
        """Legacy placement: right count of chips, attribute-blind order.

        Pods are still respected (a pod axis is physically meaningful even
        to the legacy path — jobs land on whatever pod had quota), but
        *within* a pod the assignment is a random permutation.
        """
        rng = random.Random(seed)
        pod_axis_idx = None
        for i, a in enumerate(axes):
            if a.physical == "pod":
                pod_axis_idx = i
        shape = grid.shape
        per_pod_coords: Dict[int, List[Tuple[int, ...]]] = {}
        for coord in np.ndindex(*shape):
            pod = coord[pod_axis_idx] if pod_axis_idx is not None else 0
            per_pod_coords.setdefault(pod, []).append(coord)
        for pod, coords in per_pod_coords.items():
            chips = self.cluster.all_chips(pod)
            picked = rng.sample(chips, len(coords))
            for coord, chip in zip(coords, picked):
                grid[coord] = chip

    # -- dilation measurement --------------------------------------------------
    def _measure(self, grid: np.ndarray, axes: Sequence[AxisSpec]):
        dilation: Dict[str, Tuple[float, int]] = {}
        link_class: Dict[str, str] = {}
        for i, a in enumerate(axes):
            if a.physical == "pod":
                dilation[a.name] = (1.0, 1)
                link_class[a.name] = "dcn"
                continue
            link_class[a.name] = "ici"
            # measure hop distance along every ring of this axis; average
            means, maxes = [], []
            other_dims = [d for d in range(grid.ndim) if d != i]
            base_shape = [grid.shape[d] for d in other_dims]
            for other in np.ndindex(*base_shape):
                ring = []
                for k in range(grid.shape[i]):
                    coord = list(other)
                    coord.insert(i, k)
                    ring.append(grid[tuple(coord)])
                m, mx = ring_dilation(self.cluster, ring)
                means.append(m)
                maxes.append(mx)
            dilation[a.name] = (float(np.mean(means)), int(np.max(maxes)))
        return dilation, link_class
