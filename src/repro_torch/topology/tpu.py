"""TPU v5e pod topology: 2D ICI torus + DCN between pods.

This is the framework's production fabric (the TPU analogue of the
paper's RoCE testbed). A v5e pod is a 16x16 chip torus (256 chips); each
chip has 4 ICI links (+x, -x, +y, -y) at ~50 GB/s each. Chips are grouped
4-per-host; each host has a DCN NIC for inter-pod traffic.

The KND insight maps here as: a *logical mesh axis* whose consecutive
ranks are *physical torus neighbors* runs ring collectives at 1 hop/step
(aligned). A placement that ignores topology (the device-plugin analogue)
scatters logical neighbors across the torus: each ring step then
traverses multiple ICI links that are shared with other ranks' steps,
dilating collective time by the mean hop distance — the same "lottery"
physics as the paper's PCIe tiers, at pod scale.

The port's own copy of the JAX package's ``topology/tpu.py`` (that module
imports no JAX, but the port imports nothing of that package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .fabric import Component, Fabric, Link

__all__ = ["TpuPodSpec", "TpuCluster", "build_tpu_cluster",
           "ICI_BW", "DCN_HOST_BW", "PEAK_BF16_TFLOPS", "HBM_BW", "HBM_BYTES"]

# v5e hardware constants (targets for the roofline; see task spec)
PEAK_BF16_TFLOPS = 197.0         # TFLOP/s per chip, bf16
HBM_BW = 819.0                   # GB/s per chip
HBM_BYTES = 16 * 2**30           # 16 GiB per chip
ICI_BW = 50.0                    # GB/s per ICI link (aggregate per direction)
ICI_LAT = 1.0e-6
DCN_HOST_BW = 25.0               # GB/s per host DCN NIC (assumption, DESIGN §2)
DCN_LAT = 10.0e-6
CHIPS_PER_HOST = 4


@dataclass
class TpuPodSpec:
    x: int = 16
    y: int = 16
    wrap_x: bool = True
    wrap_y: bool = True

    @property
    def num_chips(self) -> int:
        return self.x * self.y


@dataclass
class TpuCluster:
    fabric: Fabric
    pods: List[TpuPodSpec]
    # chip component ids indexed [pod][x][y]
    chips: List[List[List[str]]]
    hosts: List[List[str]] = field(default_factory=list)

    def chip_at(self, pod: int, x: int, y: int) -> str:
        return self.chips[pod][x][y]

    def chip_coords(self, chip_id: str) -> Tuple[int, int, int]:
        a = self.fabric.component(chip_id).attrs
        return a["pod"], a["x"], a["y"]

    def torus_distance(self, a: str, b: str) -> int:
        """ICI hop distance (same pod) — manhattan on the torus."""
        pa, xa, ya = self.chip_coords(a)
        pb, xb, yb = self.chip_coords(b)
        if pa != pb:
            raise ValueError("torus_distance is intra-pod; use fabric.path for DCN")
        spec = self.pods[pa]
        dx = abs(xa - xb)
        if spec.wrap_x:
            dx = min(dx, spec.x - dx)
        dy = abs(ya - yb)
        if spec.wrap_y:
            dy = min(dy, spec.y - dy)
        return dx + dy

    def all_chips(self, pod: Optional[int] = None) -> List[str]:
        pods = range(len(self.pods)) if pod is None else [pod]
        out = []
        for p in pods:
            for x in range(self.pods[p].x):
                for y in range(self.pods[p].y):
                    out.append(self.chips[p][x][y])
        return out


def build_tpu_cluster(num_pods: int = 1, spec: Optional[TpuPodSpec] = None) -> TpuCluster:
    spec = spec or TpuPodSpec()
    fab = Fabric("tpu-v5e")
    dcn = fab.add(Component("dcn0", "dcn", {}))
    chips: List[List[List[str]]] = []
    hosts: List[List[str]] = []
    for p in range(num_pods):
        grid: List[List[str]] = [[None] * spec.y for _ in range(spec.x)]  # type: ignore[list-item]
        pod_hosts: List[str] = []
        # hosts: 4 chips per host, laid out as 2x2 tiles of the torus
        host_of: Dict[Tuple[int, int], str] = {}
        for hx in range(0, spec.x, 2):
            for hy in range(0, spec.y, 2):
                hid = f"pod{p}/host{hx // 2}_{hy // 2}"
                fab.add(Component(hid, "host", {"pod": p}))
                nic = fab.add(Component(f"{hid}/dcn-nic", "nic",
                                        {"pod": p, "host": hid, "dcn": True}))
                fab.link(nic.id, hid, Link("pcie", 64.0, 0.5e-6))
                fab.link(nic.id, dcn.id, Link("dcn", DCN_HOST_BW, DCN_LAT))
                pod_hosts.append(hid)
                for dx in range(2):
                    for dy in range(2):
                        host_of[(hx + dx, hy + dy)] = hid
        for x in range(spec.x):
            for y in range(spec.y):
                hid = host_of[(x, y)]
                chip = fab.add(Component(
                    f"pod{p}/chip{x}_{y}", "tpu",
                    {"pod": p, "x": x, "y": y, "host": hid,
                     "generation": "v5e",
                     "hbmBytes": HBM_BYTES,
                     "peakTflopsBf16": PEAK_BF16_TFLOPS}))
                fab.link(chip.id, hid, Link("pcie", 32.0, 0.5e-6))
                grid[x][y] = chip.id
        # ICI torus links
        for x in range(spec.x):
            for y in range(spec.y):
                if x + 1 < spec.x:
                    fab.link(grid[x][y], grid[x + 1][y], Link("ici", ICI_BW, ICI_LAT))
                if y + 1 < spec.y:
                    fab.link(grid[x][y], grid[x][y + 1], Link("ici", ICI_BW, ICI_LAT))
            if spec.wrap_y and spec.y > 2:
                fab.link(grid[x][0], grid[x][spec.y - 1], Link("ici", ICI_BW, ICI_LAT))
        if spec.wrap_x and spec.x > 2:
            for y in range(spec.y):
                fab.link(grid[0][y], grid[spec.x - 1][y], Link("ici", ICI_BW, ICI_LAT))
        chips.append(grid)
        hosts.append(pod_hosts)
    return TpuCluster(fabric=fab, pods=[spec] * num_pods, chips=chips, hosts=hosts)


def ring_dilation(cluster: TpuCluster, ring: Sequence[str]) -> Tuple[float, int]:
    """(mean, max) physical ICI hop distance between consecutive logical
    ranks of a ring (wrapping). Aligned rings achieve exactly 1.0."""
    n = len(ring)
    if n < 2:
        return 0.0, 0
    dists = [cluster.torus_distance(ring[i], ring[(i + 1) % n]) for i in range(n)]
    return sum(dists) / n, max(dists)
