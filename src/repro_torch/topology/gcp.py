"""Model of the paper's testbed: 2x GCP a4-highgpu-8g nodes.

Each a4-highgpu-8g node: 8x NVIDIA B200 GPUs + 8x Mellanox CX-7 RoCE NICs
(400 Gb/s each). GPUs and NICs hang pairwise off 8 PCIe Gen5 switches,
4 per CPU socket; the two sockets are joined by UPI. All 8 GPUs are also
joined by an NVSwitch NVLink domain (which the paper deliberately AVOIDS
by running -g 1 per process — inter-node RDMA is what is measured).

The three DMA-path tiers that create the paper's "placement lottery"
(§V.C) fall out of the graph's bottleneck bandwidths:

  tier 0 — GPU and NIC on the SAME PCIe switch  : min(64, 64)        -> NIC-bound (50 GB/s line)
  tier 1 — same socket, different PCIe switch   : crosses root ports -> ~38 GB/s plateau
  tier 2 — different socket                     : crosses UPI        -> ~26 GB/s plateau

Tier plateaus are calibrated against Table II/III 8 GB rows (see
EXPERIMENTS.md §Calibration); the graph structure (which pairs are in
which tier) is ground truth from the machine layout.

The port's own copy of the JAX package's ``topology/gcp.py`` (that module
imports no JAX, but the port imports nothing of that package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from .fabric import Component, Fabric, Link

__all__ = ["A4Node", "build_a4_cluster", "PCIE_SW_BW", "ROOT_BW", "UPI_BW",
           "NIC_BW", "NVLINK_BW", "NET_BW"]

# GB/s per direction (calibrated; see module docstring)
PCIE_SW_BW = 64.0     # PCIe Gen5 x16 device <-> switch
ROOT_BW = 38.0        # P2P through root complex (switch <-> socket root)
UPI_BW = 26.0         # socket interconnect
NIC_BW = 50.0         # 400 Gb/s CX-7 line rate
NET_BW = 50.0         # NIC <-> TOR RoCE fabric
NVLINK_BW = 900.0     # NVSwitch domain (unused by the paper's -g 1 runs)

# per-traversal latencies (seconds)
PCIE_LAT = 0.5e-6
ROOT_LAT = 0.75e-6
UPI_LAT = 1.0e-6
NET_LAT = 2.0e-6


@dataclass
class A4Node:
    name: str
    gpus: List[str]
    nics: List[str]
    sockets: List[str]
    switches: List[str]


def _build_a4_node(fab: Fabric, name: str) -> A4Node:
    host = fab.add(Component(f"{name}", "host", {"machine": "a4-highgpu-8g"}))
    sockets, switches, gpus, nics = [], [], [], []
    nvsw = fab.add(Component(f"{name}/nvswitch", "pci_switch", {"fabric": "nvlink"}))
    for s in range(2):
        sock = fab.add(Component(f"{name}/numa{s}", "numa", {"socket": s}))
        fab.link(host.id, sock.id, Link("pcie", 1e3, 0.0))  # structural edge
        sockets.append(sock.id)
        for w in range(4):
            idx = s * 4 + w
            sw = fab.add(Component(f"{name}/pcisw{idx}", "pci_switch",
                                   {"socket": s, "pciRoot": f"pci0000:{80 + idx:x}"}))
            fab.link(sw.id, sock.id, Link("pcie_root", ROOT_BW, ROOT_LAT))
            switches.append(sw.id)
            gpu = fab.add(Component(
                f"{name}/gpu{idx}", "gpu",
                {"index": idx, "socket": s, "pciRoot": f"pci0000:{80 + idx:x}",
                 "model": "B200", "node": name}))
            nic = fab.add(Component(
                f"{name}/nic{idx}", "nic",
                {"index": idx, "socket": s, "pciRoot": f"pci0000:{80 + idx:x}",
                 "rdma": True, "linkGbps": 400, "model": "CX-7", "node": name,
                 "interface": f"gpu{idx}rdma{idx}"}))
            fab.link(gpu.id, sw.id, Link("pcie", PCIE_SW_BW, PCIE_LAT))
            fab.link(nic.id, sw.id, Link("pcie", PCIE_SW_BW, PCIE_LAT))
            fab.link(gpu.id, nvsw.id, Link("nvlink", NVLINK_BW, PCIE_LAT))
            gpus.append(gpu.id)
            nics.append(nic.id)
    fab.link(sockets[0], sockets[1], Link("upi", UPI_BW, UPI_LAT))
    return A4Node(name, gpus, nics, sockets, switches)


def build_a4_cluster(n_nodes: int = 2) -> Tuple[Fabric, List[A4Node]]:
    """The paper's testbed: ``n_nodes`` a4 nodes behind one RoCE TOR."""
    fab = Fabric("a4-cluster")
    tor = fab.add(Component("tor0", "tor", {}))
    nodes = []
    for i in range(n_nodes):
        node = _build_a4_node(fab, f"a4-{i}")
        for nic in node.nics:
            fab.link(nic, tor.id, Link("eth", NET_BW, NET_LAT))
        nodes.append(node)
    return fab, nodes


def dma_path_bw(fab: Fabric, gpu: str, nic: str) -> Tuple[float, float, int]:
    """Bottleneck bandwidth, latency and tier of the GPU->NIC DMA path.

    tier 0: same PCIe switch; tier 1: same socket; tier 2: cross-socket.
    The NVLink fabric is excluded: GPUDirect RDMA DMA goes over PCIe.
    """
    sub = fab.g.edge_subgraph(
        (a, b) for a, b, d in fab.g.edges(data=True)
        if d["kind"] in ("pcie", "pcie_root", "upi"))
    import networkx as nx
    nodes = nx.shortest_path(sub, gpu, nic)
    bw = float("inf")
    lat = 0.0
    kinds = []
    for a, b in zip(nodes, nodes[1:]):
        e = fab.g.edges[a, b]
        bw = min(bw, e["bandwidth"])
        lat += e["latency"]
        kinds.append(e["kind"])
    if "upi" in kinds:
        tier = 2
    elif "pcie_root" in kinds:
        tier = 1
    else:
        tier = 0
    return bw, lat, tier
