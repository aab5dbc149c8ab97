"""Physical fabric graph: hosts, NUMA domains, PCIe trees, NICs, GPUs, TPUs.

A :class:`Fabric` is a typed multigraph (networkx) whose nodes are
hardware components and whose edges are physical links with bandwidth and
latency. Every component carries the same typed attributes that the KND
drivers publish into ResourceSlices, so discovery (`core.drivers`) is a
projection of this graph — exactly the DraNet pattern of a node daemon
walking sysfs and publishing what it finds.

Bandwidths are GB/s (bytes, not bits); latencies are seconds.

The port's own copy of the JAX package's ``topology/fabric.py`` (that module
imports no JAX, but the port imports nothing of that package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import networkx as nx

__all__ = ["Component", "Link", "Fabric", "PathInfo"]


@dataclass
class Component:
    """A node in the fabric graph."""

    id: str
    kind: str  # 'host' | 'numa' | 'pci_root' | 'pci_switch' | 'gpu' | 'nic' | 'tpu' | 'tor' | 'spine' | 'dcn'
    attrs: Dict[str, Any] = field(default_factory=dict)

    def __hash__(self) -> int:
        return hash(self.id)


@dataclass(frozen=True)
class Link:
    kind: str  # 'pcie' | 'nvlink' | 'upi' | 'eth' | 'ici' | 'dcn'
    bandwidth: float  # GB/s per direction
    latency: float = 0.0  # seconds per traversal


@dataclass
class PathInfo:
    hops: List[str]
    bottleneck_bw: float
    latency: float
    kinds: List[str]


class Fabric:
    def __init__(self, name: str = "fabric"):
        self.name = name
        self.g = nx.Graph()
        self._components: Dict[str, Component] = {}

    # -- construction -------------------------------------------------------
    def add(self, comp: Component) -> Component:
        if comp.id in self._components:
            raise ValueError(f"duplicate component {comp.id}")
        self._components[comp.id] = comp
        self.g.add_node(comp.id, kind=comp.kind)
        return comp

    def component(self, cid: str) -> Component:
        return self._components[cid]

    def link(self, a: str, b: str, link: Link) -> None:
        for end in (a, b):
            if end not in self._components:
                raise ValueError(f"unknown component {end}")
        self.g.add_edge(a, b, kind=link.kind, bandwidth=link.bandwidth,
                        latency=link.latency)

    # -- queries --------------------------------------------------------------
    def components(self, kind: Optional[str] = None) -> List[Component]:
        out = [c for c in self._components.values() if kind is None or c.kind == kind]
        return sorted(out, key=lambda c: c.id)

    def path(self, src: str, dst: str,
             weight: str = "hops") -> PathInfo:
        """Shortest path; ``weight='hops'`` minimizes traversals,
        ``weight='latency'`` minimizes summed latency."""
        if weight == "hops":
            nodes = nx.shortest_path(self.g, src, dst)
        else:
            nodes = nx.shortest_path(self.g, src, dst, weight="latency")
        bw = float("inf")
        lat = 0.0
        kinds: List[str] = []
        for a, b in zip(nodes, nodes[1:]):
            e = self.g.edges[a, b]
            bw = min(bw, e["bandwidth"])
            lat += e["latency"]
            kinds.append(e["kind"])
        return PathInfo(hops=nodes, bottleneck_bw=bw, latency=lat, kinds=kinds)

    def hop_distance(self, src: str, dst: str,
                     allowed_kinds: Optional[Sequence[str]] = None) -> int:
        """Number of link traversals between two components, optionally
        restricted to a link-kind subgraph (e.g. ICI-only torus distance)."""
        if allowed_kinds is None:
            return nx.shortest_path_length(self.g, src, dst)
        sub = self.g.edge_subgraph(
            (a, b) for a, b, d in self.g.edges(data=True) if d["kind"] in allowed_kinds
        )
        return nx.shortest_path_length(sub, src, dst)

    def neighbors(self, cid: str, link_kind: Optional[str] = None) -> List[str]:
        out = []
        for nbr in self.g.neighbors(cid):
            if link_kind is None or self.g.edges[cid, nbr]["kind"] == link_kind:
                out.append(nbr)
        return sorted(out)

    def __repr__(self) -> str:
        return (f"Fabric({self.name}: {self.g.number_of_nodes()} components, "
                f"{self.g.number_of_edges()} links)")
