"""SchedulerController: filter/score placement of claims onto nodes.

The kube-scheduler shape (filter plugins prune, score plugins rank),
applied to DRA claims *before* allocation — the decision the paper
measures the quality of. Placement happens at node granularity:

* node-scoped claims get one node (``CapacityFit`` filters, per-node
  score plugins rank);
* cluster-scoped claims (multi-host mesh claims) get a node *set*,
  grown as a torus neighborhood and scored by the predicted all-reduce
  time of a ring over the set's chips
  (:func:`predicted_collective_seconds`, built on
  :mod:`repro_torch.topology.netsim`'s collective model — the same physics
  the paper's NcclModel captures for the RoCE testbed, here over ICI).

The controller is a no-op while the store holds no ``Node`` objects, so
planes without a node plane behave exactly as before. Decisions land in
the claim's status (``outputs["scheduled_nodes"]`` + a ``Scheduled``
condition); the AllocationController then allocates within the chosen
nodes only. Everything iterates in sorted order with name tie-breaks:
the same store state always produces the same placement.

The port's own copy of the JAX package's ``node/scheduler.py`` (pure
Python; the port imports nothing of that package).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import (TYPE_CHECKING, Dict, List, Optional, Sequence, Set,
                    Tuple)

from ..api.controllers import Controller
from ..api.objects import (ApiObject, CONDITION_ALLOCATED,
                           CONDITION_READY, CONDITION_SCHEDULED, Node)
from ..core.claims import ResourceClaim
from ..core.resources import Device
from ..topology.netsim import ring_collective_time
from ..topology.tpu import ICI_BW

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..api.controllers import ControlPlane

__all__ = [
    "NodeInfo", "SchedulerContext", "SchedulerPlugin",
    "CapacityFitPlugin", "FabricDistancePlugin", "TorusNeighborhoodPlugin",
    "SchedulerController", "predicted_collective_seconds",
]

# Payload the set scorer prices a placement at: one bf16 gradient bucket
# of a ~1B-parameter data-parallel shard — big enough that the beta term
# (where dilation bites) dominates alpha.
SCORE_PAYLOAD_BYTES = 64 << 20


# ---------------------------------------------------------------------------
# Node + claim views the plugins consume
# ---------------------------------------------------------------------------

@dataclass
class NodeInfo:
    """One schedulable node's capacity/topology snapshot."""

    name: str
    obj: ApiObject                       # the Node API object
    # request name -> free devices on this node matching that request's
    # FULL filter (class selectors AND request selectors — the same
    # predicate the allocator uses, via the same pool index); claims
    # being re-scheduled see their own surviving devices as free too
    free: Dict[str, List[Device]] = field(default_factory=dict)
    coord: Optional[Tuple[float, float, float]] = None  # (pod, mean x, mean y)
    pod: int = 0

    def free_count(self, request: str) -> int:
        return len(self.free.get(request, ()))


@dataclass
class SchedulerContext:
    """Everything a plugin may consult for one claim's placement."""

    plane: "ControlPlane"
    obj: Optional[ApiObject]             # the claim being placed
    claim: ResourceClaim
    needs: Dict[str, int]                # request name -> count requested
    workload: str = ""                   # owning workload label, if any
    # nodes already hosting sibling claims of the same workload (the
    # replica-affinity signal FabricDistance packs toward)
    peers: Set[str] = field(default_factory=set)

    @property
    def dominant(self) -> str:
        """The request needing the most devices (set-growth driver)."""
        return max(sorted(self.needs), key=lambda r: self.needs[r])


class SchedulerPlugin:
    """Base plugin: ``filter`` prunes nodes, ``score`` ranks survivors.

    ``score_set`` (cluster-scoped claims) prices a whole candidate node
    set; higher is better for every score. Plugins must be pure
    functions of (ctx, info) — the controller's determinism guarantee
    rests on it.
    """

    name = "plugin"

    def filter(self, ctx: SchedulerContext, info: NodeInfo) -> bool:
        return True

    def score(self, ctx: SchedulerContext, info: NodeInfo) -> float:
        return 0.0

    def score_set(self, ctx: SchedulerContext,
                  infos: Sequence[NodeInfo]) -> float:
        return 0.0


class CapacityFitPlugin(SchedulerPlugin):
    """Filter: the node must contribute toward every requested class.

    For node-scoped claims the node must satisfy the whole claim; for
    cluster-scoped claims it must offer at least one free device of the
    dominant class (useless nodes never enter the set growth). Score:
    fewer leftovers == tighter packing (kube's MostAllocated analogue),
    scaled small so topology scores dominate.
    """

    name = "capacity-fit"

    def filter(self, ctx: SchedulerContext, info: NodeInfo) -> bool:
        if ctx.claim.spec.topology_scope == "node":
            return all(info.free_count(r) >= n for r, n in ctx.needs.items())
        return any(info.free_count(r) > 0 for r in ctx.needs)

    def score(self, ctx: SchedulerContext, info: NodeInfo) -> float:
        leftover = sum(info.free_count(r) - n for r, n in ctx.needs.items())
        return -0.01 * max(leftover, 0)


class FabricDistancePlugin(SchedulerPlugin):
    """Score: pack near sibling replicas of the same workload.

    Serve replica sets (template-stamped claims) land close together on
    the torus so cross-replica traffic stays few-hop; without peers the
    plugin is neutral. Distance is the torus-aware host-tile distance.
    """

    name = "fabric-distance"

    def score(self, ctx: SchedulerContext, info: NodeInfo) -> float:
        if not ctx.peers or info.coord is None:
            return 0.0
        topo = _Topo(ctx.plane)
        dists = []
        for peer in sorted(ctx.peers):
            d = topo.node_distance(info, peer)
            if d is not None:
                dists.append(d)
        if not dists:
            return 0.0
        return -min(dists)


class TorusNeighborhoodPlugin(SchedulerPlugin):
    """Grow + score node sets as contiguous torus neighborhoods.

    The cluster-scope placer: starting from seed nodes (most capacity
    first, peers preferred), repeatedly add the node closest to the
    growing set until the dominant class fits, then score the set by
    the *negative predicted all-reduce time* of a ring over its chips.
    Aligned neighborhoods ride 1–2-hop ICI rings; scattered sets pay
    the dilation the paper's unaligned arm pays.
    """

    name = "torus-neighborhood"
    seeds = 4

    def grow(self, ctx: SchedulerContext,
             infos: Sequence[NodeInfo]) -> Optional[List[NodeInfo]]:
        """Best feasible node set, or None when capacity cannot fit."""
        dom = ctx.dominant
        for r, n in ctx.needs.items():
            if sum(i.free_count(r) for i in infos) < n:
                return None
        topo = _Topo(ctx.plane)

        def covered(chosen: List[NodeInfo]) -> bool:
            return all(sum(i.free_count(r) for i in chosen) >= n
                       for r, n in ctx.needs.items())

        # seed order: near peers first, then most free capacity, then name
        def seed_key(i: NodeInfo):
            peer_d = 0.0
            if ctx.peers:
                ds = [topo.node_distance(i, p) for p in sorted(ctx.peers)]
                ds = [d for d in ds if d is not None]
                peer_d = min(ds) if ds else 0.0
            return (peer_d, -i.free_count(dom), i.name)

        ranked = sorted(infos, key=seed_key)
        best: Optional[Tuple[float, List[NodeInfo]]] = None
        for seed in ranked[:self.seeds]:
            chosen = [seed]
            have = {r: seed.free_count(r) for r in ctx.needs}
            rest = [i for i in ranked if i.name != seed.name]
            # min distance to the chosen set, maintained incrementally:
            # O(rest) per addition instead of a full re-sort with
            # set-distance recomputation (the dominant cost at 64 nodes)
            dmin = {i.name: topo.set_distance(i, [seed]) for i in rest}
            while rest and any(have[r] < n for r, n in ctx.needs.items()):
                nxt = min(rest, key=lambda i: (dmin[i.name], i.name))
                rest.remove(nxt)
                chosen.append(nxt)
                for r in ctx.needs:
                    have[r] += nxt.free_count(r)
                if nxt.coord is not None:
                    for i in rest:
                        if i.coord is not None:
                            d = topo.dist(i.coord, nxt.coord)
                            if d < dmin[i.name]:
                                dmin[i.name] = d
            if not covered(chosen):
                continue
            score = self.score_set(ctx, chosen)
            if best is None or score > best[0]:
                best = (score, chosen)
        return best[1] if best is not None else None

    def score_set(self, ctx: SchedulerContext,
                  infos: Sequence[NodeInfo]) -> float:
        dom = ctx.dominant
        t = predicted_collective_seconds(
            ctx.plane, infos, ctx.needs[dom], request=dom)
        return -t


# ---------------------------------------------------------------------------
# Topology helpers
# ---------------------------------------------------------------------------

class _Topo:
    """Torus-aware distances over NodeInfo coordinates.

    Falls back to unwrapped manhattan (then to neutral 0.0) when the
    plane's cluster is not a torus / nodes carry no chip coordinates, so
    the scheduler stays usable over arbitrary fabrics.
    """

    def __init__(self, plane: "ControlPlane"):
        cluster = getattr(plane, "cluster", None)
        spec = None
        pods = getattr(cluster, "pods", None)
        if pods:
            spec = pods[0]
        self.extent: Optional[Tuple[int, int]] = None
        if spec is not None and getattr(spec, "wrap_x", False):
            self.extent = (spec.x, spec.y)
        # crossing pods means leaving ICI for DCN: strictly worse than
        # any intra-pod distance (max torus distance is extent/2 + extent/2)
        self.pod_hop = (self.extent[0] + self.extent[1]
                        if self.extent is not None else 32.0)
        self._plane = plane
        # node tile coordinates only move when slices do; the cache
        # lives ON the plane (not a module global keyed by id(plane),
        # which a reused address could alias across plane lifetimes)
        gen = plane.registry.pool.inventory_generation
        cached = getattr(plane, "_scheduler_coord_cache", None)
        if cached is None or cached[0] != gen:
            cached = (gen, {})
            plane._scheduler_coord_cache = cached
        self._coords = cached[1]

    def dist(self, a: Tuple[float, float, float],
             b: Tuple[float, float, float]) -> float:
        """(pod, x, y) distance: chips in different pods share (x, y)
        namespaces, so pod membership dominates — a DCN crossing always
        outweighs any intra-pod hop count."""
        if a[0] != b[0]:
            return self.pod_hop
        dx, dy = abs(a[1] - b[1]), abs(a[2] - b[2])
        if self.extent is not None:
            dx = min(dx, self.extent[0] - dx)
            dy = min(dy, self.extent[1] - dy)
        return dx + dy

    def node_coord(self, name: str) -> Optional[Tuple[float, float, float]]:
        if name not in self._coords:
            self._coords[name] = node_coordinates(self._plane, name)
        return self._coords[name]

    def node_distance(self, info: NodeInfo, other: str) -> Optional[float]:
        oc = self.node_coord(other)
        if info.coord is None or oc is None:
            return None
        return self.dist(info.coord, oc)

    def set_distance(self, info: NodeInfo,
                     chosen: Sequence[NodeInfo]) -> float:
        if info.coord is None:
            return 1e9
        ds = [self.dist(info.coord, c.coord) for c in chosen
              if c.coord is not None]
        return min(ds) if ds else 1e9


def node_coordinates(plane: "ControlPlane",
                     node: str) -> Optional[Tuple[float, float, float]]:
    """(pod, mean x, mean y) of the node's chip devices, or None.

    The pod leads: (x, y) attributes are per-pod namespaces — two hosts
    at the same torus position of different pods are a DCN crossing
    apart, not 0 hops.
    """
    xs: List[float] = []
    ys: List[float] = []
    pod = 0.0
    for sl in plane.registry.pool.slices:
        if sl.node != node:
            continue
        for d in sl:
            x, y = d.attributes.get("x"), d.attributes.get("y")
            if isinstance(x, (int, float)) and isinstance(y, (int, float)):
                xs.append(float(x))
                ys.append(float(y))
                p = d.attributes.get("pod")
                if isinstance(p, (int, float)):
                    pod = float(p)
    if not xs:
        return None
    return pod, sum(xs) / len(xs), sum(ys) / len(ys)


def _snake_key(dev: Device) -> Tuple:
    """Boustrophedon order over chip coordinates (grouped per pod):
    contiguous blocks of nodes yield near-1-hop rings; devices without
    coordinates sort by id at the end."""
    x, y = dev.attributes.get("x"), dev.attributes.get("y")
    if not isinstance(x, (int, float)) or not isinstance(y, (int, float)):
        return (1, 0, 0, 0, dev.id)
    p = dev.attributes.get("pod")
    pod = float(p) if isinstance(p, (int, float)) else 0.0
    y = float(y) if int(x) % 2 == 0 else -float(y)
    return (0, pod, float(x), y, dev.id)


def predicted_collective_seconds(plane: "ControlPlane",
                                 infos: Sequence[NodeInfo],
                                 n_chips: int,
                                 request: str = "chips",
                                 size_bytes: float = SCORE_PAYLOAD_BYTES,
                                 collective: str = "all_reduce") -> float:
    """Predicted time of one collective over a ring drawn from ``infos``.

    The ring takes the set's free devices in snake order (the order an
    aligned planner would lay ranks out) and prices it with the same
    placement-dilation alpha-beta model the roofline uses
    (:func:`repro_torch.topology.netsim.ring_collective_time`). When the chips
    live on the plane's TPU fabric the dilation is measured exactly via
    :func:`repro_torch.topology.tpu.ring_dilation`; otherwise it degrades to a
    coordinate estimate (and to the aligned ideal when no coordinates
    exist — every set then scores equally, which is the honest null).
    """
    devs: List[Device] = []
    for info in sorted(infos, key=lambda i: i.name):
        devs.extend(info.free.get(request, ()))
    devs.sort(key=_snake_key)
    ring = devs[:max(n_chips, 1)]
    n = len(ring)
    if n <= 1:
        return 0.0
    mean, mx = _ring_dilation(plane, ring)
    return ring_collective_time(collective, size_bytes, n, ICI_BW,
                                dilation_mean=mean, dilation_max=mx)


def _ring_dilation(plane: "ControlPlane",
                   ring: Sequence[Device]) -> Tuple[float, int]:
    cluster = getattr(plane, "cluster", None)
    if cluster is not None and hasattr(cluster, "torus_distance"):
        try:
            from ..topology.tpu import ring_dilation
            return ring_dilation(cluster, [d.name for d in ring])
        except (KeyError, ValueError):
            pass            # chips not on this fabric / cross-pod ring
    # coordinate estimate (unwrapped, pod-aware): mean/max consecutive
    # distance; a cross-pod hop is a DCN crossing, priced via _Topo's
    # pod_hop so scattered-across-pods rings never out-score aligned ones
    topo = _Topo(plane)
    coords = []
    for d in ring:
        x, y = d.attributes.get("x"), d.attributes.get("y")
        if not isinstance(x, (int, float)) or not isinstance(y, (int, float)):
            return 1.0, 1
        p = d.attributes.get("pod")
        pod = float(p) if isinstance(p, (int, float)) else 0.0
        coords.append((pod, float(x), float(y)))
    dists = [topo.pod_hop if a[0] != b[0]
             else abs(a[1] - b[1]) + abs(a[2] - b[2])
             for a, b in zip(coords, coords[1:] + coords[:1])]
    return sum(dists) / len(dists), int(max(dists))


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------

class SchedulerController(Controller):
    """Places schedulable claims onto Ready nodes before allocation.

    Runs ahead of the AllocationController in the ResourceClaim
    controller chain, so an evicted claim is re-placed in the same
    reconcile pass that heals it. Inert without Node objects.
    """

    kind = "ResourceClaim"
    name = "scheduler-controller"

    def __init__(self, plugins: Optional[List[SchedulerPlugin]] = None):
        self.plugins = plugins if plugins is not None else [
            CapacityFitPlugin(), FabricDistancePlugin(),
            TorusNeighborhoodPlugin()]
        self._set_picker = next(
            (p for p in self.plugins if isinstance(p, TorusNeighborhoodPlugin)),
            TorusNeighborhoodPlugin())
        # telemetry the benchmark reads
        self.placements = 0

    # -- node snapshots ------------------------------------------------------
    def _node_infos(self, plane: "ControlPlane",
                    claim: ResourceClaim) -> List[NodeInfo]:
        pool = plane.registry.pool
        topo = _Topo(plane)
        own_by_node: Dict[str, List[Device]] = {}
        if claim.allocation is not None:
            # devices this claim still holds count as schedulable
            # capacity: the allocation controller frees them before
            # re-allocating within the new placement
            for a in claim.allocation.devices:
                d = pool.get(a.ref.id)
                if d is not None and pool.owner(d.id) == claim.uid:
                    own_by_node.setdefault(d.node, []).append(d)
        infos = []
        for obj in plane.store.list_objects("Node"):
            node: Node = obj.spec
            if (node.unschedulable or node.drain
                    or not obj.is_true(CONDITION_READY, current=True)):
                continue
            free: Dict[str, List[Device]] = {}
            for req in claim.spec.requests:
                cls = plane.registry.classes.get(req.device_class)
                if cls is None:
                    continue
                # the allocator's OWN free-device index (same key, same
                # predicate — class selectors AND request selectors), so
                # capacity the scheduler counts is exactly capacity the
                # allocator can use, and the index is shared, not built
                # twice
                idx = pool.index(
                    (req.fingerprint(), tuple(cls.selectors)),
                    lambda d, c=cls, r=req: c.matches(d)
                    and r.selector_match(d))
                devs = list(idx.free_devices(node.name))
                devs += [d for d in own_by_node.get(node.name, ())
                         if cls.matches(d) and req.selector_match(d)]
                devs.sort(key=lambda d: d.id)
                free[req.name] = devs
            infos.append(NodeInfo(name=node.name, obj=obj, free=free,
                                  coord=topo.node_coord(node.name),
                                  pod=node.pod))
        infos.sort(key=lambda i: i.name)
        return infos

    # -- placement -----------------------------------------------------------
    def _place(self, ctx: SchedulerContext,
               infos: List[NodeInfo]) -> Optional[List[str]]:
        feasible = [i for i in infos
                    if all(p.filter(ctx, i) for p in self.plugins)]
        if not feasible:
            return None
        if ctx.claim.spec.topology_scope == "node":
            scored = sorted(
                feasible,
                key=lambda i: (-sum(p.score(ctx, i) for p in self.plugins),
                               i.name))
            return [scored[0].name]
        chosen = self._set_picker.grow(ctx, feasible)
        if chosen is None:
            return None
        return sorted(i.name for i in chosen)

    def _placement_valid(self, plane: "ControlPlane", placed: List[str],
                         infos: List[NodeInfo],
                         needs: Dict[str, int]) -> bool:
        """Is the recorded placement still feasible? (placement stability:
        a valid assignment is never churned by a better-scoring one)"""
        by_name = {i.name: i for i in infos}
        chosen = [by_name[n] for n in placed if n in by_name]
        if len(chosen) != len(placed):
            return False
        for req_name, need in needs.items():
            if sum(i.free_count(req_name) for i in chosen) < need:
                return False
        return True

    def reconcile(self, plane: "ControlPlane", obj: ApiObject) -> bool:
        if plane.store.count("Node") == 0:
            return False                       # no node plane: inert
        claim: ResourceClaim = obj.spec
        if plane.scheduling_needs(claim) is None:
            return False                       # 'All'-mode claims: unplaced
        needs = {r.name: r.count for r in claim.spec.requests}
        devices_lost = claim.allocated and any(
            plane.registry.pool.get(a.ref.id) is None
            for a in claim.allocation.devices)
        if (claim.allocated and not devices_lost
                and obj.is_true(CONDITION_ALLOCATED, current=True)):
            # healthy allocation: (re)affirm the recorded placement for
            # this generation, never churn it
            if obj.is_true(CONDITION_SCHEDULED, current=True):
                return False
            return self._set(plane, obj, CONDITION_SCHEDULED, True,
                             "Placed", "allocation healthy")
        infos = self._node_infos(plane, claim)
        placed = obj.status.outputs.get("scheduled_nodes")
        if (placed and not devices_lost
                and obj.is_true(CONDITION_SCHEDULED, current=True)
                and self._placement_valid(plane, placed, infos, needs)):
            return False
        ctx = SchedulerContext(
            plane=plane, obj=obj, claim=claim, needs=needs,
            workload=obj.meta.labels.get("workload", ""),
            peers=self._peer_nodes(plane, obj))
        placement = self._place(ctx, infos)
        if placement is None:
            return self._set(
                plane, obj, CONDITION_SCHEDULED, False, "NoFeasibleNode",
                f"no Ready node set fits {sorted(needs.items())} "
                f"({len(infos)} schedulable node(s))")
        changed = False
        if obj.status.outputs.get("scheduled_nodes") != placement:
            plane.store.set_output("ResourceClaim", obj.meta.name,
                                   "scheduled_nodes", placement)
            self.placements += 1
            changed = True
        changed |= self._set(plane, obj, CONDITION_SCHEDULED, True,
                             "Scheduled",
                             f"{len(placement)} node(s): "
                             f"{placement[:4]}{'…' if len(placement) > 4 else ''}")
        return changed

    @staticmethod
    def _peer_nodes(plane: "ControlPlane", obj: ApiObject) -> Set[str]:
        """Nodes hosting sibling claims of the same workload."""
        workload = obj.meta.labels.get("workload", "")
        if not workload:
            return set()
        peers: Set[str] = set()
        for sib in plane.store.list_objects("ResourceClaim",
                                            selector={"workload": workload}):
            if sib.meta.name == obj.meta.name or not sib.spec.allocated:
                continue
            for a in sib.spec.allocation.devices:
                if a.ref.node:
                    peers.add(a.ref.node)
        return peers
