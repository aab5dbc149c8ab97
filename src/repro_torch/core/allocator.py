"""Device allocators: structured DRA (aligned) vs legacy device-plugin.

Two allocators implement the paper's two experimental arms (§V.A):

* :class:`StructuredAllocator` — the KND/DRA path. Evaluates CEL
  selectors, honours cross-request ``MatchAttribute`` constraints (e.g.
  "NIC on the same PCI root as the GPU"), and scores candidate
  assignments with a topology-aware objective. This is what enables the
  *Topologically Aligned* configuration.

* :class:`LegacyAllocator` — the device-plugin path: *purely
  quantitative*. It knows only a resource name and a count and picks
  uniformly at random among devices of that kind, blind to attributes —
  the paper's *Topologically Unaligned (High Variance)* arm, a 1-in-8
  lottery on an 8-GPU node.

The port's own copy of the JAX package's ``core/allocator.py`` (that module
imports no JAX, but the port imports nothing of that package).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

from .claims import (AllocatedDevice, AllocationResult, DeviceClass,
                     DeviceRequest, MatchAttribute, ResourceClaim)
from .resources import Device, DeviceRef, ResourcePool

__all__ = ["AllocationError", "StructuredAllocator", "LegacyAllocator"]


class AllocationError(Exception):
    """No assignment satisfies the claim against the current inventory."""


ScoreFn = Callable[[Sequence[Tuple[str, Device]]], float]


@dataclass
class StructuredAllocator:
    """DRA structured-parameters allocator with backtracking search.

    The search assigns devices request-by-request, checking
    ``MatchAttribute`` constraints incrementally so violations prune
    early. For node-scoped claims every node is tried (best-scoring
    feasible node wins); cluster-scoped claims draw from the global pool.
    """

    pool: ResourcePool
    classes: Mapping[str, DeviceClass]
    score_fn: Optional[ScoreFn] = None
    max_backtrack_steps: int = 200_000
    # Reference arm: bypass the pool's free-device indexes and the
    # incremental constraint state, re-scanning the whole inventory and
    # re-checking every constraint over the full tentative assignment at
    # each DFS step (the pre-index behavior). The equivalence tests pin
    # the fast path to this oracle; it is never the production path.
    naive: bool = False

    # -- public api --------------------------------------------------------
    def allocate(self, claim: ResourceClaim, node: Optional[str] = None,
                 nodes: Optional[Sequence[str]] = None) -> AllocationResult:
        """Solve ``claim`` against the pool (optionally constrained).

        ``node`` pins a node-scoped claim to one node; ``nodes``
        restricts a cluster-scoped claim's candidates to a scheduler-
        chosen node set (and a node-scoped claim's search to that set).
        """
        if claim.allocated:
            raise AllocationError(f"claim {claim.name} already allocated")
        scope = claim.spec.topology_scope
        if scope not in ("node", "cluster"):
            raise AllocationError(f"unknown topology_scope {scope!r}")

        if scope == "node":
            if node:
                candidates = [node]
            elif nodes is not None:
                candidates = sorted(nodes)
            else:
                candidates = self.pool.nodes()
            best: Optional[Tuple[float, str, List[Tuple[str, Device]]]] = None
            for n in candidates:
                assignment = self._solve(claim, node=n)
                if assignment is None:
                    continue
                score = self.score_fn(assignment) if self.score_fn else 0.0
                if best is None or score > best[0]:
                    best = (score, n, assignment)
            if best is None:
                raise AllocationError(
                    f"claim {claim.name}: no node satisfies "
                    f"{[r.name for r in claim.spec.requests]}"
                    + (f" within scheduled nodes {sorted(nodes)}"
                       if nodes is not None else ""))
            _, chosen_node, assignment = best
        else:
            assignment = self._solve(claim, node=None, nodes=nodes)
            if assignment is None:
                raise AllocationError(
                    f"claim {claim.name}: cluster inventory cannot satisfy "
                    f"{[(r.name, r.count) for r in claim.spec.requests]}"
                    + (f" within scheduled nodes {sorted(nodes)}"
                       if nodes is not None else ""))
            chosen_node = ""

        devices = [d for _, d in assignment]
        self.pool.mark_allocated(devices, claim.uid)
        result = AllocationResult(
            devices=[AllocatedDevice(req, DeviceRef.of(dev)) for req, dev in assignment],
            node=chosen_node,
        )
        claim.allocation = result
        return result

    def deallocate(self, claim: ResourceClaim) -> None:
        self.pool.release(claim.uid)
        claim.allocation = None
        claim.prepared = False

    # -- search ------------------------------------------------------------
    def _candidates(self, req: DeviceRequest, node: Optional[str],
                    nodes: Optional[Sequence[str]] = None) -> List[Device]:
        cls = self.classes.get(req.device_class)
        if cls is None:
            raise AllocationError(f"unknown device class {req.device_class!r}")
        if self.naive:
            allowed = set(nodes) if nodes is not None else None
            out = []
            for d in self.pool.devices(include_allocated=False):
                if node is not None and d.node != node:
                    continue
                if allowed is not None and d.node not in allowed:
                    continue
                if cls.matches(d) and req.selector_match(d):
                    out.append(d)
            # deterministic order → deterministic allocations
            out.sort(key=lambda d: d.id)
            return out
        # Indexed fast path: the pool's free-device index evaluates the
        # CEL selectors once per device per inventory generation and keeps
        # the free survivors sorted by id, so a candidate list is a copy —
        # identical contents and order to the naive scan + sort above.
        key = (req.fingerprint(), tuple(cls.selectors))
        idx = self.pool.index(
            key, lambda d: cls.matches(d) and req.selector_match(d))
        if node is None and nodes is not None:
            # scheduler-constrained cluster claim: filtering the sorted
            # free list preserves the deterministic id order
            allowed = set(nodes)
            return [d for d in idx.free_devices(None) if d.node in allowed]
        return list(idx.free_devices(node))

    def _solve(self, claim: ResourceClaim, node: Optional[str],
               nodes: Optional[Sequence[str]] = None
               ) -> Optional[List[Tuple[str, Device]]]:
        requests = claim.spec.requests
        constraints = claim.spec.constraints
        cand: Dict[str, List[Device]] = {}
        for req in requests:
            c = self._candidates(req, node, nodes)
            want = len(c) if req.allocation_mode == "All" else req.count
            if len(c) < want or want == 0:
                return None
            cand[req.name] = c

        # order requests by tightness (fewest candidates first) to fail fast
        order: List[Tuple[DeviceRequest, int]] = []
        for req in requests:
            want = len(cand[req.name]) if req.allocation_mode == "All" else req.count
            order.append((req, want))
        order.sort(key=lambda rw: len(cand[rw[0].name]) - rw[1])

        assignment: List[Tuple[str, Device]] = []
        used: set = set()
        steps = [0]

        if self.naive:
            # reference arm: full re-check of every constraint over the
            # whole tentative assignment at every step
            def place(req_name: str, dev: Device) -> bool:
                tentative = assignment + [(req_name, dev)]
                return all(c.check(tentative) for c in constraints)

            def unplace(req_name: str, dev: Device) -> None:
                pass
        else:
            # Incremental constraint state: one (running value, count) per
            # constraint. Placing a device only touches the constraints
            # that apply to its request; everything already placed has
            # already been validated, so nothing else needs re-checking.
            cstate: List[List[Any]] = [[None, 0] for _ in constraints]
            applicable: Dict[str, List[Tuple[int, MatchAttribute]]] = {
                req.name: [(ci, c) for ci, c in enumerate(constraints)
                           if c.applies_to(req.name)]
                for req in requests}

            def _retract(req_name: str, upto: int) -> None:
                for ci, _ in applicable[req_name][:upto]:
                    st = cstate[ci]
                    st[1] -= 1
                    if st[1] == 0:
                        st[0] = None

            def place(req_name: str, dev: Device) -> bool:
                touched = 0
                for ci, c in applicable[req_name]:
                    v = c.value_of(dev)
                    st = cstate[ci]
                    if v is None or (st[1] and st[0] != v):
                        _retract(req_name, touched)
                        return False
                    st[0] = v
                    st[1] += 1
                    touched += 1
                return True

            def unplace(req_name: str, dev: Device) -> None:
                _retract(req_name, len(applicable[req_name]))

        def budget_error() -> AllocationError:
            counts = ", ".join(f"{r.name}={len(cand[r.name])}"
                               for r in requests)
            return AllocationError(
                f"claim {claim.name}: search budget exceeded "
                f"({self.max_backtrack_steps} steps); "
                f"candidates per request: {counts}; "
                f"constraints: {[c.attribute for c in constraints]}")

        def dfs(ri: int, picked_for_current: int) -> bool:
            steps[0] += 1
            if steps[0] > self.max_backtrack_steps:
                raise budget_error()
            if ri == len(order):
                return True
            req, want = order[ri]
            if picked_for_current == want:
                return dfs(ri + 1, 0)
            for dev in cand[req.name]:
                if dev.id in used:
                    continue
                if not place(req.name, dev):
                    continue
                used.add(dev.id)
                assignment.append((req.name, dev))
                if dfs(ri, picked_for_current + 1):
                    return True
                assignment.pop()
                used.remove(dev.id)
                unplace(req.name, dev)
            return False

        if not dfs(0, 0):
            return None
        # restore the user's request order in the reported assignment
        rank = {r.name: i for i, r in enumerate(requests)}
        assignment.sort(key=lambda t: rank[t[0]])
        return assignment


@dataclass
class LegacyAllocator:
    """Device-plugin semantics: count-only, attribute-blind, random pick.

    "the Device Plugin framework is purely quantitative, advertising a
    count of resources, and is incapable of expressing the rich
    qualitative attributes or topological relationships (like PCI
    locality) essential for performance." (§II)

    ``resource_name`` maps onto a device-class name purely so both
    allocators draw from the same inventory; the legacy allocator never
    looks at attributes or constraints.
    """

    pool: ResourcePool
    classes: Mapping[str, DeviceClass]
    rng: random.Random = field(default_factory=lambda: random.Random(0))

    def allocate_count(self, resource_name: str, count: int,
                       node: Optional[str] = None,
                       owner_uid: str = "legacy") -> List[Device]:
        cls = self.classes.get(resource_name)
        if cls is None:
            raise AllocationError(f"unknown extended resource {resource_name!r}")
        avail = [d for d in self.pool.devices(include_allocated=False)
                 if (node is None or d.node == node) and cls.matches(d)]
        if len(avail) < count:
            raise AllocationError(
                f"extended resource {resource_name}: want {count}, have {len(avail)}")
        avail.sort(key=lambda d: d.id)  # deterministic base order
        picked = self.rng.sample(avail, count)  # ... then the lottery
        self.pool.mark_allocated(picked, owner_uid)
        return picked
