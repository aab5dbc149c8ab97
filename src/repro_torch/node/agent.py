"""NodeAgent + NodePlane: the per-host daemons of the node plane.

A :class:`NodeAgent` is the DraNet-daemon/kubelet analogue for one host:
it owns the host's slice of every driver's discovery (publishing only
its node's ResourceSlices), registers a ``Node`` API object guarded by a
heartbeat-renewed ``Lease``, and serves NodePrepareResources for claims
allocated to its devices. Killing the agent (the SIGKILL analogue) stops
the heartbeats cold; the :class:`NodeLifecycleController` notices the
lapsed lease, withdraws the node's inventory and the claims on it are
evicted and rescheduled — the node-failure scenario end to end.

:class:`NodePlane` manages the fleet: one agent per node discovered from
the registry's drivers, a discovery gate so a dead node's slices are
never re-published centrally behind the lifecycle controller's back, and
kill/fail/restart handles for chaos tests and the elastic controller.

The port's own copy of the JAX package's ``node/agent.py`` (pure
Python; the port imports nothing of that package).
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Any, Dict, Iterable, List, Optional

from ..api.chaos import InjectedFault, sync_point
from ..api.objects import Lease, Node
from ..core.claims import ResourceClaim
from ..core.uid import new_uid
from ..obs import histogram

if TYPE_CHECKING:  # pragma: no cover - typing only
    from ..api.controllers import ControlPlane

__all__ = ["NodeAgent", "NodePlane", "NodeUnavailableError"]

# How long one heartbeat's store write takes (docs/OBSERVABILITY.md).
# Unlabeled on purpose: node names are unbounded; cells aggregate
# across the fleet at export.
_LEASE_RENEW = histogram("plane_torch_node_lease_renew_seconds",
                         "lease heartbeat store-write latency")


class NodeUnavailableError(RuntimeError):
    """NodePrepareResources routed to a dead or missing node agent."""


class NodeAgent:
    """One simulated node daemon: discovery, lease heartbeats, prepare.

    ``start()`` registers (Node + Lease objects, slice publication) and
    spawns the heartbeat thread; ``kill()`` is the SIGKILL analogue —
    the thread stops renewing *without* deregistering anything, so
    failure detection happens purely through lease expiry. Tests that
    want deterministic clocks construct with ``start_thread=False`` and
    drive :meth:`renew` by hand.
    """

    def __init__(self, plane: "ControlPlane", node: str, *,
                 heartbeat_s: float = 0.1, lease_duration_s: float = 0.5,
                 pod: int = 0, start_thread: bool = True):
        self.plane = plane
        self.node = node
        self.heartbeat_s = heartbeat_s
        self.lease_duration_s = lease_duration_s
        self.pod = pod
        self.start_thread = start_thread
        self.agent_id = f"agent-{node}-{new_uid()}"
        self.heartbeats = 0
        self.prepared_claims = 0
        self._killed = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._registered = False
        self._h_renew = _LEASE_RENEW.cell()

    # -- lifecycle ---------------------------------------------------------
    @property
    def alive(self) -> bool:
        """Registered and still heartbeating (a killed agent is dead the
        moment kill() lands, even before its thread unwinds)."""
        return self._registered and not self._killed.is_set()

    def start(self) -> "NodeAgent":
        self.register()
        if self.start_thread:
            self._thread = threading.Thread(
                target=self._run, name=f"node-agent-{self.node}", daemon=True)
            self._thread.start()
        return self

    def register(self) -> None:
        """Publish this node's slices + ensure Node/Lease objects exist.

        Idempotent and adoption-friendly: an agent restarting onto a
        recovered control plane updates the existing objects (fresh
        holder identity, fresh lease) instead of fighting them.
        """
        plane = self.plane
        with plane.mutate():
            sync_point("node.agent.publish", node=self.node)
            plane.registry.publish_node(self.node)
            store = plane.store
            now = plane.node_clock()
            if store.try_get("Node", self.node) is None:
                store.create(Node(name=self.node, provider=self.agent_id,
                                  pod=self.pod))
            else:
                store.update_spec(
                    "Node", self.node,
                    lambda n: setattr(n, "provider", self.agent_id))
            if store.try_get("Lease", self.node) is None:
                store.create(Lease(name=self.node, holder=self.agent_id,
                                   duration_s=self.lease_duration_s,
                                   acquired=now))
            else:
                def take(lease: Lease) -> None:
                    lease.holder = self.agent_id
                    lease.duration_s = self.lease_duration_s
                    lease.acquired = now
                store.update_spec("Lease", self.node, take)
            plane.sync_inventory()
        self._registered = True
        self.renew()

    def renew(self) -> None:
        """One heartbeat: stamp the lease's renew time (status write —
        a heartbeat never bumps the spec generation)."""
        if self._killed.is_set():
            return
        now = self.plane.node_clock()
        with self._h_renew.time():
            self.plane.store.update_status(
                "Lease", self.node,
                lambda st: st.outputs.__setitem__("renew_time", now))
        self.heartbeats += 1

    def _run(self) -> None:
        try:
            while not self._killed.wait(self.heartbeat_s):
                sync_point("node.agent.heartbeat", killable=True,
                           node=self.node)
                self.renew()
        except InjectedFault:
            # chaos kill: die exactly like a SIGKILL'd daemon — no
            # deregistration, no final renewal
            self._killed.set()
        except (AssertionError, KeyboardInterrupt):
            # test assertions and ^C must surface, not be absorbed as
            # "the agent died" (which the lease machinery would mask)
            self._killed.set()
            raise
        except Exception:  # noqa: BLE001 - a dead agent IS the scenario
            self._killed.set()

    def kill(self) -> None:
        """SIGKILL analogue: heartbeats stop; nothing is cleaned up."""
        self._killed.set()
        if self._thread is not None and self._thread is not threading.current_thread():
            self._thread.join(timeout=2.0)

    stop = kill   # a graceful stop still just lets the lease lapse

    # -- node-local DRA ----------------------------------------------------
    def node_prepare_resources(self, claim: ResourceClaim,
                               drivers: Iterable[str]) -> Dict[str, Any]:
        """Serve NodePrepareResources for this node's share of ``claim``."""
        if not self.alive:
            raise NodeUnavailableError(
                f"node {self.node} agent is not serving (killed or "
                f"unregistered)")
        out = {}
        registry = self.plane.registry
        for name in drivers:
            drv = registry.drivers.get(name)
            if drv is not None:
                out[name] = drv.node_prepare_resources(claim)
        self.prepared_claims += 1
        return out

    def __repr__(self) -> str:
        state = "alive" if self.alive else "dead"
        return (f"NodeAgent({self.node}, {state}, "
                f"hb={self.heartbeats}, prepared={self.prepared_claims})")


class NodePlane:
    """The agent fleet around one control plane.

    Wires itself into the :class:`~repro_torch.core.drivers.DriverRegistry` as
    ``registry.node_plane`` so that (a) central ``run_discovery`` calls
    re-publish only nodes with a live agent (a withdrawn node stays
    withdrawn), and (b) ``registry.prepare`` routes NodePrepareResources
    through the owning agents — a dead agent fails the prepare, exactly
    like a dead kubelet would.
    """

    def __init__(self, plane: "ControlPlane",
                 nodes: Optional[List[str]] = None, *,
                 heartbeat_s: float = 0.1, lease_duration_s: float = 0.5):
        self.plane = plane
        self.heartbeat_s = heartbeat_s
        self.lease_duration_s = lease_duration_s
        self.agents: Dict[str, NodeAgent] = {}
        self._nodes = nodes
        self._started = False

    # -- fleet lifecycle ---------------------------------------------------
    def discover_nodes(self) -> List[str]:
        """Every node any registry driver would publish slices for."""
        if self._nodes is not None:
            return list(self._nodes)
        nodes = set()
        for drv in self.plane.registry.drivers.values():
            for sl in drv.discover():
                nodes.add(sl.node)
        return sorted(nodes)

    def start(self, start_threads: bool = True) -> "NodePlane":
        if self._started:
            raise RuntimeError("node plane already started")
        self._started = True
        self.plane.registry.node_plane = self
        for node in self.discover_nodes():
            agent = NodeAgent(self.plane, node,
                              heartbeat_s=self.heartbeat_s,
                              lease_duration_s=self.lease_duration_s,
                              pod=self._pod_of(node),
                              start_thread=start_threads)
            self.agents[node] = agent
            agent.start()
        return self

    def stop(self) -> None:
        for agent in self.agents.values():
            agent.kill()

    def __enter__(self) -> "NodePlane":
        return self.start() if not self._started else self

    def __exit__(self, *exc: Any) -> None:
        self.stop()

    @staticmethod
    def _pod_of(node: str) -> int:
        if node.startswith("pod"):
            head = node.split("/", 1)[0][3:]
            if head.isdigit():
                return int(head)
        return 0

    # -- per-node handles ---------------------------------------------------
    def agent(self, node: str) -> Optional[NodeAgent]:
        return self.agents.get(node)

    def admits(self, node: str) -> bool:
        """Discovery gate: only nodes with a live agent publish slices."""
        agent = self.agents.get(node)
        return agent is not None and agent.alive

    def kill(self, node: str) -> NodeAgent:
        """Silent death: detected only when the lease lapses."""
        agent = self.agents[node]
        agent.kill()
        return agent

    def fail_node(self, node: str) -> NodeAgent:
        """Kill + immediately expire the lease (the node-problem-detector
        fast path): eviction starts on the next reconcile pass instead of
        after the lease window."""
        agent = self.kill(node)
        plane = self.plane
        lobj = plane.store.try_get("Lease", node)
        if lobj is not None:
            expired = plane.node_clock() - 2 * lobj.spec.duration_s
            plane.store.update_status(
                "Lease", node,
                lambda st: st.outputs.__setitem__("renew_time", expired))
        return agent

    def restart(self, node: str) -> NodeAgent:
        """Replace a dead agent: the recovered-node scenario."""
        old = self.agents.get(node)
        if old is not None and old.alive:
            raise RuntimeError(f"agent for {node} is still alive")
        agent = NodeAgent(self.plane, node,
                          heartbeat_s=self.heartbeat_s,
                          lease_duration_s=self.lease_duration_s,
                          pod=self._pod_of(node),
                          start_thread=(old.start_thread if old is not None
                                        else True))
        self.agents[node] = agent
        agent.start()
        return agent

    def alive_nodes(self) -> List[str]:
        return sorted(n for n, a in self.agents.items() if a.alive)

    def __repr__(self) -> str:
        alive = len(self.alive_nodes())
        return f"NodePlane({alive}/{len(self.agents)} agents alive)"
