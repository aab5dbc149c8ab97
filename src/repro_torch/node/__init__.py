"""Node plane: per-node agents, leases, and topology-aware scheduling.

The paper's KND architecture puts the drivers *on nodes*: DraNet agents
publish ResourceSlices per host, kubelet prepares resources node-locally
and NRI hooks attach them. This package is that node plane for the
reproduction — it turns the (so far centrally-driven) control plane
into a cluster of failure domains:

* :class:`~repro_torch.node.agent.NodeAgent` — one thread per host owning the
  host's discovery/prepare surface; registers a ``Node`` object, keeps a
  heartbeat-renewed ``Lease``, and serves NodePrepareResources for
  claims allocated to its devices.
* :class:`~repro_torch.node.agent.NodePlane` — the agent fleet around one
  :class:`~repro_torch.api.controllers.ControlPlane` (start/kill/fail/restart
  per node, discovery gating so dead nodes never resurrect slices).
* :class:`~repro_torch.node.lifecycle.NodeLifecycleController` — marks nodes
  NotReady on missed heartbeats, prunes their slices and lets the
  existing healing path evict + reallocate claims off dead nodes.
* :class:`~repro_torch.node.scheduler.SchedulerController` — kube-style
  filter/score plugins placing claims onto nodes *before* allocation
  (capacity fit, fabric distance, torus-neighborhood alignment scored
  by predicted collective time via :mod:`repro_torch.topology.netsim`).

See docs/NODES.md for lifecycle + scheduler-plugin semantics.

The port's own copy of the JAX package's ``node/__init__.py`` (pure
Python; the port imports nothing of that package).
"""

from .agent import NodeAgent, NodePlane, NodeUnavailableError
from .lifecycle import NodeLifecycleController
from .scheduler import (CapacityFitPlugin, FabricDistancePlugin,
                        NodeInfo, SchedulerContext, SchedulerController,
                        SchedulerPlugin, TorusNeighborhoodPlugin,
                        predicted_collective_seconds)

__all__ = [
    "NodeAgent", "NodePlane", "NodeUnavailableError",
    "NodeLifecycleController",
    "SchedulerController", "SchedulerPlugin", "SchedulerContext", "NodeInfo",
    "CapacityFitPlugin", "FabricDistancePlugin", "TorusNeighborhoodPlugin",
    "predicted_collective_seconds",
]
