"""KND drivers: independent, composable resource drivers (paper §III/§IV).

The port's own copy of the base class of the JAX package's
``core/drivers.py``. Each driver owns one resource family end-to-end:

* **discovery** — publish ResourceSlices from the fabric;
* **NodePrepareResources** — slow setup *before* the job-critical path,
  receiving the claim's opaque config (the "push" model, Fig. 4);
* **NRI hooks** — RunPodSandbox / CreateContainer-style attachment;
* **unprepare** — teardown.

Drivers never talk to each other (composability): they subscribe to the
same bus events and act in parallel. The port has no ResourceClaim or
ResourceSlice types yet, so the DRA hooks take any object with the
claim's attributes (``uid``, ``allocation``, ``config_for``,
``prepared``) and slices with a ``node``. The concrete TPU, ICI and NIC
drivers and the ``DriverRegistry`` come with the control plane.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from .nri import Event, EventBus, Events

__all__ = ["KNDDriver"]


class KNDDriver:
    """Base class for Kubernetes-Network-Driver-style resource drivers."""

    name: str = "knd"

    def __init__(self) -> None:
        self.prepared: Dict[str, Dict[str, Any]] = {}  # claim uid -> cached cfg
        # Bumped whenever the driver's local inventory changes (hotplug,
        # reconfiguration), so a registry can skip re-publishing drivers
        # whose inventory is unchanged.
        self.inventory_generation = 1

    def bump_inventory(self) -> int:
        """Mark the local inventory dirty; next discovery re-publishes."""
        self.inventory_generation += 1
        return self.inventory_generation

    # -- DRA ------------------------------------------------------------------
    def discover(self) -> List[Any]:
        """Walk the local inventory and publish slices."""
        return []

    def discover_node(self, node: str) -> List[Any]:
        """This driver's slices for ONE node — the node-agent's share."""
        return [sl for sl in self.discover() if sl.node == node]

    def node_prepare_resources(self, claim: Any) -> Dict[str, Any]:
        """Slow setup ahead of the critical path; caches the pushed config.

        Returns the prepared context later consumed by the NRI hooks —
        crucially WITHOUT any control-plane callback (Fig. 4).
        """
        cfg = {"config": claim.config_for(self.name),
               "devices": [a.ref.id for a in (claim.allocation.devices if claim.allocation else [])]}
        self.prepared[claim.uid] = cfg
        claim.prepared = True
        return cfg

    def node_unprepare_resources(self, claim: Any) -> None:
        self.prepared.pop(claim.uid, None)
        claim.prepared = False

    # -- NRI hooks --------------------------------------------------------------
    def run_pod_sandbox(self, event: Event) -> Any:  # pod-level attachment
        return None

    def create_container(self, event: Event) -> Any:  # container-level devices
        return None

    # -- wiring ----------------------------------------------------------------
    def register(self, bus: EventBus) -> None:
        bus.subscribe(Events.RUN_POD_SANDBOX, self.run_pod_sandbox, self.name)
        bus.subscribe(Events.CREATE_CONTAINER, self.create_container, self.name)

    def device_class(self) -> Optional[Any]:
        return None
