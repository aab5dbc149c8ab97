"""KND drivers: independent, composable resource drivers (paper §III/§IV).

The port's own copy of the JAX package's ``core/drivers.py``. Each
driver owns one resource family end-to-end, as DraNet owns network
interfaces and the NVIDIA DRA driver owns GPUs:

* **discovery** — publish ResourceSlices from the fabric (DraNet step 1);
* **NodePrepareResources** — slow setup *before* the job-critical path,
  receiving the claim's opaque config (the "push" model, Fig. 4);
* **NRI hooks** — RunPodSandbox / CreateContainer-style attachment,
  emitting declarative :class:`AttachmentSpec`s executed by the runtime;
* **unprepare** — teardown.

Drivers never talk to each other (composability): the TPU driver and the
interconnect driver below both subscribe to the same bus events and act
in parallel, mirroring the paper's "GPU driver + DraNet" deployment.

With a node plane attached (``DriverRegistry.node_plane``, the port's
``node.agent.NodePlane``), central discovery publishes only nodes whose
agent is alive and NodePrepareResources routes through the owning
node's agent, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..topology.fabric import Fabric
from ..topology.tpu import TpuCluster
from .attributes import AttributeSet
from .claims import DeviceClass, NetworkDeviceData, ResourceClaim
from .nri import Event, EventBus, Events
from .resources import Device, ResourcePool, ResourceSlice

__all__ = ["KNDDriver", "TpuDriver", "IciDriver", "NicDriver", "GpuDriver",
           "DriverRegistry"]


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
    def discover(self) -> List[ResourceSlice]:
        """Walk the local inventory and publish slices."""
        return []

    def discover_node(self, node: str) -> List[ResourceSlice]:
        """This driver's slices for ONE node — the node-agent's share."""
        return [sl for sl in self.discover() if sl.node == node]

    def node_prepare_resources(self, claim: ResourceClaim) -> Dict[str, Any]:
        """Slow setup ahead of the critical path; caches the pushed config.

        Returns the prepared context later consumed by the NRI hooks —
        crucially WITHOUT any control-plane callback (Fig. 4).
        """
        cfg = {"config": claim.config_for(self.name),
               "devices": [a.ref.id for a in (claim.allocation.devices if claim.allocation else [])]}
        self.prepared[claim.uid] = cfg
        claim.prepared = True
        return cfg

    def node_unprepare_resources(self, claim: ResourceClaim) -> None:
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

    def device_class(self) -> Optional[DeviceClass]:
        return None


class TpuDriver(KNDDriver):
    """DRA driver for TPU chips (the accelerator driver of the pair)."""

    name = "tpu.google.com"

    def __init__(self, cluster: TpuCluster):
        super().__init__()
        self.cluster = cluster

    def discover(self) -> List[ResourceSlice]:
        slices: Dict[str, ResourceSlice] = {}
        for chip_id in self.cluster.all_chips():
            comp = self.cluster.fabric.component(chip_id)
            host = comp.attrs["host"]
            sl = slices.setdefault(
                host, ResourceSlice(driver=self.name, pool=f"pod{comp.attrs['pod']}",
                                    node=host))
            dev = Device(
                name=chip_id,
                attributes=AttributeSet.of({
                    f"{self.name}/generation": comp.attrs["generation"],
                    f"{self.name}/pod": comp.attrs["pod"],
                    f"{self.name}/x": comp.attrs["x"],
                    f"{self.name}/y": comp.attrs["y"],
                    f"{self.name}/host": host,
                }))
            dev.set_capacity("hbm", comp.attrs["hbmBytes"])
            dev.set_capacity("tflopsBf16", comp.attrs["peakTflopsBf16"])
            sl.add(dev)
        return list(slices.values())

    def device_class(self) -> DeviceClass:
        return DeviceClass(self.name, selectors=[f'device.driver == "{self.name}"'])

    def create_container(self, event: Event) -> Any:
        # container-level: present accelerator device nodes (the paper's
        # /dev/infiniband/uverbsN analogue is /dev/accel*)
        claim: Optional[ResourceClaim] = event.context.get("claim")
        if claim is None or claim.uid not in self.prepared:
            return None
        devs = self.prepared[claim.uid]["devices"]
        return {"device_nodes": [f"/dev/accel{i}" for i, _ in enumerate(devs)]}


class IciDriver(KNDDriver):
    """DraNet analogue for the TPU world: owns interconnect attachment.

    Publishes host DCN NICs as devices (they're what inter-pod traffic
    claims) and performs the pod-sandbox-level "move interface into
    namespace" — here: emitting the mesh AttachmentSpec for the runtime.
    """

    name = "dranet.repro.dev"

    def __init__(self, cluster: TpuCluster):
        super().__init__()
        self.cluster = cluster

    def discover(self) -> List[ResourceSlice]:
        # one slice per host (pool re-publication replaces by
        # (driver, pool, node), so per-NIC slices would clobber each
        # other on multi-NIC hosts)
        out: Dict[str, ResourceSlice] = {}
        fab = self.cluster.fabric
        for comp in fab.components("nic"):
            if not comp.attrs.get("dcn"):
                continue
            host = comp.attrs["host"]
            sl = out.setdefault(
                host, ResourceSlice(driver=self.name,
                                    pool=f"pod{comp.attrs['pod']}",
                                    node=host))
            dev = Device(
                name=comp.id,
                attributes=AttributeSet.of({
                    f"{self.name}/kind": "dcn",
                    f"{self.name}/pod": comp.attrs["pod"],
                    f"{self.name}/host": host,
                    f"{self.name}/rdma": True,
                }))
            dev.set_capacity("bandwidth", "25G")
            sl.add(dev)
        return list(out.values())

    def device_class(self) -> DeviceClass:
        return DeviceClass(self.name, selectors=[f'device.driver == "{self.name}"'])

    def run_pod_sandbox(self, event: Event) -> Any:
        # pod-level: the network attachment. The plan's AttachmentSpec is
        # handed to the runtime; we also report KEP-4817 status data.
        plan = event.context.get("plan")
        claim: Optional[ResourceClaim] = event.context.get("claim")
        if plan is None:
            return None
        spec = plan.attachment()
        if claim is not None and claim.allocation is not None:
            for i, ad in enumerate(claim.allocation.devices[:8]):
                claim.allocation.device_statuses[ad.ref.id] = NetworkDeviceData(
                    interface_name=f"ici{i}", ips=[f"10.42.0.{i + 1}"],
                    hardware_address=f"02:42:ac:00:00:{i:02x}")
        return spec


class NicDriver(KNDDriver):
    """DraNet proper, for the GPU-testbed reproduction (a4 nodes)."""

    name = "dra.net"

    def __init__(self, fabric: Fabric):
        super().__init__()
        self.fabric = fabric

    def discover(self) -> List[ResourceSlice]:
        out: Dict[str, ResourceSlice] = {}
        for comp in self.fabric.components("nic"):
            node = comp.attrs.get("node")
            if node is None:
                continue
            sl = out.setdefault(node, ResourceSlice(driver=self.name, pool=node, node=node))
            dev = Device(
                name=comp.id,
                attributes=AttributeSet.of({
                    f"{self.name}/pciRoot": comp.attrs["pciRoot"],
                    f"{self.name}/socket": comp.attrs["socket"],
                    f"{self.name}/rdma": comp.attrs["rdma"],
                    f"{self.name}/index": comp.attrs["index"],
                    f"{self.name}/interface": comp.attrs["interface"],
                }))
            dev.set_capacity("bandwidth", "50G")
            sl.add(dev)
        return list(out.values())

    def device_class(self) -> DeviceClass:
        return DeviceClass("rdma-nic", selectors=[
            f'device.driver == "{self.name}"',
            'device.attributes["rdma"] == true'])


class GpuDriver(KNDDriver):
    """The NVIDIA DRA GPU driver analogue for the a4 testbed."""

    name = "gpu.nvidia.com"

    def __init__(self, fabric: Fabric):
        super().__init__()
        self.fabric = fabric

    def discover(self) -> List[ResourceSlice]:
        out: Dict[str, ResourceSlice] = {}
        for comp in self.fabric.components("gpu"):
            node = comp.attrs.get("node")
            sl = out.setdefault(node, ResourceSlice(driver=self.name, pool=node, node=node))
            dev = Device(
                name=comp.id,
                attributes=AttributeSet.of({
                    f"{self.name}/pciRoot": comp.attrs["pciRoot"],
                    f"{self.name}/socket": comp.attrs["socket"],
                    f"{self.name}/model": comp.attrs["model"],
                    f"{self.name}/index": comp.attrs["index"],
                }))
            dev.set_capacity("memory", "180Gi")
            sl.add(dev)
        return list(out.values())

    def device_class(self) -> DeviceClass:
        return DeviceClass(self.name, selectors=[f'device.driver == "{self.name}"'])


@dataclass
class DriverRegistry:
    """Wires a set of independent drivers to one pool + bus (Fig. 6)."""

    pool: ResourcePool = field(default_factory=ResourcePool)
    bus: EventBus = field(default_factory=EventBus)
    drivers: Dict[str, KNDDriver] = field(default_factory=dict)
    classes: Dict[str, DeviceClass] = field(default_factory=dict)
    # driver name -> inventory generation last published into the pool
    published_generations: Dict[str, int] = field(default_factory=dict)
    # pool inventory generation right after our last publication; a
    # mismatch means someone else mutated the pool (e.g. withdraw_node)
    # and the skip optimization must not suppress re-publication
    _pool_gen_at_publish: Optional[int] = None
    # the attached node.agent.NodePlane, when the cluster runs per-node
    # agents: central discovery then publishes only nodes whose agent is
    # alive (a withdrawn node must not resurrect behind the lifecycle
    # controller's back) and NodePrepareResources routes through the
    # owning agents instead of straight into the drivers
    node_plane: Any = None

    def add(self, driver: KNDDriver) -> "DriverRegistry":
        self.drivers[driver.name] = driver
        driver.register(self.bus)
        cls = driver.device_class()
        if cls is not None:
            self.classes[cls.name] = cls
        return self

    def add_class(self, cls: DeviceClass) -> "DriverRegistry":
        self.classes[cls.name] = cls
        return self

    def run_discovery(self, force: bool = False) -> int:
        """Publish slices from drivers whose inventory generation moved.

        Incremental by default: a driver that has not called
        :meth:`KNDDriver.bump_inventory` since its last publication is
        skipped entirely (no discover() walk, no pool re-publication, no
        pool generation bump). Everything re-publishes when the pool was
        mutated behind the registry's back (``withdraw_node``) or when
        ``force=True``.
        """
        if self.pool.inventory_generation != self._pool_gen_at_publish:
            force = True
        n = 0
        published = False
        for driver in self.drivers.values():
            gen = driver.inventory_generation
            if not force and self.published_generations.get(driver.name) == gen:
                continue
            for sl in driver.discover():
                if (self.node_plane is not None
                        and not self.node_plane.admits(sl.node)):
                    continue        # dead/failed node: its agent owns it
                self.pool.publish(sl)
                n += len(sl)
                published = True
            self.published_generations[driver.name] = gen
        self._pool_gen_at_publish = self.pool.inventory_generation
        if published or force:
            self.bus.publish(Events.DISCOVERY, pool=self.pool)
        return n

    def publish_node(self, node: str) -> int:
        """Publish ONE node's slices across all drivers (the node-agent
        discovery path). Does not touch other nodes' slices."""
        n = 0
        for driver in self.drivers.values():
            for sl in driver.discover_node(node):
                self.pool.publish(sl)
                n += len(sl)
        self._pool_gen_at_publish = self.pool.inventory_generation
        if n:
            self.bus.publish(Events.DISCOVERY, pool=self.pool, node=node)
        return n

    def prepare(self, claim: ResourceClaim) -> Dict[str, Dict[str, Any]]:
        """NodePrepareResources across all drivers owning claim devices.

        With a node plane attached, the call routes through the owning
        node's agent (kubelet -> per-node DRA driver, Fig. 4): a claim
        whose devices sit on a node with a dead agent fails to prepare —
        surfaced as a retryable ``Prepared=False`` condition, not a
        silent central success the real system could never deliver.
        """
        if claim.allocation is None:
            raise ValueError(f"claim {claim.name} not allocated")
        out: Dict[str, Dict[str, Any]] = {}
        if self.node_plane is not None:
            by_node: Dict[str, set] = {}
            for a in claim.allocation.devices:
                by_node.setdefault(a.ref.node, set()).add(a.ref.driver)
            # every involved node must be serving — a single dead agent
            # fails the whole prepare (retryable; eviction heals it)
            dead = [n for n in sorted(by_node)
                    if (ag := self.node_plane.agent(n)) is None
                    or not ag.alive]
            if dead:
                from ..node.agent import NodeUnavailableError
                raise NodeUnavailableError(
                    f"claim {claim.name}: node(s) {dead} have no live "
                    f"agent to serve NodePrepareResources")
            # each driver's (claim-scoped) slow setup runs ONCE, served
            # by the first live node owning it — not once per node,
            # which would duplicate the setup k× and overwrite results
            served: set = set()
            for node in sorted(by_node):
                todo = sorted(d for d in by_node[node]
                              if d in self.drivers and d not in served)
                if todo:
                    out.update(self.node_plane.agent(
                        node).node_prepare_resources(claim, todo))
                    served.update(todo)
        else:
            involved = {a.ref.driver for a in claim.allocation.devices}
            for name in sorted(involved):
                if name in self.drivers:
                    out[name] = self.drivers[name].node_prepare_resources(claim)
        self.bus.publish(Events.NODE_PREPARE_RESOURCES, claim=claim, prepared=out)
        return out
